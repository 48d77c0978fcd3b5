"""The staged workflow in the port against the JAX package: the object-.npy
writer, convert-samples, the minimizer's batch runners, the cross-mode contract
(``--mode sample`` -> ``convert-samples`` -> ``minimizer`` writes the same
FASTA as ``--mode pipeline`` at the same ``--seed``), and every new CLI
mode through ``python -m genome_minimizer_2_torch.cli``.

FASTA files are compared past their '# Generated on' line (a timestamp)."""

import os
import pickle
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genome_minimizer_2_torch import cli as tcli
from genome_minimizer_2_torch.genome import converter as tconv
from genome_minimizer_2_torch.genome import minimizer as tmin
from genome_minimizer_2_torch.genome.object_npy import ObjectListNpyWriter as TWriter
from genome_minimizer_2_tpu.data import synthetic
from genome_minimizer_2_tpu.genome import converter as jconv
from genome_minimizer_2_tpu.genome import minimizer as jmin
from genome_minimizer_2_tpu.genome.object_npy import ObjectListNpyWriter as JWriter

REPO = Path(__file__).resolve().parents[1]


def _body(path) -> bytes:
    """A FASTA's bytes after its '# Generated on' line."""
    data = Path(path).read_bytes()
    return data.partition(b"# Generated on")[2].split(b"\n", 1)[1]


def _object_array(lists):
    arr = np.empty(len(lists), dtype=object)
    for i, row in enumerate(lists):
        arr[i] = row
    return arr


# ---------------------------------------------------------------------------
# the object-.npy writer
# ---------------------------------------------------------------------------

NAMES = ["alpha", "beta", "gamma", "déjà_vu", "z" * 300, "名前", "a,b"]


@pytest.mark.parametrize("lists,chunks", [
    ([["alpha"], [], ["déjà_vu", "alpha", "z" * 300], [], ["beta"]], [(0, 5)]),
    ([[], [], []], [(0, 1), (1, 3)]),
    ([["名前", "a,b"], ["gamma", "名前"]], [(0, 2)]),  # equal lengths stay (N,)
    ([], [(0, 0)]),
    ([[NAMES[j % 7] for j in range(i % 5)] for i in range(23)],
     [(0, 7), (7, 7), (7, 20), (20, 23)]),
])
def test_object_npy_writer_byte_equal_to_jax(tmp_path, lists, chunks):
    idx = {s: i for i, s in enumerate(NAMES)}
    for label, writer in (("t", TWriter), ("j", JWriter)):
        with writer(str(tmp_path / f"{label}.npy"), len(lists), NAMES) as w:
            for lo, hi in chunks:
                w.append_lists(lists[lo:hi], idx)
    got = (tmp_path / "t.npy").read_bytes()
    assert got == (tmp_path / "j.npy").read_bytes()
    loaded = np.load(tmp_path / "t.npy", allow_pickle=True)
    assert loaded.shape == (len(lists),)
    assert [list(r) for r in loaded] == lists


def test_object_npy_writer_row_count_mismatch_raises(tmp_path):
    w = TWriter(str(tmp_path / "x.npy"), 3, NAMES)
    w.append_lists([["alpha"]], {s: i for i, s in enumerate(NAMES)})
    with pytest.raises(ValueError, match="declared 3 rows"):
        w.close()


# ---------------------------------------------------------------------------
# convert-samples
# ---------------------------------------------------------------------------

COLS = np.array([f"g{i:03d}" for i in range(150)], dtype=object)
COLS[40] = COLS[12]  # a duplicate name: dedupe keeps the first
ESSENTIALS = {"g001", "g077", "g149", "zzNotACol", "aaNotACol"}


@pytest.fixture(scope="module")
def masks():
    return (np.random.RandomState(3).rand(23, len(COLS)) > 0.45).astype(np.float32)


def _write_masks(kind: str, masks, path: Path) -> str:
    if kind in ("float32", "uint8"):
        np.save(path.with_suffix(".npy"), masks.astype(kind))
        return str(path.with_suffix(".npy"))
    packed = np.packbits(masks.astype(np.uint8), axis=1, bitorder="little")
    conv = jconv if kind == "packed_by_jax" else tconv
    conv.save_packed_npz(packed, masks.shape[1], str(path.with_suffix(".npz")))
    return str(path.with_suffix(".npz"))


@pytest.mark.parametrize("kind", ["float32", "uint8", "packed_by_jax",
                                  "packed_by_port"])
@pytest.mark.parametrize("chunk", [0, 5])
def test_convert_samples_streaming_byte_equal_to_jax(masks, tmp_path, kind, chunk):
    src = _write_masks(kind, masks, tmp_path / "masks")
    outs = {}
    for label, conv in (("t", tconv), ("j", jconv)):
        out, filled, n = conv.convert_samples_streaming(
            src, COLS, str(tmp_path / f"{label}_ids.npy"),
            essential_set=set(ESSENTIALS), chunk_size=chunk)
        assert n == len(masks)
        outs[label] = (Path(out).read_bytes(), Path(filled).read_bytes())
    assert outs["t"] == outs["j"]


@pytest.mark.parametrize("kind", ["float32", "uint8", "packed_by_jax",
                                  "packed_by_port"])
def test_masks_to_gene_lists_and_essentials_byte_equal_to_jax(masks, tmp_path, kind):
    src = _write_masks(kind, masks, tmp_path / "masks")
    outs = {}
    for label, conv in (("t", tconv), ("j", jconv)):
        ids = str(tmp_path / f"{label}_ids.npy")
        lists = conv.masks_to_gene_lists(src, COLS, ids, chunk_size=4)
        filled = conv.check_essential_genes(set(ESSENTIALS), lists, ids)
        outs[label] = (Path(ids).read_bytes(), Path(filled).read_bytes(), lists)
    assert outs["t"] == outs["j"]
    # the streaming writer's rows load equal to np.save's
    tconv.convert_samples_streaming(src, COLS, str(tmp_path / "s.npy"),
                                    essential_set=set(ESSENTIALS))
    staged = np.load(tmp_path / "t_ids_with_essentials.npy", allow_pickle=True)
    stream = np.load(tmp_path / "s_with_essentials.npy", allow_pickle=True)
    assert [list(r) for r in staged] == [list(r) for r in stream]


def test_packed_npz_members_equal_to_jax(masks, tmp_path):
    paths = [_write_masks(k, masks, tmp_path / k) for k in ("packed_by_jax",
                                                            "packed_by_port")]
    members = []
    for p in paths:
        with zipfile.ZipFile(p) as z:
            members.append({n: z.read(n) for n in z.namelist()})
    assert members[0] == members[1]
    assert tconv._open_packed_npz(paths[0])[1] == len(COLS)
    assert tconv._open_packed_npz(str(tmp_path / "x.npy")) is None


def test_load_masks_and_files_equal_to_jax(masks, tmp_path):
    rows = _object_array([list(r) for r in masks[:4]])
    np.save(tmp_path / "rows.npy", rows)
    np.save(tmp_path / "one.npy", masks[0])
    for name in ("rows.npy", "one.npy"):
        np.testing.assert_array_equal(tconv.load_masks(str(tmp_path / name)),
                                      jconv.load_masks(str(tmp_path / name)))
    np.save(tmp_path / "ids.npy", _object_array([["g001"], ["g002", "g003"]]))
    ess = tmp_path / "ess.csv"
    ess.write_text("# gene\ng001\n g002 \n")
    t_set, t_ids = tconv.load_files(str(ess), str(tmp_path / "ids.npy"))
    j_set, j_ids = jconv.load_files(str(ess), str(tmp_path / "ids.npy"))
    assert t_set == j_set == {"g001", "g002"}
    assert [list(r) for r in t_ids] == [list(r) for r in j_ids]


def test_streaming_convert_failure_leaves_no_partial_files(masks, tmp_path,
                                                          monkeypatch):
    src = _write_masks("float32", masks, tmp_path / "masks")

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(tconv, "_threshold_chunk", boom)
    with pytest.raises(RuntimeError, match="injected"):
        tconv.convert_samples_streaming(src, COLS, str(tmp_path / "o.npy"),
                                        essential_set=set(ESSENTIALS))
    assert not (tmp_path / "o.npy").exists()
    assert not (tmp_path / "o_with_essentials.npy").exists()


# ---------------------------------------------------------------------------
# the minimizer's batch runners
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_min")
    genes = [f"g{i:03d}" for i in range(80)]
    gb = d / "g.gb"
    synthetic.write_genbank(gb, genes, genome_length=6000, seed=5)
    rng = np.random.RandomState(7)
    lists = [sorted(set(rng.choice(genes, rng.randint(0, 60)).tolist())
                    | {"notInGenbank"}) for _ in range(23)]
    lists[3] = list(lists[2])  # a duplicate genome
    ids = d / "ids.npy"
    np.save(ids, _object_array(lists))
    return {"gb": str(gb), "ids": str(ids), "lists": lists, "dir": d}


def test_single_file_body_equal_to_jax(genome, tmp_path, capsys):
    outs = {}
    for label, mod in (("t", tmin), ("j", jmin)):
        out = tmp_path / f"{label}.fasta"
        res = mod.process_multiple_genomes_single_file(
            genome["gb"], genome["ids"], "m", output_file=str(out))
        outs[label] = (_body(out), res)
    assert outs["t"][0] == outs["j"][0]
    assert outs["t"][1] == outs["j"][1]
    head = (tmp_path / "t.fasta").read_bytes().split(b"\n")[:2]
    assert head == [b"# Minimized genomes generated using model: m",
                    b"# Total genomes: 23"]


def test_multiple_files_equal_to_jax(genome, tmp_path):
    res = {}
    for label, mod in (("t", tmin), ("j", jmin)):
        res[label] = mod.process_multiple_genomes_multiple_files(
            genome["gb"], genome["ids"], "m", output_dir=str(tmp_path / label),
            verbose=False)
    assert res["t"] == res["j"]
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names and len(names) == 23
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def test_process_sharded_merge_equal_to_jax(genome, tmp_path):
    single = tmp_path / "single.fasta"
    jmin.process_multiple_genomes_single_file(genome["gb"], genome["ids"], "m",
                                              output_file=str(single),
                                              verbose=False)
    merged = tmp_path / "merged.fasta"
    for pi in (2, 1, 0):  # rank 0's merge waits on the others' sentinels
        got = tmin.process_sharded(genome["gb"], genome["ids"], "m", str(merged),
                                   process_index=pi, process_count=3)
        assert got == (str(merged) if pi == 0 else None)
    assert _body(merged) == _body(single)
    assert not any(p.name.endswith(".done") for p in tmp_path.iterdir())
    # one process: the shard is the whole file
    alone = tmp_path / "alone.fasta"
    tmin.process_sharded(genome["gb"], genome["ids"], "m", str(alone))
    assert _body(alone) == _body(single)


def test_minimize_batch_and_drop_masks_equal_to_jax(genome):
    te = tmin.MinimizerEngine.from_genbank(genome["gb"])
    je = jmin.MinimizerEngine.from_genbank(genome["gb"])
    lists = genome["lists"][:6]
    np.testing.assert_array_equal(te.drop_masks(lists), je.drop_masks(lists))
    want = je.minimize_batch(lists, use_native=False)
    assert te.minimize_batch(lists) == want
    assert te.minimize_batch(lists, use_native=False) == want
    assert [te.num_removed_features(g) for g in lists] == \
        [je.num_removed_features(g) for g in lists]


def test_genome_minimiser_facade_equal_to_jax(genome, tmp_path):
    for idx in (0, 5):
        t = tmin.GenomeMinimiser(genome["gb"], genome["ids"], idx=idx)
        j = jmin.GenomeMinimiser(genome["gb"], genome["ids"], idx=idx)
        assert t.get_reduction_stats() == j.get_reduction_stats()
        assert t.get_positions_to_remove() == j.get_positions_to_remove()
        t.save_minimized_genome(str(tmp_path / "t.fa"))
        j.save_minimized_genome(str(tmp_path / "j.fa"))
        assert (tmp_path / "t.fa").read_bytes() == (tmp_path / "j.fa").read_bytes()


def test_duplicates_and_summary_equal_to_jax(genome, tmp_path, capsys):
    te = tmin.MinimizerEngine.from_genbank(genome["gb"])
    seqs = {f"s{i}": s for i, s in enumerate(te.minimize_batch(genome["lists"]))}
    t_stats = tmin.check_sequence_duplicates(seqs)
    assert t_stats == jmin.check_sequence_duplicates(seqs)
    assert t_stats["duplicate_groups"] >= 1
    tmin.print_duplicate_statistics(t_stats)
    t_out = capsys.readouterr().out
    jmin.print_duplicate_statistics(t_stats)
    assert t_out == capsys.readouterr().out
    sizes = [len(s) / 1e6 for s in seqs.values()]
    texts = []
    for label, mod in (("t", tmin), ("j", jmin)):
        path = mod.generate_summary_file(
            str(tmp_path / label / "out.fasta"), "m", genome["gb"], genome["ids"],
            te.original_length, sizes, t_stats)
        texts.append([ln for ln in Path(path).read_text().splitlines()
                      if not ln.startswith("Generated on")])
    assert texts[0] == texts[1]
    assert tmin.plot_minimized_distribution(sizes, "m", str(tmp_path)) is None
    pdf = tmin.plot_minimized_distribution(sizes * 5, "m", str(tmp_path))
    assert pdf.endswith("minimised_genomes_distribution_m.pdf") and os.path.exists(pdf)


# ---------------------------------------------------------------------------
# the cross-mode contract, through both CLIs
# ---------------------------------------------------------------------------

MARGIN = 1e-4


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A tiny GM2_ROOT of its own (the shared synthetic tree stays
    untouched), the essential-positions pickle, and a JAX checkpoint whose
    sampled logits at seed 12 keep MARGIN from 0
    (tests/test_torch_port_pipeline.py)."""
    from genome_minimizer_2_torch.explore.essential_genes import EssentialGeneProcessor
    from genome_minimizer_2_tpu.data.dataset import load_gene_vocab
    from genome_minimizer_2_tpu.models import vae as jvae
    from genome_minimizer_2_tpu.utils import checkpoint as jckpt
    from genome_minimizer_2_tpu.utils.config import ExperimentConfig

    root = tmp_path_factory.mktemp("port_staged_root")
    info = synthetic.make_dataset_root(root, n_samples=40, n_genes=120,
                                       genome_length=4000, seed=0)
    cols = load_gene_vocab(info["presence_absence"])
    EssentialGeneProcessor(info["presence_absence"], info["phylogroups"],
                           info["essential_genes"],
                           root / "data" / "essential_genes").process()
    cfg = jvae.VAEConfig(input_dim=len(cols), hidden_dim=8, latent_dim=2)
    params, stats = jvae.init(cfg, jax.random.key(4))
    ckpt = root / "cli.npz"
    jckpt.save_checkpoint(ckpt, params, stats,
                          ExperimentConfig(hidden_dim=8, latent_dim=2,
                                           trainer_version="v0"),
                          extra={"input_dim": len(cols)})
    return {**info, "ckpt": str(ckpt), "cfg": cfg, "params": params,
            "stats": stats}


def _check_margin(cli_root, mode, n, seed):
    from genome_minimizer_2_torch.core import prng as tprng
    from genome_minimizer_2_torch.sample import sampler as tsmp
    from genome_minimizer_2_tpu.core.prng import draw_latents as jdraw
    from genome_minimizer_2_tpu.models import vae as jvae
    from genome_minimizer_2_tpu.sample import sampler as jsmp

    key = jax.random.key(seed)
    if mode == "focused":
        js, _ = jsmp.load_sampler(cli_root["ckpt"])
        ts, _ = tsmp.load_sampler(cli_root["ckpt"], device="cpu")
        want = js.focused_anchor(jax.random.split(key)[0], 100)
        got = ts.focused_anchor(tprng.split(tprng.key(seed, "cpu"))[0], 100)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        z = want + np.asarray(jdraw(jax.random.split(key)[1], jnp.arange(n), 2)) * 0.1
    else:
        z = np.asarray(jdraw(key, jnp.arange(n), 2))
    logits, _ = jvae.decode_logits(cli_root["cfg"], cli_root["params"],
                                   cli_root["stats"], jnp.asarray(z), False)
    D = cli_root["cfg"].input_dim
    assert float(np.abs(np.asarray(logits)[:, :D]).min()) >= MARGIN


def _staged(run, out_dir: Path, common, sample_flags):
    """sample -> convert-samples -> minimizer through one package's CLI;
    returns (the sampling_results directory moved to out_dir, FASTA)."""
    results = Path(os.environ["GM2_ROOT"]) / "models" / "v0_model" / "sampling_results"
    assert run(["--mode", "sample", *common, *sample_flags]) == 0
    shutil.move(str(results), str(out_dir / "sampling_results"))
    samples = next((out_dir / "sampling_results").glob("v0_binary_samples_*"))
    ids = out_dir / "ids.npy"
    assert run(["--mode", "convert-samples", "--genes-path", str(samples),
                "--output-file", str(ids)]) == 0
    fasta = out_dir / "staged.fasta"
    assert run(["--mode", "minimizer", "--genes-path",
                str(out_dir / "ids_with_essentials.npy"), "--output-file",
                str(fasta), "--model-name", "v0"]) == 0
    return out_dir / "sampling_results", fasta


@pytest.mark.parametrize("mode,save_dtype", [("default", "float32"),
                                             ("focused", "packed")])
def test_staged_cli_equals_pipeline_and_jax(cli_root, tmp_path, monkeypatch,
                                            mode, save_dtype):
    import main as jcli

    n, seed = 6, 12
    _check_margin(cli_root, mode, n, seed)
    monkeypatch.setenv("GM2_ROOT", cli_root["root"])
    monkeypatch.chdir(tmp_path)
    common = ["--model-path", cli_root["ckpt"], "--seed", str(seed),
              "--sampling-mode", mode, "--num-samples", str(n)]
    tcpu = lambda argv: tcli.main(argv + ["--device", "cpu"])  # noqa: E731
    jrun = lambda argv: jcli.main(argv)  # noqa: E731
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    sample_flags = ["--save-dtype", save_dtype]
    t_res, t_fasta = _staged(tcpu, tmp_path / "t", common, sample_flags)
    j_res, j_fasta = _staged(jrun, tmp_path / "j", common, sample_flags)

    pipe = tmp_path / "pipe.fasta"
    assert tcpu(["--mode", "pipeline", *common, "--output-file", str(pipe),
                 "--model-name", "v0", "--chunk-size", "4"]) == 0
    assert _body(t_fasta) == _body(pipe) == _body(j_fasta)
    assert _body(pipe).count(b">") == n

    # sample mode's files: byte-equal (the .npz member by member), the
    # figures and the CSV present in both
    for j_file in sorted(j_res.iterdir()):
        t_file = t_res / j_file.name
        assert t_file.exists(), j_file.name
        if j_file.suffix in (".npy", ".csv"):
            assert t_file.read_bytes() == j_file.read_bytes(), j_file.name
        elif j_file.suffix == ".npz":
            with zipfile.ZipFile(t_file) as a, zipfile.ZipFile(j_file) as b:
                assert {m: a.read(m) for m in a.namelist()} == \
                    {m: b.read(m) for m in b.namelist()}
    for t_ids in ("ids.npy", "ids_with_essentials.npy"):
        assert (tmp_path / "t" / t_ids).read_bytes() == \
            (tmp_path / "j" / t_ids).read_bytes()


def test_sample_mode_returns_per_chunk_analytics(cli_root, tmp_path, monkeypatch):
    """The sizes and essential counts taken per drained chunk equal a
    recompute from the saved samples; --no-csv and --no-generate-plots
    leave out only the CSV and the figure files."""
    from genome_minimizer_2_torch.sample import sampler as tsmp

    monkeypatch.setenv("GM2_ROOT", cli_root["root"])
    monkeypatch.chdir(tmp_path)
    args = tcli.parse_arguments([
        "--mode", "sample", "--device", "cpu", "--model-path", cli_root["ckpt"],
        "--num-samples", "9", "--save-dtype", "packed", "--no-csv",
        "--no-generate-plots", "--seed", "3"])
    res = tcli.run_sampling(args)
    with np.load(res["samples_path"]) as z:
        packed, width = z["packed"], int(z["input_dim"])
    with open(cli_root["root"] + "/data/essential_genes/essential_gene_positions.pkl",
              "rb") as f:
        positions = pickle.load(f)
    np.testing.assert_array_equal(res["genome_sizes"], tsmp.popcount_rows(packed))
    np.testing.assert_array_equal(
        res["essential_counts"],
        tsmp.count_essential_genes_packed(packed, positions, width))
    made = sorted(p.name for p in Path(res["output_dir"]).iterdir())
    shutil.rmtree(res["output_dir"])
    assert made == ["v0_binary_samples_default.npz"]


def test_sample_and_pipeline_refuse_data_parallel(cli_root, monkeypatch):
    """A data axis other than 0 or the group's size W (1 here: no group) is
    refused; so is a model axis: it is for training only."""
    monkeypatch.setenv("GM2_ROOT", cli_root["root"])
    for mode in ("sample", "pipeline"):
        with pytest.raises(ValueError, match="pass 0 or 1"):
            tcli.main(["--mode", mode, "--device", "cpu", "--model-path",
                       cli_root["ckpt"], "--data-parallel", "2"])
        with pytest.raises(ValueError, match=f"is for training only .*; "
                                             f"{mode} mode takes --data-parallel"):
            tcli.main(["--mode", mode, "--device", "cpu", "--model-path",
                       cli_root["ckpt"], "--model-parallel", "2"])


# ---------------------------------------------------------------------------
# every new mode through `python -m genome_minimizer_2_torch.cli`
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mode_inputs(cli_root, tmp_path_factory):
    """A reference .pt of the checkpoint, a packed samples file and its gene
    lists, made in-process for the CLI runs below."""
    from genome_minimizer_2_torch.core import prng as tprng
    from genome_minimizer_2_torch.sample import sampler as tsmp
    from genome_minimizer_2_torch.data.dataset import load_gene_vocab
    from tests.test_torch_port_sample import _reference_state_dict

    d = tmp_path_factory.mktemp("port_modes")
    pt = d / "saved_VAE_v0.pt"
    torch.save(_reference_state_dict(cli_root["params"], cli_root["stats"],
                                     cli_root["cfg"].input_dim), pt)
    ts, _ = tsmp.load_sampler(cli_root["ckpt"], device="cpu")
    packed, _ = ts.sample_packed(tprng.key(1, "cpu"), 5)
    npz = d / "samples.npz"
    tconv.save_packed_npz(packed, ts.cfg.input_dim, str(npz))
    cols = load_gene_vocab(cli_root["presence_absence"])
    tconv.convert_samples_streaming(str(npz), cols, str(d / "ids.npy"),
                                    essential_set={"x"})
    return {"pt": str(pt), "npz": str(npz),
            "ids": str(d / "ids_with_essentials.npy"), "dir": d}


MODE_ARGS = {
    "preprocess": ["--force-reprocess"],
    "explore": [],
    "sample": ["--model-path", "{pt}", "--num-samples", "5", "--save-dtype",
               "packed", "--no-csv", "--no-generate-plots"],
    "convert-samples": ["--genes-path", "{npz}", "--output-file", "{out}/ids.npy"],
    "minimizer": ["--genes-path", "{ids}", "--single-file", "--output-dir",
                  "{out}"],
    "pipeline": ["--model-path", "{pt}", "--num-samples", "5", "--transfer",
                 "feature-bits", "--output-file", "{out}/fb.fasta",
                 "--chunk-size", "2"],
}


def _mode_argv(mode, mode_inputs, out):
    return ["--mode", mode] + [a.format(out=out, **mode_inputs)
                               for a in MODE_ARGS[mode]]


@pytest.mark.parametrize("mode", sorted(MODE_ARGS))
def test_cli_module_runs_mode_on_cpu(cli_root, mode_inputs, tmp_path, mode):
    env = dict(os.environ, GM2_ROOT=cli_root["root"],
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "genome_minimizer_2_torch.cli",
         *_mode_argv(mode, mode_inputs, tmp_path), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "PROCESS COMPLETED!" in proc.stdout
    made = {
        "preprocess": Path(cli_root["root"]) / "data" / "essential_genes"
        / "essential_gene_positions.pkl",
        "explore": Path(cli_root["root"]) / "data" / "data_exploration"
        / "data_exploration_report.txt",
        "sample": Path(cli_root["root"]) / "models" / "v0_model"
        / "sampling_results" / "v0_binary_samples_default.npz",
        "convert-samples": tmp_path / "ids_with_essentials.npy",
        "minimizer": tmp_path / "minimized_genomes_default.fasta",
        "pipeline": tmp_path / "fb.fasta",
    }[mode]
    assert made.exists()
    if mode == "sample":
        assert "Converted torch checkpoint" in proc.stdout
        shutil.rmtree(made.parent)
    if mode in ("minimizer", "pipeline"):
        assert made.read_text().count(">") == 5


@pytest.mark.parametrize("mode", sorted(MODE_ARGS))
def test_cli_mode_on_cuda_without_a_card_raises(cli_root, mode_inputs, tmp_path,
                                                monkeypatch, mode):
    monkeypatch.setenv("GM2_ROOT", cli_root["root"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(_mode_argv(mode, mode_inputs, tmp_path) + ["--device", "cuda"])


@pytest.mark.parametrize("mode", [m for m in tcli.MODES
                                  if m not in ("sample", "experiment")])
def test_no_generate_plots_is_sample_mode_only(mode, capsys):
    """Sample mode takes ``--no-generate-plots`` (experiment mode has its
    config field of that name); every other mode refuses it instead of
    ignoring it."""
    assert tcli.parse_arguments(["--mode", "sample", "--no-generate-plots"]
                                ).generate_plots is False
    with pytest.raises(SystemExit):
        tcli.parse_arguments(["--mode", mode, "--no-generate-plots"])
    assert "unrecognized arguments: --no-generate-plots" in capsys.readouterr().err
