"""The port's streaming pipeline against the JAX package's, byte for byte.

Both packages load one JAX-written checkpoint and run at float32 on the
CPU (``auto`` resolves to float32 there in both). The latents agree to a
few ulp (tests/test_torch_port_prng.py), so the FASTA bytes can only differ
where a logit lies within rounding of 0; every comparison first asserts
that no reference logit of its inputs lies within 1e-4 of 0, so equality is
meaningful. Also the port's copies of the pipeline's stream invariants
(tests/test_pipeline.py:315-444) and its CLI against ``main.py``."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from genome_minimizer_2_torch import pipeline as tpipe
from genome_minimizer_2_torch.core import prng as tprng
from genome_minimizer_2_torch.genome import minimizer as tmin
from genome_minimizer_2_torch.genome.converter import dedupe_columns
from genome_minimizer_2_torch.parallel.barrier import shard_file
from genome_minimizer_2_torch.sample import sampler as tsmp
from genome_minimizer_2_tpu import pipeline as jpipe
from genome_minimizer_2_tpu.core.prng import draw_latents as jdraw
from genome_minimizer_2_tpu.data import synthetic
from genome_minimizer_2_tpu.genome.minimizer import MinimizerEngine as JEngine
from genome_minimizer_2_tpu.models import vae as jvae
from genome_minimizer_2_tpu.sample import sampler as jsmp
from genome_minimizer_2_tpu.utils import checkpoint as jckpt
from genome_minimizer_2_tpu.utils.config import ExperimentConfig

D = 60
MARGIN = 1e-4
# seeds whose reference logits all keep the margin (see _check_inputs_margin)
SEED = {"default": 14, "focused": 27}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_pipe")
    genes = [f"g{i:03d}" for i in range(D)]
    gb = d / "g.gb"
    synthetic.write_genbank(gb, genes, genome_length=3000, seed=11)
    cfg = jvae.VAEConfig(input_dim=D, hidden_dim=10, latent_dim=3)
    params, stats = jvae.init(cfg, jax.random.key(2))
    ckpt = d / "m.npz"
    jckpt.save_checkpoint(ckpt, params, stats,
                          ExperimentConfig(hidden_dim=10, latent_dim=3),
                          extra={"input_dim": D})
    jsampler, _ = jsmp.load_sampler(str(ckpt))
    jsampler.chunk_size = 64
    tsampler, _ = tsmp.load_sampler(str(ckpt), device="cpu", chunk_size=64)
    return {
        "jsampler": jsampler, "tsampler": tsampler,
        "jengine": JEngine.from_genbank(gb),
        "tengine": tmin.MinimizerEngine.from_genbank(gb),
        "cols": np.array(genes, dtype=object),
        "ess": {"g000", "g007", "madeUpEss"},
    }


def _body(path) -> bytes:
    """FASTA bytes after the three '#' header lines (the third carries a
    timestamp)."""
    data = open(path, "rb").read()
    if data.startswith(b"#"):
        data = data.split(b"\n", 3)[3]
    return data


def _assert_margin(jsampler, z):
    logits, _ = jvae.decode_logits(jsampler.cfg, jsampler.params,
                                   jsampler.batch_stats, jnp.asarray(z), False)
    m = float(np.abs(np.asarray(logits)[:, :D]).min())
    assert m >= MARGIN, f"a reference logit lies {m} from 0"


def _assert_same_anchor(tsampler, jsampler, seed, n_probes):
    """The focused probe stage picks the same anchor in both packages (its
    argmin over probe gene counts is what the probes' logits decide)."""
    want = jsampler.focused_anchor(jax.random.split(jax.random.key(seed))[0],
                                   n_probes)
    got = tsampler.focused_anchor(tprng.split(tprng.key(seed, "cpu"))[0],
                                  n_probes)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    return want


def _check_inputs_margin(s, n, seed, mode, n_probes=16, noise=0.25):
    """No reference logit of the latents that reach the FASTA lies within
    MARGIN of 0; in focused mode both packages also pick the same anchor."""
    jsampler = s["jsampler"]
    key = jax.random.key(seed)
    if mode == "focused":
        anchor = _assert_same_anchor(s["tsampler"], jsampler, seed, n_probes)
        key = jax.random.split(key)[1]
        z = anchor + np.float32(noise) * np.asarray(jdraw(key, jnp.arange(n), 3))
    else:
        z = np.asarray(jdraw(key, jnp.arange(n), 3))
    _assert_margin(jsampler, z)


def _run_both(s, tmp_path, n, seed, tag, **kw):
    jout, tout = tmp_path / f"j_{tag}.fasta", tmp_path / f"t_{tag}.fasta"
    jstats = jpipe.sample_and_minimize(
        s["jsampler"], s["jengine"], s["cols"], s["ess"], n, str(jout),
        key=jax.random.key(seed), model_name="t", **kw)
    tstats = tpipe.sample_and_minimize(
        s["tsampler"], s["tengine"], s["cols"], s["ess"], n, str(tout),
        key=tprng.key(seed, "cpu"), model_name="t", **kw)
    return jout, tout, jstats, tstats


@pytest.mark.parametrize("mode", ["default", "focused"])
@pytest.mark.parametrize("chunk", [7, 64])
def test_pipeline_byte_equal_to_jax(setup, tmp_path, mode, chunk):
    n, seed = 17, SEED[mode]
    extra = ({"sampling_mode": "focused", "noise_level": 0.25, "n_probes": 16}
             if mode == "focused" else {})
    _check_inputs_margin(setup, n, seed, mode)
    jout, tout, jstats, tstats = _run_both(
        setup, tmp_path, n, seed, f"{mode}{chunk}", chunk_size=chunk,
        process_index=0, process_count=1, **extra)
    assert tstats.genomes == jstats.genomes == n
    head = tout.read_bytes().split(b"\n")[:2]
    assert head == [b"# Minimized genomes generated using model: t",
                    b"# Total genomes: 17"]
    assert _body(tout) == _body(jout)
    assert _body(tout).count(b">") == n


@pytest.mark.parametrize("mode", ["default", "focused"])
def test_sharded_merge_byte_equal_to_jax(setup, tmp_path, mode):
    n, seed = 12, SEED[mode]
    extra = ({"sampling_mode": "focused", "noise_level": 0.25, "n_probes": 16}
             if mode == "focused" else {})
    _check_inputs_margin(setup, n, seed, mode)
    jout = tmp_path / "single.fasta"
    jpipe.sample_and_minimize(setup["jsampler"], setup["jengine"],
                              setup["cols"], setup["ess"], n, str(jout),
                              key=jax.random.key(seed), chunk_size=5,
                              process_index=0, process_count=1, **extra)
    merged = tmp_path / "merged.fasta"
    for pi in (1, 0):  # rank 1 first: rank 0's merge waits on its sentinel
        tpipe.sample_and_minimize(setup["tsampler"], setup["tengine"],
                                  setup["cols"], setup["ess"], n, str(merged),
                                  key=tprng.key(seed, "cpu"), chunk_size=5,
                                  process_index=pi, process_count=2,
                                  merge=(pi == 0), **extra)
    assert _body(merged) == _body(jout)
    assert not os.path.exists(shard_file(str(merged), 0) + ".done")


def test_serial_schedule_matches_overlap(setup, tmp_path):
    outs = []
    for overlap in (True, False):
        out = tmp_path / f"o{overlap}.fasta"
        tpipe.sample_and_minimize(setup["tsampler"], setup["tengine"],
                                  setup["cols"], setup["ess"], 11, str(out),
                                  key=tprng.key(9, "cpu"), chunk_size=4,
                                  process_index=0, process_count=1,
                                  overlap=overlap)
        outs.append(_body(out))
    assert outs[0] == outs[1]


def test_sampler_outputs_match_jax(setup):
    js, ts = setup["jsampler"], setup["tsampler"]
    _check_inputs_margin(setup, 33, 22, "default")
    np.testing.assert_array_equal(ts.sample_packed(tprng.key(22, "cpu"), 33)[0],
                                  js.sample_packed(jax.random.key(22), 33)[0])
    _check_inputs_margin(setup, 9, 11, "focused", noise=0.1)
    np.testing.assert_array_equal(
        ts.sample_focused_packed(tprng.key(11, "cpu"), 9, n_probes=16)[0],
        js.sample_focused_packed(jax.random.key(11), 9, n_probes=16)[0])
    z = np.asarray(jdraw(jax.random.key(14), jnp.arange(20), 3))
    _assert_margin(js, z)
    np.testing.assert_array_equal(ts.decode_binary(z), js.decode_binary(z))
    dev = ts.decode_packed_device(z, pad_to=32)
    assert dev.wait().shape == (32, ts.cfg.padded_dim // 8)
    np.testing.assert_array_equal(ts.unpack_packed(dev, rows=20),
                                  js.decode_binary(z))


def test_packed_analytics_match_jax(setup):
    rng = np.random.RandomState(0)
    packed = rng.randint(0, 256, size=(50, 8)).astype(np.uint8)
    np.testing.assert_array_equal(tsmp.popcount_rows(packed, chunk_rows=7),
                                  jsmp.popcount_rows(packed))
    positions = {"a": [1, 5], "b": [63], "c": [70], "d": [2, 40, 41]}
    np.testing.assert_array_equal(
        tsmp.make_essential_counter_packed(positions, 60)(packed),
        jsmp.make_essential_counter_packed(positions, 60)(packed))
    assert tsmp.make_essential_counter_packed({}, 60)(packed).sum() == 0


def test_packed_fasta_native_numpy_and_jax_agree(setup, tmp_path):
    te, je = setup["tengine"], setup["jengine"]
    cols_arr, keep = dedupe_columns(np.asarray(setup["cols"]))
    col_idx, ess = te.feature_lookup_packed(cols_arr, keep, setup["ess"])
    jci, jess = je.feature_lookup_packed(cols_arr, keep, setup["ess"])
    np.testing.assert_array_equal(col_idx, jci)
    np.testing.assert_array_equal(ess, jess)
    packed = np.random.RandomState(1).randint(0, 256, (9, 8)).astype(np.uint8)
    paths = {}
    for label, native in (("native", True), ("numpy", False)):
        paths[label] = tmp_path / f"{label}.fasta"
        te.minimize_packed_to_fasta(packed, col_idx, ess, str(paths[label]),
                                    use_native=native)
    jpath = tmp_path / "jax.fasta"
    je.minimize_packed_to_fasta(packed, jci, jess, str(jpath), use_native=False)
    assert paths["native"].read_bytes() == paths["numpy"].read_bytes() \
        == jpath.read_bytes()
    genes = ["g001", "g003", "g000"]
    assert te.minimize(genes) == je.minimize(genes)


def test_native_minimize_batch_matches_numpy(setup):
    """The port's binding of gm2_minimize_batch against the numpy interval
    union of the same drop masks."""
    from genome_minimizer_2_torch.genome import native

    te = setup["tengine"]
    drop = np.random.RandomState(2).rand(5, len(te.gene_names)) < 0.5
    got = native.minimize_batch(te.seq_bytes, te.starts, te.ends, drop)
    for row, seq in zip(drop, got):
        assert seq == te.seq_bytes[~te._interval_union(row)].tobytes()


def test_record_bytes_matches_writers(setup, tmp_path):
    te = setup["tengine"]
    cols_arr, keep = dedupe_columns(np.asarray(setup["cols"]))
    col_idx, ess = te.feature_lookup_packed(cols_arr, keep, setup["ess"])
    z = np.asarray(jdraw(jax.random.key(12), jnp.arange(7), 3))
    packed = setup["tsampler"].decode_packed_device(z).wait()[:7]
    for label, use_native in (("numpy", False), ("native", True)):
        for start in (0, 97):  # 97..104 crosses the 2->3 digit boundary
            out = tmp_path / f"rb_{label}_{start}.fasta"
            lens = te.minimize_packed_to_fasta(packed, col_idx, ess, str(out),
                                               start_index=start,
                                               use_native=use_native)
            assert out.stat().st_size == te.record_bytes(lens, start_index=start)


def _run(setup, out, n, seed, chunk, **kw):
    return tpipe.sample_and_minimize(setup["tsampler"], setup["tengine"],
                                     setup["cols"], setup["ess"], n, str(out),
                                     key=tprng.key(seed, "cpu"),
                                     chunk_size=chunk, **kw)


def test_new_shard_stream_retracts_stale_done_sentinel(setup, tmp_path,
                                                       monkeypatch):
    out = tmp_path / "nm.fasta"
    _run(setup, out, 8, 40, 4, process_index=0, process_count=2, merge=False)
    sentinel = shard_file(str(out), 0) + ".done"
    assert os.path.exists(sentinel)
    engine = setup["tengine"]
    calls = {"n": 0}
    orig = engine.minimize_packed_to_fasta

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected crash")
        return orig(*a, **k)

    monkeypatch.setattr(engine, "minimize_packed_to_fasta", boom)
    with pytest.raises(RuntimeError, match="injected"):
        _run(setup, out, 8, 41, 2, process_index=0, process_count=2,
             merge=False)
    assert not os.path.exists(sentinel)  # retracted at stream start


def test_stream_offset_drift_is_a_loud_error(setup, tmp_path, monkeypatch):
    monkeypatch.setattr(
        tmin.MinimizerEngine, "record_bytes",
        staticmethod(lambda lens, start_index=0: int(np.asarray(lens).sum())))
    with pytest.raises(RuntimeError, match="offset drift"):
        _run(setup, tmp_path / "drift.fasta", 6, 0, 3, process_index=0,
             process_count=1)


def test_pipeline_rewrite_over_larger_previous_output(setup, tmp_path):
    out, fresh = tmp_path / "rw.fasta", tmp_path / "fresh.fasta"
    _run(setup, out, 15, 8, 4, process_index=0, process_count=1)
    assert out.read_text().count(">") == 15
    _run(setup, out, 6, 8, 4, process_index=0, process_count=1)
    _run(setup, fresh, 6, 8, 4, process_index=0, process_count=1)
    assert _body(out) == _body(fresh)
    assert out.read_text().count(">") == 6


def test_pipeline_failure_leaves_no_stale_tail(setup, tmp_path, monkeypatch):
    out = tmp_path / "crash.fasta"
    _run(setup, out, 15, 8, 4, process_index=0, process_count=1)
    size15 = out.stat().st_size
    engine = setup["tengine"]
    calls = {"n": 0}
    orig = engine.minimize_packed_to_fasta

    def boom(*a, **k):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected chunk failure")
        return orig(*a, **k)

    monkeypatch.setattr(engine, "minimize_packed_to_fasta", boom)
    with pytest.raises(RuntimeError, match="injected"):
        _run(setup, out, 15, 8, 4, process_index=0, process_count=1)
    monkeypatch.undo()
    assert out.read_text().count(">") == 4  # exactly the one completed chunk
    assert out.stat().st_size < size15


@pytest.mark.parametrize("kw,exc,match", [
    ({"transfer": "bogus"}, ValueError, "transfer"),
    ({"chunk_size": 0}, ValueError, "chunk_size"),
    ({"sampling_mode": "bogus"}, ValueError, "sampling_mode"),
])
def test_pipeline_rejects_unsupported_options(setup, tmp_path, kw, exc, match):
    with pytest.raises(exc, match=match):
        tpipe.sample_and_minimize(
            setup["tsampler"], setup["tengine"], setup["cols"], setup["ess"], 2,
            str(tmp_path / "x.fasta"), key=tprng.key(0, "cpu"),
            **{"chunk_size": 2, "process_index": 0, "process_count": 1, **kw})


@pytest.mark.parametrize("mode", ["default", "focused"])
def test_feature_bits_byte_equal_to_packed_and_jax(setup, tmp_path, mode):
    """The feature-bits transfer (keep bits gathered on the device from the
    kernel's packed output) writes the packed transfer's FASTA, and JAX's
    feature-bits FASTA, with a chunk that does not divide N."""
    n, seed = 17, SEED[mode]
    extra = ({"sampling_mode": "focused", "noise_level": 0.25, "n_probes": 16}
             if mode == "focused" else {})
    _check_inputs_margin(setup, n, seed, mode)
    jout, tout, _, tstats = _run_both(
        setup, tmp_path, n, seed, f"fb_{mode}", chunk_size=5,
        transfer="feature-bits", process_index=0, process_count=1, **extra)
    packed = tmp_path / "packed.fasta"
    _run(setup, packed, n, seed, 5, process_index=0, process_count=1, **extra)
    assert tstats.genomes == n
    assert _body(tout) == _body(packed) == _body(jout)
    assert _body(tout).count(b">") == n


@pytest.mark.parametrize("mode", ["default", "focused"])
def test_cli_cpu_matches_main_py(synth_root, tmp_path, monkeypatch, mode):
    """``python -m genome_minimizer_2_torch.cli --device cpu --mode
    pipeline`` writes the same FASTA as ``main.py --mode pipeline`` from
    one checkpoint and seed (apart from the header's timestamp line)."""
    import main as jcli
    from genome_minimizer_2_torch import cli as tcli
    from genome_minimizer_2_tpu.data.dataset import load_gene_vocab

    monkeypatch.setenv("GM2_ROOT", synth_root["root"])
    monkeypatch.chdir(tmp_path)
    cols = load_gene_vocab()
    cfg = jvae.VAEConfig(input_dim=len(cols), hidden_dim=8, latent_dim=2)
    params, stats = jvae.init(cfg, jax.random.key(4))
    ckpt = tmp_path / "cli.npz"
    jckpt.save_checkpoint(ckpt, params, stats,
                          ExperimentConfig(hidden_dim=8, latent_dim=2),
                          extra={"input_dim": len(cols)})
    sampler, _ = jsmp.load_sampler(str(ckpt))
    n, seed = 6, 12  # a seed whose final logits keep the margin
    key = jax.random.key(seed)
    if mode == "focused":
        tsampler, _ = tsmp.load_sampler(str(ckpt), device="cpu")
        anchor = _assert_same_anchor(tsampler, sampler, seed, 100)
        z = anchor + np.float32(0.1) * np.asarray(
            jdraw(jax.random.split(key)[1], jnp.arange(n), 2))
    else:
        z = np.asarray(jdraw(key, jnp.arange(n), 2))
    logits, _ = jvae.decode_logits(cfg, params, stats, jnp.asarray(z), False)
    assert float(np.abs(np.asarray(logits)[:, :len(cols)]).min()) >= MARGIN

    args = ["--mode", "pipeline", "--model-path", str(ckpt), "--num-samples",
            str(n), "--model-name", "v0", "--chunk-size", "4", "--seed",
            str(seed), "--sampling-mode", mode]
    jout, tout = tmp_path / "jax.fasta", tmp_path / "port.fasta"
    assert jcli.main(args + ["--output-file", str(jout)]) == 0
    assert tcli.main(args + ["--output-file", str(tout), "--device", "cpu"]) == 0
    strip = lambda p: [l for l in p.read_bytes().split(b"\n")  # noqa: E731
                       if not l.startswith(b"# Generated on")]
    assert strip(tout) == strip(jout)
    assert tout.read_text().count(">") == n


def test_cli_rejects_feature_bits(capsys):
    """The transfer names are exact: the misspelling ``feature_bits`` is
    rejected, ``feature-bits`` itself is taken."""
    from genome_minimizer_2_torch import cli as tcli

    args = tcli.parse_arguments(["--mode", "pipeline", "--transfer", "feature-bits"])
    assert args.transfer == "feature-bits"
    with pytest.raises(SystemExit):
        tcli.parse_arguments(["--mode", "pipeline", "--transfer", "feature_bits"])
    assert "invalid choice" in capsys.readouterr().err


def test_cli_missing_data_returns_1(tmp_path, monkeypatch):
    from genome_minimizer_2_torch import cli as tcli

    monkeypatch.setenv("GM2_ROOT", str(tmp_path))
    assert tcli.main(["--device", "cpu"]) == 1
