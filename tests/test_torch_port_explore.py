"""``--mode preprocess`` and ``--mode explore`` in the port against the JAX
package: the essential-gene matching, the positions pickle and its summary,
and the exploration report (its figures exist)."""

import pickle
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from genome_minimizer_2_torch import cli as tcli
from genome_minimizer_2_torch.explore import essential_genes as TEG
from genome_minimizer_2_torch.explore import exploration as TEX
from genome_minimizer_2_tpu.data import synthetic
from genome_minimizer_2_tpu.explore import essential_genes as JEG

FIGURES = ["plot_genome_size_final.pdf", "plot_gene_count_final.pdf",
           "plot_gene_frequency_final.pdf", "plot_EG_number.pdf",
           "plot_PCA_by_phylogroup.pdf"]


@pytest.mark.parametrize("name", ["thrA_1", "ssb", "abc123_x", "_odd", "a-b"])
def test_extract_prefix_equal_to_jax(name):
    assert TEG.extract_prefix(name) == JEG.extract_prefix(name)


@pytest.mark.parametrize("name", ["  thrA ", "", None, float("nan"), 7])
def test_clean_gene_name_equal_to_jax(name):
    assert TEG.clean_gene_name(name) == JEG.clean_gene_name(name)


@pytest.fixture()
def tiny_root(tmp_path):
    """A dataset whose gene names exercise every matching branch: a direct
    match, a family prefix, a prefix of a longer name, a direct match with
    a variant, and a missing name."""
    genes = ["aceE", "thrA_1", "thrA_2", "ssbA", "lptB", "lptB_2", "zzz"]
    samples = [f"s{i}" for i in range(6)]
    rng = np.random.RandomState(0)
    mat = (rng.rand(len(genes), len(samples)) < 0.7).astype(int)
    df = pd.DataFrame(mat, index=genes, columns=samples)
    lineage = pd.DataFrame([np.ones(len(samples), int)], index=["Lineage"],
                           columns=samples)
    pa = tmp_path / "pa.csv"
    pd.concat([lineage, df]).to_csv(pa)
    ph = tmp_path / "ph.csv"
    pd.DataFrame({"ID": [s.upper() for s in samples],
                  "Phylogroup": ["A", "B1"] * 3}).to_csv(ph, index=False)
    eg = tmp_path / "eg.csv"
    pd.DataFrame({"gene": ["aceE", "thrA", "ssb", "lptB", "missing"]}).to_csv(
        eg, index=False)
    return dict(pa=str(pa), ph=str(ph), eg=str(eg), tmp=tmp_path)


def test_processor_stages_equal_to_jax(tiny_root):
    procs = [mod.EssentialGeneProcessor(
        dataset_path=tiny_root["pa"], phylogroups_path=tiny_root["ph"],
        essential_genes_path=tiny_root["eg"], output_dir=tiny_root["tmp"] / tag)
        for tag, mod in (("t", TEG), ("j", JEG))]
    for p in procs:
        p.load_datasets()
    t, j = procs
    assert t.create_gene_position_mapping() == j.create_gene_position_mapping()
    for a, b in zip(t.identify_gene_matches(), j.identify_gene_matches()):
        np.testing.assert_array_equal(a, b)
    final = t.create_final_essential_genes_mapping()
    assert final == j.create_final_essential_genes_mapping() \
        == {"aceE": [0], "lptB": [4, 5], "thrA": [1, 2]}
    assert t.validate_essential_genes_mapping(final)
    assert not t.validate_essential_genes_mapping({"bad": [99]})


def test_processing_summary_equal_to_jax(capsys):
    positions = {f"fam{i}": list(range(i + 2)) for i in range(12)}
    positions["single"] = [3]
    TEG.print_processing_summary(positions)
    got = capsys.readouterr().out
    JEG.print_processing_summary(positions)
    assert got == capsys.readouterr().out and "... and 2 more" in got


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_explore")
    synthetic.make_dataset_root(root, n_samples=40, n_genes=120,
                                genome_length=4000, seed=0)
    return root


def test_preprocess_cli_pickle_and_summary_equal_to_jax(root, monkeypatch):
    import main as jcli

    monkeypatch.setenv("GM2_ROOT", str(root))
    out = root / "data" / "essential_genes"
    files = ("essential_gene_positions.pkl", "essential_gene_positions_summary.txt")
    got = {}
    for label, run in (("j", jcli.main), ("t", tcli.main)):
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--mode", "preprocess"] + (["--device", "cpu"] if label == "t" else [])
        assert run(argv) == 0
        got[label] = [(out / f).read_bytes() for f in files]
    assert got["t"] == got["j"]
    positions = pickle.loads(got["t"][0])
    assert positions and all(isinstance(v, list) for v in positions.values())
    # a second run keeps the file unless asked to redo it
    mtime = (out / files[0]).stat().st_mtime_ns
    assert tcli.main(["--mode", "preprocess", "--device", "cpu"]) == 0
    assert (out / files[0]).stat().st_mtime_ns == mtime


def test_explore_cli_report_equal_to_jax_and_figures(root, monkeypatch):
    import main as jcli

    monkeypatch.setenv("GM2_ROOT", str(root))
    out = root / "data" / "data_exploration"
    listed = root / "data" / "essential_genes" / "essential_gene_in_ds.npy"
    got = {}
    for label, run in (("j", jcli.main), ("t", tcli.main)):
        shutil.rmtree(out, ignore_errors=True)
        argv = ["--mode", "explore"] + (["--device", "cpu"] if label == "t" else [])
        assert run(argv) == 0
        got[label] = ((out / "data_exploration_report.txt").read_text(),
                      listed.read_bytes())
        assert all((out / f).stat().st_size > 0 for f in FIGURES), label
    assert got["t"] == got["j"]
    assert "Total genomes: 40" in got["t"][0]


def test_explore_without_figures_still_writes_the_report(root, monkeypatch, capsys):
    monkeypatch.setenv("GM2_ROOT", str(root))
    out = root / "data" / "data_exploration"
    shutil.rmtree(out, ignore_errors=True)
    monkeypatch.setattr(TEX, "HAS_MATPLOTLIB", False)
    TEX.main()
    assert (out / "data_exploration_report.txt").exists()
    assert not any((out / f).exists() for f in FIGURES)
    assert "Figures skipped" in capsys.readouterr().out


def test_process_essential_genes_equal_to_jax(tiny_root):
    from genome_minimizer_2_torch.data.dataset import load_and_validate_data
    from genome_minimizer_2_tpu.explore import exploration as JEX

    _, merged_df, _ = load_and_validate_data(tiny_root["pa"], tiny_root["ph"])
    want = JEX.process_essential_genes(merged_df, tiny_root["eg"], save_list=False)
    got = TEX.process_essential_genes(merged_df, tiny_root["eg"], save_list=False)
    pd.testing.assert_frame_equal(got, want)
    assert "thrA" in got.columns and "thrA_1" not in got.columns
    report_dir = Path(tiny_root["tmp"])
    text = TEX.generate_summary_report(merged_df, got, report_dir)
    assert text == JEX.generate_summary_report(merged_df, want, report_dir)
