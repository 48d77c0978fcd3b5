"""The pipeline cell on the CPU: its generated genome against the program's
parser, the reference against the program's own numpy path, the FASTA in
memory against the same stream on disk, the ranges the benchmark marks,
runs against the reference at a tiny width, and runs with the timed path
broken underneath, each of which has to come out not correct.

The cell is held back from ``BENCHMARK.json``: its entries wait in
``deferred/v0-pipeline-fasta.json``, and these tests run it in a checkout
whose ``BENCHMARK.json`` has them appended."""

from __future__ import annotations

import copy
import json
import os
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import genbank, harness, run as RUN
from portbench.reference import pipeline as RPL
from portbench.tests import tiny

from genome_minimizer_2_torch.genome.minimizer import MinimizerEngine

CPU = torch.device("cpu")
CELL = "v0-pipeline-fasta"
REAL = None  # the cell at its true size, set by the fixture ``real``
TINY = dict(genomes_per_call=64, chunk_size=16, compute_dtype="float32",
            essential_genes=10, records_per_chunk=4,
            genome=dict(length=20_000, features=60, coverage=0.88, feature_min=100,
                        feature_max=400, complement_every=7, duplicate_share=0.05))
DRIVER = harness.load_module(harness.HERE / "drivers" / "pipeline.py")


DEFERRED = harness.HERE / "deferred" / f"{CELL}.json"


def with_deferred(bench: dict) -> dict:
    """``bench`` with the deferred cell's entries appended."""
    bench = copy.deepcopy(bench)
    for key, entries in harness.load_json(DEFERRED).items():
        bench[key] += entries
    return bench


@pytest.fixture(scope="module", autouse=True)
def real(tmp_path_factory):
    """The cell at its true size, from a checkout whose BENCHMARK.json
    holds its entries."""
    global REAL
    root = tmp_path_factory.mktemp("checkout")
    (root / "portbench").symlink_to(harness.HERE)
    bench = with_deferred(harness.load_json(harness.ROOT / "BENCHMARK.json"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    REAL = harness.Cell(CELL, root=root)
    return REAL


def _cell(**traffic):
    """The cell cut to a tiny width, as ``tiny.cell`` cuts a cell."""
    config = copy.deepcopy(REAL.config)
    config.update(input_dim=tiny.GENES, genomes=tiny.GENOMES)
    config["experiment"].update(hidden_dim=tiny.HIDDEN, latent_dim=tiny.LATENT)
    return types.SimpleNamespace(
        name=CELL, chips=1, config=config,
        traffic=dict(REAL.traffic, **dict(TINY, **traffic)), limits=dict(REAL.limits),
        driver=REAL.driver, end_to_end=REAL.end_to_end, per_layer=REAL.per_layer)


def _run(seed=987654321012, **traffic):
    clock = {"t0": time.perf_counter(), "age": 0.0, "import": 0.0}
    return RUN.run(tiny.args(seed, seconds=0.3), CPU, clock, _cell(**traffic))


def test_the_genome_has_k12s_shape_and_parses_back_to_its_arrays(tmp_path):
    p = REAL.traffic["genome"]
    cols = genbank.column_names(2 ** 40 + 7, 55_039, p["duplicate_share"])
    g = genbank.genome(2 ** 40 + 7, cols, p)
    lens = g.ends - g.starts
    assert g.seq.size == 4_641_652 and len(g.names) == 4_288
    assert lens.sum() == round(0.88 * 4_641_652) and lens.min() > 0
    assert (g.starts[1:] > g.ends[:-1]).all() and g.starts[0] >= 0
    assert g.ends[-1] <= g.seq.size
    assert len(set(g.names)) == 4_288 and set(g.names) <= set(cols)
    assert len(cols) - len(set(cols)) == round(0.01 * 55_039)
    assert g.complement.sum() == -(-4_288 // 7)
    assert len(genbank.essential_set(5, g, 300)) == 300
    eng = MinimizerEngine.from_genbank(genbank.write(tmp_path / "g.gb", g))
    assert eng.seq_bytes.tobytes() == g.seq.tobytes()
    assert list(eng.gene_names) == g.names
    assert np.array_equal(eng.starts, g.starts) and np.array_equal(eng.ends, g.ends)


def test_every_seed_covers_the_same_bases():
    p = REAL.traffic["genome"]
    covered = set()
    for seed in (1, 2 ** 33 + 5):
        g = genbank.genome(seed, genbank.column_names(seed, 55_039, 0.01), p)
        covered.add(int((g.ends - g.starts).sum()))
    assert covered == {round(0.88 * 4_641_652)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_reference_equals_the_programs_numpy_path(seed):
    """Overlapping features, features past the sequence's end, unnamed
    genes and duplicate column names: the reference's converter and
    interval union against the program's ``feature_lookup_packed``,
    ``drop_masks_from_binary`` and numpy minimize."""
    rng = np.random.default_rng(seed)
    L, F, D = 5_000, 80, 120
    cols = [f"c{i}" for i in range(D)]
    for p in rng.choice(np.arange(1, D), 12, replace=False):
        cols[p] = cols[int(rng.integers(p))]
    starts = rng.integers(0, L + 50, F)
    ends = starts + rng.integers(1, 400, F)
    names = [cols[int(i)] if rng.random() > 0.1 else f"absent{i}"
             for i in rng.integers(0, D, F)]
    essential = {names[int(i)] for i in rng.choice(F, 8, replace=False)}
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)]
    eng = MinimizerEngine(record=None, gene_names=np.array(names, dtype=object),
                          starts=starts.astype(np.int64), ends=ends.astype(np.int64),
                          seq_bytes=seq)
    from genome_minimizer_2_torch.genome.converter import dedupe_columns

    deduped, keep = dedupe_columns(np.asarray(cols))
    col_idx, ess = eng.feature_lookup_packed(deduped, keep, essential)
    bits = (rng.random((6, D)) < 0.5).astype(np.uint8)
    drop = eng.drop_masks_from_binary(bits, col_idx, ess)
    fcols = RPL.feature_columns(cols, names)
    fess = np.array([n in essential for n in names])
    want = [s.split(b"\n")[1] for s in
            RPL.records(bits, range(6), seq, eng.starts, eng.ends, fcols, fess)]
    for i in range(6):
        assert np.array_equal(~drop[i].astype(bool), RPL.kept(bits[i], fcols, fess))
        keep_bases = ~eng._interval_union(drop[i].astype(bool))
        assert eng.seq_bytes[keep_bases].tobytes() == want[i]


def _body(path_or_bytes) -> list[bytes]:
    data = (path_or_bytes if isinstance(path_or_bytes, bytes)
            else open(path_or_bytes, "rb").read())
    lines = data.split(b"\n")
    return lines[:2] + lines[3:]  # the third line holds the time of the run


@pytest.mark.parametrize("overlap", [True, False])
def test_the_memory_file_holds_what_a_file_on_disk_gets(tmp_path, overlap):
    """The program's stream into the cell's memory file, rewritten in
    place by a second call, equals its stream into a new file on disk,
    with a last chunk shorter than the rest."""
    from genome_minimizer_2_torch import pipeline as PL

    s = DRIVER.setup(_cell(), 41, CPU, {})
    sampler, engine, cols, essential, _, path = s["call"].args
    kw = dict(s["call"].keywords, overlap=overlap,
              key=torch.tensor([3, 4], dtype=torch.int64))
    disk = tmp_path / "out.fasta"
    for out in (path, str(disk)):  # the first over the warm call's 64 genomes
        PL.sample_and_minimize(sampler, engine, cols, essential, 50, out, **kw)
    size = os.fstat(s["fd"]).st_size
    assert size == disk.stat().st_size
    assert _body(os.pread(s["fd"], size, 0)) == _body(disk)
    DRIVER.release(s)


def test_the_minimize_range_appears_under_the_profiler():
    cell = _cell()
    s = DRIVER.setup(cell, 43, CPU, {})
    from torch._C._profiler import _ExperimentalConfig

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        s["call"](key=torch.tensor([5, 6], dtype=torch.int64))
    names = {e.name for e in prof.events()}
    DRIVER.release(s)
    assert "portbench/pipeline/minimize" in names  # the worker thread's


def test_the_pipeline_matches_the_reference_at_a_tiny_width():
    result, checks = _run()
    assert result["correct"], checks
    assert checks["record_mismatch"]["value"] == 0
    assert checks["bit_gap"]["value"] == 0.0  # float32 on both sides
    assert result["attempted"] % 64 == 0
    assert set(result["metrics"]) == {m["name"] for m in REAL.end_to_end}


def _kept(seed):
    cell = _cell()
    s = DRIVER.setup(cell, seed, CPU, {})
    rec = DRIVER.window(s, cell, seed, 0.2, False)
    DRIVER.release(s)
    return cell, rec["kept"]


@pytest.mark.parametrize("fault", DRIVER.FAULTS)
def test_each_planted_fault_reads_above_a_limit(fault):
    cell, kept = _kept(17)
    assert DRIVER.readings(cell, 17, kept, CPU)["record_mismatch"] == 0
    got = DRIVER.readings(cell, 17, kept, CPU, fault=fault)
    assert any(got[k] > cell.limits[k] for k in DRIVER.CHECKED), got
    if fault != "altered_bit":
        assert got["record_mismatch"] > 0


def test_the_control_reads_no_record_mismatch():
    """The reference in the program's place builds its own records from
    its own rows: only ``bit_gap`` can tell the control."""
    cell, kept = _kept(19)
    got = DRIVER.readings(cell, 19, kept, CPU, precision="fp8")
    assert got["record_mismatch"] == 0 and got["bits_differing"] > 0


# -- runs with the timed path broken underneath ------------------------------

def test_a_genome_altered_where_it_is_decoded_is_not_correct(monkeypatch):
    from genome_minimizer_2_torch.ops import kernels as K
    from genome_minimizer_2_torch.sample import sampler as SMP

    decode = K.decode_threshold_pack

    def altered(h, w, b, compute_dtype=torch.bfloat16):
        out = decode(h, w, b, compute_dtype).clone()
        out[:, 0] ^= 1
        return out

    monkeypatch.setattr(SMP.K, "decode_threshold_pack", altered)
    result, checks = _run()
    assert not result["correct"]
    assert checks["bit_gap"]["value"] > checks["bit_gap"]["limit"]


def test_the_essential_genes_left_out_is_not_correct(monkeypatch):
    inner = MinimizerEngine.feature_lookup_packed

    def no_essentials(self, cols, keep_mask, essential_set):
        col_idx, ess = inner(self, cols, keep_mask, essential_set)
        return col_idx, np.zeros_like(ess)

    monkeypatch.setattr(MinimizerEngine, "feature_lookup_packed", no_essentials)
    result, checks = _run()
    assert not result["correct"] and checks["record_mismatch"]["value"] > 0


def test_feature_intervals_off_by_one_are_not_correct(monkeypatch):
    from genome_minimizer_2_torch.genome import genbank as GB

    inner = GB.parse_location
    monkeypatch.setattr(GB, "parse_location",
                        lambda loc: (lambda s, e, d: (s, e + 1, d))(*inner(loc)))
    result, checks = _run()
    assert not result["correct"] and checks["record_mismatch"]["value"] > 0


def test_half_of_each_chunk_left_out_is_not_correct(monkeypatch):
    inner = MinimizerEngine.minimize_packed_to_fasta

    def half(self, packed, *args, **kw):
        return inner(self, packed[: len(packed) // 2], *args, **kw)

    monkeypatch.setattr(MinimizerEngine, "minimize_packed_to_fasta", half)
    result, checks = _run()
    assert not result["correct"] and checks["record_mismatch"]["value"] > 0


def test_a_record_altered_where_it_is_written_is_not_correct(monkeypatch):
    inner = MinimizerEngine.minimize_packed_to_fasta

    def altered(self, packed, col_idx, ess, path, start_index=0, write_base=0, **kw):
        lens = inner(self, packed, col_idx, ess, path, start_index=start_index,
                     write_base=write_base, **kw)
        off = write_base
        with open(path, "r+b") as f:
            for i, n in enumerate(lens):
                head = len(RPL.record(start_index + i, b"")) - 1
                f.seek(off + head)
                base = f.read(1)
                f.seek(off + head)
                f.write(b"A" if base != b"A" else b"C")
                off += head + int(n) + 1
        return lens

    monkeypatch.setattr(MinimizerEngine, "minimize_packed_to_fasta", altered)
    result, checks = _run()
    assert not result["correct"] and checks["record_mismatch"]["value"] > 0


def test_the_metric_readers():
    rec = {"driver": "pipeline", "genomes": 8192, "window_s": 4.0, "minimize_s": 3.8,
           "trace": {"busy_s": 0.01, "seconds": 2.0}}
    read = {m: harness.load_module(harness.HERE / "metrics" / f"{m}.py").read
            for m in ("pipeline_genomes_per_s", "pipeline.minimize_pct",
                      "device_idle_pct.pipeline")}
    assert read["pipeline_genomes_per_s"](rec) == 2048.0
    assert read["pipeline.minimize_pct"](rec) == pytest.approx(95.0)
    assert read["device_idle_pct.pipeline"](rec) == pytest.approx(99.5)
    for fn in read.values():
        assert fn(dict(rec, driver="sample")) is None



def test_the_deferred_cell_is_picked_up_from_its_entries(real):
    """Appended to BENCHMARK.json, the deferred entries add one cell by
    data alone: nothing of the benchmark's cells or metrics changes, and
    the cell reports setup_s, its rate and its layer metrics."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    added = with_deferred(bench)
    for key, entries in bench.items():
        if isinstance(entries, list):
            assert added[key][:len(entries)] == entries
    assert CELL not in {w["name"] for w in bench["workloads"]}
    assert real.chips == 1 and real.driver == "pipeline" and real.config["name"] == "v0"
    assert {m["name"] for m in real.end_to_end} == {"setup_s", "pipeline_genomes_per_s"}
    assert {m["name"] for m in real.per_layer} == {"pipeline.minimize_pct",
                                                   "device_idle_pct.pipeline"}
    assert all(m["moves"] == "pipeline_genomes_per_s" for m in real.per_layer)
    assert set(real.limits) == set(DRIVER.CHECKED)


def test_the_deferred_entries_keep_the_benchmarks_form():
    from portbench.tests.test_portbench_layout import METRIC_KEYS, NAME, UNIT

    entries = harness.load_json(DEFERRED)
    assert set(entries) == {"workloads", "end_to_end", "per_layer"}
    for w in entries["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in entries["end_to_end"] + entries["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert set(m) <= METRIC_KEYS and m["workloads"] == [CELL]
        assert m["better"] in ("lower", "higher")
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in entries["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
