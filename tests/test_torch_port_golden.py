"""The port on the CPU, at full v0 width and float32, against the JAX
package's answers in ``tests/golden/torch_port_jax_v0.json``: the inputs
rebuilt from the file's recipe by the port's own generators and held to
its digests, the first 512-genome chunk of the default and the focused
pipeline, and the first gradient and training epoch. The checks are
chip_smoke.py's phase 8 (``reference_inputs``, ``hold_pipeline``,
``hold_training``) on the CPU; the card runs all 2,048 genomes, the sample
file and two epochs.

A record may differ from the reference's only where the reference's float32
logit lies within the file's ``near_zero`` of 0 (shown by rebuilding it with
the reference's bits there), or else where a logit here lies within 1e-3
of 0, for at most 1 % of the records. The ``slow`` test reruns the
generator, ``tests/_torch_jax_golden.py``, and requires its output to be
the committed file byte for byte.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as CS
from genome_minimizer_2_torch.data import synthetic

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "golden" / "torch_port_jax_v0.json"


@pytest.fixture(scope="module")
def golden():
    return CS.load_golden(GOLDEN)


@pytest.fixture(scope="module")
def reference(golden, tmp_path_factory):
    """The reference's inputs rebuilt on the CPU (digests held) under a
    GM2_ROOT of this module's own."""
    root = tmp_path_factory.mktemp("reference")
    old = os.environ.get("GM2_ROOT")
    os.environ["GM2_ROOT"] = str(root)
    try:
        yield root, CS.reference_inputs(root, golden, "cpu")
    finally:
        if old is None:
            os.environ.pop("GM2_ROOT", None)
        else:
            os.environ["GM2_ROOT"] = old


def test_presence_absence_matrix_is_the_csv_writers(tmp_path):
    path = tmp_path / "pa.csv"
    genes, samples = synthetic.write_presence_absence_fast(path, 37, 101, seed=3,
                                                           chunk_rows=16)
    rows = path.read_text().splitlines()[2:]
    want = np.array([[int(c) for c in r.split(",")[1:]] for r in rows]).T
    got = synthetic.presence_absence_matrix(37, 101, seed=3, chunk_rows=16)
    assert got.dtype == np.uint8 and got.shape == (37, 101)
    np.testing.assert_array_equal(got, want)


def test_golden_file_is_small_and_holds_no_weights(golden):
    assert GOLDEN.stat().st_size < 1 << 20
    r = golden["recipe"]
    assert set(golden["sha256"]) == {"genes", "essentials", "genbank", "matrix",
                                     "checkpoint", "train_init"}
    for mode in ("default", "focused"):
        ref = golden["pipeline"][mode]
        assert ref["records"] == len(ref["digests"]) == len(ref["near_zero"]) \
            == r["num_samples"]
    assert golden["sample"]["rows"] == len(golden["sample"]["digests"])
    # per leaf a handful of sums, never its values
    ref = golden["training"]
    assert set(ref["first_grad"]) == {k for k in ref["epochs"][0]["leaves"]
                                      if k.startswith("params/")}
    for stats in ref["first_grad"].values():
        assert set(stats) == {"n", "sum", "sumsq", "projection"}
    layer = r["batch"] * r["hidden"]
    assert len(ref["relu_near_zero"]) == 6
    assert all(0 < abs(e) <= layer for x in ref["relu_near_zero"] for e in x)
    for run in [ref, *ref["reorders"]]:
        for epoch in run["epochs"]:
            for stats in epoch["leaves"].values():
                assert set(stats) <= {"n", "sum", "sumsq", "max_abs", "upd_sum",
                                      "upd_sumsq"}


@pytest.mark.parametrize("epochs", [1, 2])
def test_each_reordered_jax_run_passes_what_is_held(golden, epochs):
    """Each of the JAX package's reordered runs (its sums over genes,
    hidden units or the batch in another order: equal in exact arithmetic)
    passes every training check the port is held to, with the limits set
    by the other eight; and some quantities move past their stated
    tolerance in them, which is why a limit follows their spread."""
    runs = golden["training"]["reorders"]
    assert sorted({run["reorder"] for run in runs}) == ["batch", "genes", "hidden"]
    for i, run in enumerate(runs):
        gaps = CS.training_gaps(run, golden, epochs, runs[:i] + runs[i + 1:])
        assert not gaps["fails"], (run["reorder"], gaps["fails"])
    gaps = CS.training_gaps(runs[0], golden, epochs)
    assert any(v > 1.0 for v in gaps["spread"].values())
    for q, v in gaps["spread"].items():
        assert gaps["limit"][q] == max(1.0, CS.SPREAD_FACTOR * v), q


@pytest.mark.parametrize("mode", ["default", "focused"])
def test_pipeline_first_chunk_matches_jax(mode, golden, reference):
    root, inputs = reference
    chunk = golden["recipe"]["chunk"]
    got, _ = CS.reference_pipeline(inputs, golden, root, mode, "float32",
                                   device="cpu", num_samples=chunk)
    lookup = CS.plain_lookup(inputs["models"]["float32"], inputs["genbank"], "cpu")
    held = CS.hold_pipeline(f"{mode} chunk 0", got, golden, mode, lookup,
                            records=chunk)
    assert held["rows"] == chunk
    assert held["equal"] + held["near_zero_proven"] + held["excused"] == chunk
    assert held["excused"] <= int(CS.MAX_EXCUSED_FRACTION * chunk)
    # a FASTA that lost its last record fails, against the chunk and
    # against the whole reference alike
    with pytest.raises(AssertionError, match="rows, the reference has"):
        CS.hold_pipeline(mode, got[:-1], golden, mode, lookup, records=chunk)
    with pytest.raises(AssertionError, match="rows, the reference has"):
        CS.hold_pipeline(mode, golden["pipeline"][mode]["digests"][:-1], golden,
                         mode, lookup)


def test_first_gradient_and_epoch_match_jax(golden, reference):
    _, inputs = reference
    trainer, (train_x, val_x, _) = CS.reference_trainer(golden, inputs["matrix"],
                                                        "cpu", 1)
    trainer._platform = lambda: "cuda"  # the block shuffle, as on the card
    assert trainer._use_block_shuffle(len(train_x))
    state = trainer.init_state()
    init = {k: v.detach().clone() for k, v in CS.model_leaves(state.model).items()}
    assert CS.leaves_digest(init) == golden["sha256"]["train_init"]
    first = CS.first_gradient(trainer, state, train_x, golden, "cpu")
    assert CS.hold_first_gradient(first, golden)["worst_decided"]["share"] <= 1.0
    trainer.train(train_x, val_x, state=state)
    held = CS.hold_training(trainer, init, golden, 1)
    assert all(w["share"] <= 1.0 for w in held["worst"].values())


@pytest.mark.slow
def test_golden_file_is_what_jax_gives(tmp_path):
    out = tmp_path / "golden.json"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "_torch_jax_golden.py"),
                           "--out", str(out)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=1800)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert out.read_bytes() == GOLDEN.read_bytes()
    assert json.loads(out.read_text())["recipe"]["near_zero"] > 0
