"""The reference against the program at a tiny width on the CPU, its
generator against the program's, and runs that are driven as the card's
are (the look for a card skipped) with the timed path broken underneath:
each has to come out not correct."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench import harness, run as RUN
from portbench.reference import prng as RP
from portbench.reference import train as RT
from portbench.tests import tiny

from genome_minimizer_2_torch.core import prng as PP
from genome_minimizer_2_torch.data.split import three_way_split

CPU = torch.device("cpu")
KEY = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
F32 = dict(compute_dtype="float32", adam_state_dtype="float32")
TINY_TRAIN = {"v2-train-b32": F32, "v0-train-b32": F32}
TINY_SAMPLE = dict(genomes_per_call=256, chunk_size=64, compute_dtype="float32",
                   essential_genes=40)


def _pkey():
    return torch.tensor(KEY.astype(np.int64))


def test_split_fold_in_and_bits_equal_the_programs():
    assert np.array_equal(RP.split(KEY, 3), PP.split(_pkey(), 3).numpy())
    assert np.array_equal(RP.fold_in(KEY, np.arange(5)),
                          PP.fold_in(_pkey(), torch.arange(5)).numpy())
    assert np.array_equal(RP.random_bits(KEY, 1000),
                          PP.random_bits(_pkey(), (1000,)).numpy())


def test_normals_and_permutations_equal_the_programs():
    got = RP.normal(KEY[None], 4096)[0]
    want = PP.normal(_pkey(), (4096,)).numpy()
    # the program's erfinv is XLA's float32 polynomial, the reference's
    # float64 rounded once: they part by up to about 1e-5 in the tails
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
    for n in (875, 7000, 100_000):
        assert np.array_equal(RP.permutation(KEY, n), PP.permutation(_pkey(), n).numpy())


def test_the_split_equals_the_programs():
    for n in (200, 10_000):
        sp = three_way_split(n, 0.3, 0.3333, 12345)
        train, val = RT.split_indices(n, 0.3, 0.3333, 12345)
        assert np.array_equal(train, sp.train_idx) and np.array_equal(val, sp.val_idx)


def _run(name, seed=987654321012, **traffic):
    cell = tiny.cell(name, **traffic)
    clock = {"t0": time.perf_counter(), "age": 0.0, "import": 0.0}
    return RUN.run(tiny.args(seed, seconds=0.3), CPU, clock, cell)


@pytest.mark.parametrize("name", sorted(TINY_TRAIN))
def test_training_matches_the_reference_at_a_tiny_width(name):
    result, checks = _run(name, **TINY_TRAIN[name])
    assert result["correct"], checks
    for c in checks.values():  # float32 on both sides: far inside any limit
        assert c["value"] < 1e-3
    assert set(result["metrics"]) == {m["name"] for m in harness.Cell(name).end_to_end}


def _readings(cell, seed):
    """The program's readings of the window's first epoch."""
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    s = drv.setup(cell, seed, CPU, {})
    rec = drv.window(s, 0.0, False, 0)
    drv.release(s)
    return drv, rec


def test_bf16_training_on_the_cpu_stays_below_the_fp8_control():
    """The card's bf16 roundings, run on the CPU, against the reference;
    the reference with fp8 products and moments in the program's place
    reads more."""
    cell = tiny.cell("v0-train-b32", compute_dtype="bfloat16",
                     adam_state_dtype="bfloat16")
    drv, rec = _readings(cell, 5)
    want = drv.reference_readings(cell, 5, CPU)
    prog = RT.gaps(rec["readings"], want)
    ctl = RT.gaps(drv.reference_readings(cell, 5, CPU, "fp8"), want)
    checked = [k for k in drv.CHECKED if k in prog]
    assert max(prog[k] for k in checked) < max(ctl[k] for k in checked)
    assert ctl["first_loss_gap"] > 3 * prog["first_loss_gap"]


def test_the_window_checks_its_own_first_epochs():
    """The readings come from the window's epochs 0 and 1, started from the
    seed's state after the warm epoch: a second window from a fresh load
    reads the same, and the warm epoch leaves no trace in them."""
    cell = tiny.cell("v2-train-b32", **F32)
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    s = drv.setup(cell, 3, CPU, {})
    first = drv.window(s, 0.0, False, 0)
    drv.load_seed(s, cell, 3)
    again = drv.window(s, 0.0, False, 0)
    drv.release(s)
    assert first["epochs"] == again["epochs"] == 2
    assert str(first["readings"]) == str(again["readings"])
    g = RT.gaps(first["readings"], drv.reference_readings(cell, 3, CPU))
    assert g["first_loss_gap"] < 1e-5 and g["epoch1_rows_mismatch"] == 0


def test_a_second_epoch_that_repeats_the_first_ones_rows_is_not_correct(monkeypatch):
    """A key that does not advance across epochs: epoch 1 shuffles as epoch
    0 did, which the first steps' readings cannot see."""
    from genome_minimizer_2_torch.train import trainer as TR

    split = TR.prng.split
    seen = []

    def first_key_again(key, num=2):
        out = split(key, num)
        if not seen:
            seen.append(key.clone())
        return out

    def run_epoch(self, state, data, n, epoch, lr, train):
        if train and seen:
            state.rng.copy_(seen[0])
        return inner(self, state, data, n, epoch, lr, train)

    inner = TR.VAETrainer.run_epoch
    monkeypatch.setattr(TR.prng, "split", first_key_again)
    monkeypatch.setattr(TR.VAETrainer, "run_epoch", run_epoch)
    result, checks = _run("v2-train-b32", **F32)
    assert not result["correct"]
    assert checks["epoch1_rows_mismatch"]["value"] > 0


def test_sampling_matches_the_reference_at_a_tiny_width():
    result, checks = _run("v0-sample-packed", **TINY_SAMPLE)
    assert result["correct"], checks
    assert checks["count_mismatch"]["value"] == 0
    assert result["attempted"] % 256 == 0


def test_the_control_and_the_faults_read_above_the_limits():
    """What calibrate.py reads on the card, at a tiny width: the control
    and each fault fail at least one of the cell's numbers."""
    cell = tiny.cell("v2-train-b32", **F32)
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    want = drv.reference_readings(cell, 11, CPU)
    fails = lambda g: any(g[k] > cell.limits[k] for k in drv.CHECKED  # noqa: E731
                          if k in g)
    assert fails(RT.gaps(drv.reference_readings(cell, 11, CPU, "fp8"), want))
    assert fails(RT.gaps(drv.reference_readings(cell, 11, CPU, half_batch=True), want))


# -- runs with the timed path broken underneath ------------------------------

def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from genome_minimizer_2_torch.train import trainer as TR

    monkeypatch.setattr(TR, "clip_adam_step", lambda *a, **k: None)
    result, checks = _run("v2-train-b32", **F32)
    assert not result["correct"]
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_batch_left_out_is_not_correct(monkeypatch):
    from genome_minimizer_2_torch.train import trainer as TR

    inner = TR.VAETrainer.loss_and_grads

    def half(self, state, batch, epoch, key, share=None):
        comps, grads, stats = inner(self, state, batch[: len(batch) // 2], epoch,
                                    key, share)
        return ({k: v * 2 for k, v in comps.items()},
                {k: g * 2 for k, g in grads.items()}, stats)

    monkeypatch.setattr(TR.VAETrainer, "loss_and_grads", half)
    result, checks = _run("v0-train-b32", **TINY_TRAIN["v0-train-b32"])
    assert not result["correct"]


def test_an_epoch_with_non_finite_losses_is_not_correct(monkeypatch):
    from genome_minimizer_2_torch.train import trainer as TR

    inner = TR.VAETrainer._val_step

    def nan(self, state, batch, epoch, share=None):
        return {k: v * float("nan") for k, v in inner(self, state, batch, epoch,
                                                       share).items()}

    monkeypatch.setattr(TR.VAETrainer, "_val_step", nan)
    result, checks = _run("v2-train-b32", **F32)
    assert not result["correct"] and result["failed"] == result["attempted"]
    assert checks["nonfinite_epochs"]["value"] > 0


def test_a_genome_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from genome_minimizer_2_torch.ops import kernels as K
    from genome_minimizer_2_torch.sample import sampler as SMP

    decode = K.decode_threshold_pack

    def altered(h, w, b, compute_dtype=torch.bfloat16):
        out = decode(h, w, b, compute_dtype).clone()
        out[0, 0] ^= 1
        return out

    monkeypatch.setattr(SMP.K, "decode_threshold_pack", altered)
    result, checks = _run("v0-sample-packed", **TINY_SAMPLE)
    assert not result["correct"]
    assert checks["bit_gap"]["value"] > checks["bit_gap"]["limit"]
