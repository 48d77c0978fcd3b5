"""The reader of ``roofline_pct.weight_grad``: its least time against the
bound of v0's and v2's input layer worked out by hand, and its share from a
made-up trace, silent where the program has no such kernel or the trace
lacks a launch."""

from __future__ import annotations

import pytest

from portbench import harness, trace

READER = harness.load_module(harness.HERE / "metrics" / "roofline_pct.weight_grad.py")


@pytest.mark.parametrize("hidden, want_ms", [(1024, 0.06839), (512, 0.03472)])
def test_input_layer_is_bound_by_its_stores(hidden, want_ms):
    # 55,040 x hidden float32 written, 32 x 55,040 bf16 and 32 x hidden
    # float32 read, at 3.35 TB/s
    nbytes = 55_040 * hidden * 4 + 32 * 55_040 * 2 + 32 * hidden * 4
    assert READER.least_ms(32, 55_040, hidden) == pytest.approx(nbytes / 3.35e9)
    assert round(READER.least_ms(32, 55_040, hidden), 5) == want_ms


def test_a_step_has_eight_launches_input_layer_first():
    prods = READER.products(55_040, 1024, 64)
    assert len(prods) == 8 and prods[0] == (55_040, 1024)
    assert (1024, 55_040) not in prods  # the output layer has its own kernel


def _record(launches, name="void gm2::wgrad::weight_grad_kernel<true>(...)"):
    events = [{"ph": "X", "cat": "kernel", "name": name, "ts": 0, "dur": 400},
              {"ph": "X", "cat": "kernel", "name": "clip_adam_kernel", "ts": 500,
               "dur": 100}]
    return {"driver": "train", "genes_padded": 55_040, "hidden": 1024, "latent": 64,
            "train_batches": [32, 32, 24],
            "trace": dict(trace.summarize(events), epochs=2, seconds=1.0,
                          launches=launches)}


def test_share_of_the_traced_launches():
    rec = _record({"weight_grad_bf16": 2 * 3 * 8})
    least = 2 * sum(READER.step_ms(b, 55_040, 1024, 64) for b in (32, 32, 24))
    assert READER.read(rec) == pytest.approx(100 * least / 1e3 / 400e-6)


@pytest.mark.parametrize("launches, name", [
    ({"weight_grad_bf16": 2 * 3 * 8 - 1}, None),  # a launch outside the trace
    ({}, None),  # a program without the kernel counts none
    ({"weight_grad_bf16": 48}, "void gm2::gemm_kernel<true, true>(...)"),
])
def test_silent_without_every_launch_or_the_kernel(launches, name):
    rec = _record(launches) if name is None else _record(launches, name)
    assert READER.read(rec) is None


def test_sample_cells_read_nothing():
    assert READER.read({"driver": "sample", "trace": {}}) is None
