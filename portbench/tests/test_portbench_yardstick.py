"""The benchmark's arithmetic: the roofline bounds against the values
PERF.md records for them, the model FLOP counts, and the reductions of a
trace and of a window to metrics."""

from __future__ import annotations

import pytest

from portbench import harness, roofline as R, trace

V0 = (55_040, 1_024, 64)


@pytest.mark.parametrize("got, want", [
    (lambda: R.decode_threshold_pack_ms(512, 1024, 55_040, "bfloat16"), 0.0584),
    (lambda: R.output_layer_bwd_ms(2048, 1024, 55_040, "bfloat16"), 0.4668),
    (lambda: R.clip_adam_ms(R.adam_values(*V0), "bfloat16"), 0.6996),
    (lambda: R.clip_adam_ms(R.adam_values(*V0), "float32"), 0.9795),
    (lambda: R.output_layer_bwd_ms(2048, 1024, 55_040, "float32"), 6.8912),
    (lambda: R.decode_threshold_pack_ms(512, 1024, 55_040, "float32"), 0.8614),
])
def test_bounds_reproduce_the_recorded_ones(got, want):
    assert round(got(), 4) == want


def test_what_bounds_each_kernel():
    assert R.bound(2 * 512 * 1024 * 55_040, 1.0, R.PEAK_BF16_FLOPS)[1] == "operations"
    assert R.bound(15.0, 2.3e9, R.PEAK_FP32_FLOPS)[1] == "bytes"


def test_v0_holds_117_2_million_values():
    assert round(R.adam_values(*V0) / 1e6, 1) == 117.2


@pytest.mark.parametrize("dims, train, forward", [
    ((55_039, 1024, 64), 0.590, 0.234),
    ((55_039, 512, 32), 0.288, 0.115),
])
def test_model_flops_a_row(dims, train, forward):
    assert round(R.train_flops(*dims) / 1e9, 3) == train
    assert round(R.forward_flops(*dims) / 1e9, 3) == forward


def test_decode_flops_count_every_decoder_layer():
    g, h, lat = 55_039, 1024, 64
    assert R.decode_flops(g, h, lat) == 2.0 * (lat * h + h * h + h * h + h * g)


def _events():
    """Three kernels on the device (one overlapping another), a copy, and
    host ranges around the gaps between them (us)."""
    return [
        {"ph": "X", "cat": "kernel", "name": "clip_adam_kernel", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "gm2::gemm_kernel<true>", "ts": 50, "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 200, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "dl_pass_kernel", "ts": 400, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "gm2/validation", "ts": 140, "dur": 70},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 145, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 240, "dur": 200},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 500},
    ]


def test_busy_time_is_the_union_of_device_spans():
    s = trace.summarize(_events())
    assert s["busy_s"] == pytest.approx(300e-6)
    assert trace.kernel_seconds(s, ("gemm_kernel", "dl_pass")) == pytest.approx(200e-6)


def test_idle_gaps_are_named_by_what_the_host_did():
    s = trace.summarize(_events())
    assert s["idle"] == {"gm2/validation > cudaGraphLaunch": pytest.approx(50e-6),
                         "no range > cudaStreamSynchronize": pytest.approx(150e-6)}
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "clip_adam_kernel"
    assert b["idle_gaps"][0] == ["no range > cudaStreamSynchronize", pytest.approx(150e-6)]


def test_no_device_activity_is_an_error():
    with pytest.raises(RuntimeError):
        trace.summarize([e for e in _events() if e["cat"] not in trace.DEVICE_CATS])


def _load(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py")


def test_window_metrics_from_made_up_epochs():
    epochs = [0.05] * 9 + [0.15]
    rec = {"driver": "train", "epochs": 10, "train_rows": 7000, "val_rows": 2000,
           "window_s": sum(epochs), "epoch_s": epochs, "genes": 55_039,
           "hidden": 1024, "latent": 64, "compute_dtype": "bfloat16"}
    assert _load("train_examples_per_s").read(rec) == pytest.approx(70_000 / 0.6)
    # the 90th percentile of 10 values (printed on stderr) lies between the
    # 9th and the 10th
    assert harness.p90(epochs) == pytest.approx(0.06)
    flops = 10 * (7000 * R.train_flops(55_039, 1024, 64)
                  + 2000 * R.forward_flops(55_039, 1024, 64))
    assert _load("train_step_mfu").read(rec) == pytest.approx(
        100 * flops / (0.6 * 989e12))
    assert _load("sample_genomes_per_s").read(rec) is None
    assert _load("device_idle_pct.train").read(rec) is None  # no trace


def test_idle_share_of_a_traced_slice():
    rec = {"driver": "sample", "trace": {"busy_s": 0.25, "seconds": 1.0}}
    assert _load("device_idle_pct.sample").read(rec) == pytest.approx(75.0)
    assert _load("device_idle_pct.train").read(rec) is None


def test_a_roofline_share_needs_every_launch_in_the_trace():
    s = trace.summarize(_events())
    rec = {"driver": "train", "hidden": 1024, "genes_padded": 55_040,
           "latent": 64, "compute_dtype": "bfloat16", "moment_dtype": "bfloat16",
           "train_batches": [2048, 2048, 2048, 856],
           "trace": dict(s, epochs=1, seconds=1.0,
                         launches={"output_layer_bwd": 4,
                                   "clip_adam_apply_leaves": 4})}
    share = _load("roofline_pct.output_layer_bwd").read(rec)
    least = sum(R.output_layer_bwd_ms(b, 1024, 55_040, "bfloat16")
                for b in rec["train_batches"])
    assert share == pytest.approx(100 * least / 1e3 / 200e-6)
    rec["trace"]["launches"]["output_layer_bwd"] = 3
    assert _load("roofline_pct.output_layer_bwd").read(rec) is None
