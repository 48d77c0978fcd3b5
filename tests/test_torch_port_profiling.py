"""The port's ranges and their reducer (``utils/profiling.py``) on the CPU:
``span`` with and without a profiler, the eager step's phases and the
sampler's stages in a trace, ``step_phases`` leaving the state alone,
``device_by_range`` on small synthetic Chrome traces, and the copy of a
train state that ``step_phases`` steps."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from genome_minimizer_2_torch.core import prng
from genome_minimizer_2_torch.models import vae
from genome_minimizer_2_torch.sample import sampler as S
from genome_minimizer_2_torch.train import trainer as T
from genome_minimizer_2_torch.utils import profiling as P
from genome_minimizer_2_torch.utils.config import get_preset_config

D = 100
STEP = ("gm2/step/forward", "gm2/step/loss", "gm2/step/loss/reconstruction",
        "gm2/step/loss/kl", "gm2/step/backward", "gm2/step/clip_norm",
        "gm2/step/update", "gm2/step/stats")
SAMPLE = ("gm2/sample/draw", "gm2/sample/submit", "gm2/sample/wait",
          "gm2/sample/on_chunk", "gm2/sample/count_genes",
          "gm2/sample/count_essential")


def _names(prof) -> set:
    return {e["name"] for e in P.profiler_events(prof)}


def test_span_without_a_profiler_is_the_shared_no_op():
    assert P.span("gm2/anything") is P._NOOP
    assert P.span(None) is P._NOOP
    with P._NOOP, P.span("gm2/nested"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = P.span("gm2/traced")
        assert ctx is not P._NOOP
        with ctx:
            torch.ones(3).sum()
        assert P.span(None) is P._NOOP
    assert "gm2/traced" in _names(prof)


def _trainer(version, batch=8):
    cfg = get_preset_config(version)
    cfg.hidden_dim, cfg.latent_dim, cfg.batch_size, cfg.seed = 16, 4, batch, 3
    t = T.create_trainer(version, cfg, D, device="cpu")
    x = (np.random.RandomState(0).rand(batch, D) < 0.4).astype(np.float32)
    return t, t.init_state(), t.prepare_data(x)


@pytest.mark.parametrize("version, terms", [
    ("v2", ("abundance", "l1")),
    ("v0", ()),
])
def test_eager_step_shows_each_phase_and_loss_term(version, terms):
    t, state, batch = _trainer(version)
    t._lr.fill_(1e-3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t._train_step(state, batch, t._epoch, t._lr)
    names = _names(prof)
    want = set(STEP) | {f"gm2/step/loss/{k}" for k in terms}
    assert want <= names, want - names
    absent = {"abundance", "l1", "l2"} - set(terms)
    assert not {f"gm2/step/loss/{k}" for k in absent} & names


def test_sample_packed_shows_the_six_sampler_ranges():
    cfg = vae.VAEConfig(input_dim=D, hidden_dim=16, latent_dim=4)
    model = vae.init_from_key(cfg, prng.key(5, "cpu"))
    smp = S.Sampler(model=model, chunk_size=16)
    counter = S.make_essential_counter_packed({"a": [1, 7], "b": [40]}, D)
    seen = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        smp.sample_packed(prng.key(9, "cpu"), 40, on_chunk=lambda lo, hi, arr: seen.append(
            (S.popcount_rows(arr), counter(arr))))
    names = _names(prof)
    assert set(SAMPLE) <= names, set(SAMPLE) - names
    assert "gm2/sample/chunks" in names  # the loop, between its stages too
    assert len(seen) == 3


def test_step_phases_leaves_every_state_leaf_bit_identical():
    t, state, batch = _trainer("v2")
    t._lr.fill_(1e-3)
    t.train_step(state, batch)  # moments away from zero
    before = {k: v.detach().clone() for k, v in state.leaves().items()}
    table = P.step_phases(t, state, batch, steps=2)
    assert table == {}  # no device on the CPU: nothing to time
    after = state.leaves()
    assert set(after) == set(before)
    for k, v in before.items():
        assert after[k].detach().numpy().tobytes() == v.numpy().tobytes(), k


@pytest.mark.parametrize("version", ["v0", "v2"])
def test_train_state_clone_is_equal_and_apart(version):
    t, state, batch = _trainer(version)
    t._lr.fill_(1e-3)
    t.train_step(state, batch)  # moments, stats, counter and key moved
    copy = state.clone()
    a, b = state.leaves(), copy.leaves()
    assert set(a) == set(b)
    for k in a:
        assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
        assert b[k].detach().numpy().tobytes() == a[k].detach().numpy().tobytes(), k
        assert b[k].data_ptr() != a[k].data_ptr(), k
    # a step on each from the same start gives the same state
    t.train_step(copy, batch)
    t.train_step(state, batch)
    for k, v in state.leaves().items():
        assert copy.leaves()[k].detach().numpy().tobytes() == \
            v.detach().numpy().tobytes(), k


def test_step_phases_refuses_a_grid():
    t, state, batch = _trainer("v0")
    t.grid = object()
    with pytest.raises(ValueError, match="grid"):
        P.step_phases(t, state, batch)


def _x(name, cat, ts, dur, tid, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace(link: str) -> list:
    """A forward mm in gm2/step/forward on thread 1; its backward node on
    the autograd thread 2 while thread 1 waits in gm2/step/backward, linked
    by the fwdbwd flow of the node's inner op or not at all, and a gradient
    sum in the node outside that op; a node with no forward op; a short
    range that launches nothing; a copy launched outside every range."""
    ev = [
        _x("gm2/step/forward", "user_annotation", 0, 100, 1),
        _x("aten::linear", "cpu_op", 8, 30, 1, **{"Sequence number": 5,
                                                   "Fwd thread id": 0}),
        _x("aten::mm", "cpu_op", 10, 20, 1, **{"Sequence number": 5,
                                                "Fwd thread id": 0}),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 3, 1, correlation=1),
        _x("mm_kernel", "kernel", 50, 40, 7, correlation=1),
        _x("gm2/step/backward", "user_annotation", 200, 100, 1),
        _x(P.BACKWARD_NODE + "MmBackward0", "cpu_op", 210, 30, 2),
        _x("MmBackward0", "cpu_op", 211, 20, 2,
           **{"Sequence number": 5, "Fwd thread id": 1}),
        _x("aten::mm", "cpu_op", 215, 10, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 216, 2, 2, correlation=2),
        _x("mm_bwd_kernel", "kernel", 230, 60, 7, correlation=2),
        # the sum of two gradients of one input: in the node, after its op
        _x("aten::add_", "cpu_op", 232, 4, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 233, 2, 2, correlation=5),
        _x("add_kernel", "kernel", 292, 2, 7, correlation=5),
        _x(P.BACKWARD_NODE + "torch::autograd::AccumulateGrad", "cpu_op",
           250, 10, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 252, 2, 2, correlation=3),
        _x("accumulate_kernel", "kernel", 295, 5, 7, correlation=3),
        _x("gm2/step/stats", "user_annotation", 350, 10, 1),
        _x("cudaMemcpyAsync", "cuda_runtime", 400, 2, 1, correlation=4),
        _x("Memcpy HtoD", "gpu_memcpy", 401, 7, 8, correlation=4),
        _x("gm2/step/forward", "gpu_user_annotation", 50, 40, 7),
    ]
    if link == "flow":
        ev += [{"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 9,
                "pid": 1, "tid": 1, "ts": 10},
               {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 9,
                "pid": 1, "tid": 2, "ts": 211, "bp": "e"}]
    return ev


@pytest.mark.parametrize("link", ["unlinked", "flow"])
def test_device_by_range_follows_launches_and_autograd_links(link):
    table = P.device_by_range(_trace(link))
    fwd, bwd = table["gm2/step/forward"], table["gm2/step/backward"]
    node = {"MmBackward0 > aten::mm": 60e-6, "MmBackward0 > aten::add_": 2e-6}
    grad = {"torch::autograd::AccumulateGrad > accumulate_kernel": 5e-6}
    assert fwd["forward_s"] == pytest.approx(40e-6)
    assert bwd["forward_s"] == 0
    if link == "flow":  # the node's kernels go to its forward op's range
        assert fwd["backward_s"] == pytest.approx(62e-6)
        assert fwd["ops"] == pytest.approx({"aten::linear": 40e-6, **node})
        assert bwd["backward_s"] == pytest.approx(5e-6)
        assert bwd["ops"] == pytest.approx(grad)
    else:  # no link: they stay where they were launched
        assert fwd["backward_s"] == 0
        assert fwd["ops"] == pytest.approx({"aten::linear": 40e-6})
        assert bwd["backward_s"] == pytest.approx(67e-6)
        assert bwd["ops"] == pytest.approx({**node, **grad})
    assert table[P.NO_RANGE]["forward_s"] == pytest.approx(7e-6)
    assert set(table) == {"gm2/step/forward", "gm2/step/backward", P.NO_RANGE}
    text = P.format_table(table)
    assert text.splitlines()[1].startswith(
        "gm2/step/forward" if link == "flow" else "gm2/step/backward")
    assert "0.1140" in text.splitlines()[-1]  # 40 + 62 + 5 + 7 us, in ms


def test_the_module_prints_the_table_of_a_trace_file(tmp_path, capsys):
    import json

    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": _trace("flow")}))
    assert P.main([str(path)]) == 0
    out = capsys.readouterr().out
    assert "gm2/step/forward" in out and "MmBackward0 > aten::mm" in out
