"""The training epoch as a capture-ready program (``train/trainer.py::
EpochProgram``), on the CPU: what a CUDA graph of it would replay.

- The schedules of an int32 device epoch (the scalar a captured graph
  reads) equal the host floats of an ``int`` epoch bit for bit, for every
  epoch of the presets' linear, cosine and constant beta and gamma scale,
  and of schedules whose float32 products and quotients round.
- The program run eagerly with its static buffers (the epoch buffer, the
  trainer's epoch and learning-rate scalars, the loss sums) is bit-equal
  to the eager ``run_epoch`` over 3 epochs with a ragged last batch, for v0
  and v3, on the exact row permutation and on the 8-row block shuffle;
  ``run_epoch`` is what tests/test_torch_train_trainer.py holds to the JAX
  trainer. Both run the one epoch body: each calls the trainer's step
  through its attribute once a step with the same arguments.
- No host constant and no host read inside an epoch: ``torch.tensor``,
  ``torch.as_tensor``, ``torch.from_numpy`` and ``Tensor.item`` /
  ``tolist`` / ``numpy`` raise while the program runs (a copy from the host
  cannot be captured, and a read waits for the card).
- A program serves only the state and data it was built for; training
  from a loaded state builds new programs and never reads the old state.
"""

import numpy as np
import pytest
import torch

from genome_minimizer_2_torch.ops import kernels as K
from genome_minimizer_2_torch.ops import losses as L
from genome_minimizer_2_torch.train import trainer as T
from genome_minimizer_2_torch.utils.config import get_preset_config

D = 300


def _spec(version, **overrides):
    spec = L.spec_for_preset(version, get_preset_config(version))
    return spec if not overrides else L.LossSpec(**{**spec.__dict__, **overrides})


SPECS = {
    "linear v0": _spec("v0"),
    "linear 0.1-0.7 over 37": _spec("v0", min_beta=0.1, max_beta=0.7, n_epochs=37),
    "cosine v2": _spec("v2"),
    "cosine v3": _spec("v3"),
    "cosine T=7 over 37": _spec("v3", T=7, min_beta=0.3, max_beta=0.9, n_epochs=37),
    "constant": _spec("v0", scheduler_type="constant", max_beta=0.37),
}


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(SPECS))
def test_device_beta_equals_host_beta_every_epoch(name):
    spec = SPECS[name]
    epochs = torch.arange(spec.n_epochs, dtype=torch.int32)
    for counter in (0, 1, 31, 1000):
        c = torch.tensor(counter, dtype=torch.int32)
        device = L.beta_schedule(spec, epochs, c)
        host = [L.beta_schedule(spec, e, c) for e in range(spec.n_epochs)]
        if spec.scheduler_type == "linear":
            assert isinstance(device, torch.Tensor) and isinstance(host[0], float)
        host = np.array([float(h) for h in host], np.float32)
        device = np.broadcast_to(np.asarray(device, np.float32), host.shape)
        np.testing.assert_array_equal(_bits(device), _bits(host), err_msg=name)


@pytest.mark.parametrize("version,overrides", [
    ("v1", {}), ("v3", {}),
    ("v3", dict(gamma_start=0.9, gamma_end=0.2, weight=0.3, n_epochs=37))])
def test_device_gamma_scale_equals_host_every_epoch(version, overrides):
    spec = _spec(version, **overrides)
    device = L.abundance_scale(spec, torch.arange(spec.n_epochs, dtype=torch.int32))
    host = np.array([L.abundance_scale(spec, e) for e in range(spec.n_epochs)],
                    np.float32)
    assert device.dtype == torch.float32
    np.testing.assert_array_equal(_bits(device.numpy()), _bits(host))


def _trainer(version, batch, block, epochs=3):
    cfg = get_preset_config(version)
    cfg.hidden_dim, cfg.latent_dim, cfg.n_epochs = 32, 8, epochs
    cfg.batch_size, cfg.print_every, cfg.seed = batch, 1000, 7
    t = T.create_trainer(version, cfg, D, device="cpu")
    if block:
        t._platform = lambda: "cuda"  # the CUDA gate; the gather's plain version
    return t


def _data(n, nv, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.1, 0.9, D)
    return ((rng.rand(n, D) < p).astype(np.float32),
            (rng.rand(nv, D) < p).astype(np.float32))


# (rows, batch): 3 batches of 32 + 4 on the exact row permutation; 2 batches
# of 256 + 8 (65 blocks of 8) on the block shuffle
SHAPES = {False: (100, 32), True: (520, 256)}


def _programs(t, state, x, xv):
    return (t._get_epoch_graph(x.shape[0], True, state, x),
            t._get_epoch_graph(xv.shape[0], False, state, xv))


def _assert_same_state(a, b):
    la, lb = a.leaves(), b.leaves()
    assert list(la) == list(lb)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("version", ["v0", "v3"])
def test_program_is_bit_equal_to_run_epoch(version, block):
    n, batch = SHAPES[block]
    t = _trainer(version, batch, block)
    x, xv = (t.prepare_data(a) for a in _data(n, 40, seed=5))
    eager, graphed = t.init_state(), t.init_state()
    prog_t, prog_v = _programs(t, graphed, x, xv)
    assert prog_t.block == block and prog_v.buf is None
    for epoch in range(3):
        lr = T.step_lr(t.config.learning_rate, t.config.scheduler_step_size,
                       t.config.scheduler_gamma, epoch)
        lr_t = torch.full((), lr, dtype=torch.float32)
        want_tr = t.run_epoch(eager, x, n, epoch, lr_t, train=True)
        want_vl = t.run_epoch(eager, xv, 40, epoch, lr_t, train=False)
        t._epoch.fill_(epoch)
        t._lr.fill_(lr)
        got_tr = {k: v.clone() for k, v in prog_t.run(t, t._epoch, t._lr).items()}
        got_vl = prog_v.run(t, t._epoch, t._lr)
        for want, got in ((want_tr, got_tr), (want_vl, got_vl)):
            assert list(want) == list(got)
            for k in want:
                assert torch.equal(want[k], got[k]), (epoch, k)
        _assert_same_state(eager, graphed)
    assert int(graphed.counter) == 3 * (-(-n // batch) + -(-40 // batch))


@pytest.mark.parametrize("block", [False, True])
def test_eager_and_programmed_epochs_call_the_step_alike(block):
    """One eager ``run_epoch`` and one ``EpochProgram.run`` of the same set
    each call the trainer's step through its attribute, which the
    benchmark's taps replace on the instance, once a step, positionally
    ``(state, batch, epoch, lr, share)``, with the same batch shapes, the
    ragged last batch included."""
    n, batch = SHAPES[block]
    t = _trainer("v0", batch, block)
    x = t.prepare_data(_data(n, 40, seed=10)[0])
    eager, programmed = t.init_state(), t.init_state()
    prog = t._get_epoch_graph(n, True, programmed, x)
    inner, calls = t._train_step, {"eager": [], "program": []}
    way = "eager"

    def step(*args):
        calls[way].append(args)
        return inner(*args)

    t._train_step = step
    t._epoch.fill_(0)
    t._lr.fill_(1e-3)
    t.run_epoch(eager, x, n, 0, t._lr, train=True)
    way = "program"
    prog.run(t, t._epoch, t._lr)
    shapes = [(min(batch, n - lo), x.shape[1]) for lo in range(0, n, batch)]
    assert shapes[-1][0] < batch  # a ragged last batch
    for way, state, epoch in (("eager", eager, 0), ("program", programmed, t._epoch)):
        got = calls[way]
        assert [tuple(args[1].shape) for args in got] == shapes, way
        for args in got:
            assert len(args) == 5, way
            assert args[0] is state and args[2] is epoch, way
            assert args[3] is t._lr and args[4] is None, way
    _assert_same_state(eager, programmed)


_HOST = [(torch, "tensor"), (torch, "as_tensor"), (torch, "from_numpy"),
         (torch.Tensor, "item"), (torch.Tensor, "tolist"), (torch.Tensor, "numpy")]


@pytest.mark.parametrize("block", [False, True])
@pytest.mark.parametrize("version", ["v0", "v3"])
def test_no_host_constant_or_read_inside_an_epoch(version, block, monkeypatch):
    n, batch = SHAPES[block]
    t = _trainer(version, batch, block)
    x, xv = (t.prepare_data(a) for a in _data(n, 40, seed=6))
    state = t.init_state()
    progs = _programs(t, state, x, xv)
    t._epoch.fill_(0)
    t._lr.fill_(1e-3)
    for prog in progs:  # the first epoch makes the optimizer's table
        prog.run(t, t._epoch, t._lr)
    calls = []

    def refuse(name):
        def raise_(*args, **kwargs):
            calls.append(name)
            raise AssertionError(f"{name} inside an epoch")
        return raise_

    with monkeypatch.context() as m:
        for owner, name in _HOST:
            m.setattr(owner, name, refuse(name))
        t._epoch.fill_(1)
        for prog in progs:
            prog.run(t, t._epoch, t._lr)
    assert not calls
    assert np.isfinite([float(v) for v in progs[0].sums.values()]).all()


def test_program_refuses_another_state_or_data():
    t = _trainer("v1", 32, block=False)
    x, xv = (t.prepare_data(a) for a in _data(100, 40, seed=7))
    state = t.init_state()
    prog = t._get_epoch_graph(100, True, state, x)
    assert t._get_epoch_graph(100, True, state, x) is prog
    with pytest.raises(RuntimeError, match="another train state or data"):
        t._get_epoch_graph(100, True, t.init_state(), x)
    with pytest.raises(RuntimeError, match="another train state or data"):
        t._get_epoch_graph(100, True, state, x.clone())
    state.rng = state.rng.clone()  # the same state, its key rebound
    with pytest.raises(RuntimeError, match="another train state or data"):
        t._get_epoch_graph(100, True, state, x)
    t.drop_epoch_programs()
    assert t._epoch_fns == {}
    assert t._get_epoch_graph(100, True, state, x) is not prog


def _programmed(monkeypatch):
    """``train`` through the epoch programs on the CPU: the graphed path
    with each program's epochs run eagerly (its capture needs a card)."""
    built = []

    def graphed_epoch(self, state, data, n, train):
        prog = self._get_epoch_graph(n, train, state, data)
        if prog not in built:
            built.append(prog)
        return prog.run(self, self._epoch, self._lr)

    monkeypatch.setattr(T.VAETrainer, "_graphed", lambda self: True)
    monkeypatch.setattr(T.VAETrainer, "graphed_epoch", graphed_epoch)
    return built


def test_training_from_a_loaded_state_builds_new_programs(tmp_path, monkeypatch):
    """Three epochs straight, against a run that crashes after epoch 2 and
    is resumed in the same trainer (whose programs were built for the state
    it trained) from the epoch-1 train-state file: the programs are built
    anew for the loaded state, and the run ends bit-equal to the straight
    one, histories included."""
    x, xv = _data(100, 40, seed=8)
    straight = _trainer("v2", 32, block=False)
    straight.train(x, xv)
    built = _programmed(monkeypatch)
    t = _trainer("v2", 32, block=False)

    def crash(epoch, tr, vl):
        if epoch == 1:
            raise RuntimeError("crash")

    with pytest.raises(RuntimeError, match="crash"):
        t.train(x, xv, progress_cb=crash,
                checkpoint_path=str(tmp_path / "s_{epoch}.npz"),
                checkpoint_every=1)
    old = built[0].state
    assert len(built) == 2 and all(p.state is old for p in built)
    state, start = t.resume_from(str(tmp_path / "s_1.npz"))
    assert start == 1 and state is not old
    t.train(x, xv, state=state, start_epoch=start)
    assert len(built) == 4 and all(p.state is state for p in built[2:])
    assert all(p.state is state for p in t._epoch_fns.values())
    assert t.train_losses == straight.train_losses
    assert t.val_losses == straight.val_losses
    _assert_same_state(straight.final_state, t.final_state)


def test_gather_writes_into_a_given_buffer():
    x = torch.randn(64, 5)
    idx = torch.tensor([3, 0, 7, 1])
    out = torch.empty(32, 5)
    got = K.gather_row_blocks(x, idx, out=out)
    assert got is out
    assert torch.equal(out, K.gather_row_blocks(x, idx))
    with pytest.raises(ValueError, match="expected a contiguous"):
        K.gather_row_blocks(x, idx, out=torch.empty(32, 4))
    with pytest.raises(ValueError, match="expected a contiguous"):
        K.gather_row_blocks(x, idx, out=torch.empty(5, 32).t())


@pytest.mark.parametrize("block", [False, True])
def test_epoch_averages_are_divided_by_a_tensor(block, monkeypatch):
    """Every loss average an epoch reports, eager (``run_epoch``) and
    programmed (``EpochProgram.run``), training and validation, is the
    output of ``ops/losses.py::_div`` by the set's size: one float32
    quotient rounded once (on a card, a division by a Python number is a
    product with its reciprocal), equal here to the host's correctly
    rounded quotient of the same sum."""
    n, batch = SHAPES[block]
    t = _trainer("v3", batch, block)
    names = t.spec.component_names()
    x, xv = (t.prepare_data(a) for a in _data(n, 40, seed=9))
    eager, graphed = t.init_state(), t.init_state()
    progs = dict(zip((n, 40), _programs(t, graphed, x, xv)))
    calls, div = [], L._div

    def spy(num, d):
        out = div(num, d)
        calls.append((num, d, out))
        return out

    monkeypatch.setattr(L, "_div", spy)
    t._lr.fill_(1e-3)
    for epoch in range(2):
        t._epoch.fill_(epoch)
        for rows, data, train in ((n, x, True), (40, xv, False)):
            for way in ("eager", "program"):
                calls.clear()
                avg = (t.run_epoch(eager, data, rows, epoch, t._lr, train)
                       if way == "eager" else progs[rows].run(t, t._epoch, t._lr))
                quotients = [(num, out) for num, d, out in calls if d == rows]
                assert len(quotients) == len(names), (way, train)
                for k, (num, out) in zip(names, quotients):
                    assert torch.equal(avg[k], out), (way, train, k)
                    want = np.float32(np.float64(float(num)) / rows)
                    assert _bits(float(out)) == _bits(want), (way, train, k)
