"""Elastic restarts in the port (``utils/elastic.py``), held to the JAX
package's: the three cases of tests/test_elastic.py for the port, the
port's restarted run against the JAX package's restarted run, the runner
with ``max_restarts``, and the multi-process crash drill of
tests/test_multiprocess.py::test_crash_restart_drill on gloo ranks.

A restarted run resumes bit-exactly, so it must equal the uninterrupted
run bit for bit; against JAX it is held at the trainer-parity tolerances
of tests/test_torch_train_trainer.py (loss histories rtol 1e-4; validation
also atol 5e-3).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from genome_minimizer_2_torch.train import trainer as TT
from genome_minimizer_2_torch.utils import checkpoint as tckpt
from genome_minimizer_2_torch.utils import elastic as TE
from genome_minimizer_2_torch.utils.config import ExperimentConfig as TConfig
from genome_minimizer_2_tpu.train import trainer as JT
from genome_minimizer_2_tpu.utils import elastic as JE
from genome_minimizer_2_tpu.utils.config import ExperimentConfig as JConfig
from tests.test_torch_port_dp import free_port

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mp_elastic_worker.py"
D = 33


def _cfg(make, **kw):
    cfg = make(hidden_dim=12, latent_dim=3, n_epochs=8, batch_size=6,
               trainer_version="v2", print_every=1000, patience=100)
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _data():
    rng = np.random.RandomState(0)
    return (rng.rand(20, D).round().astype(np.float32),
            rng.rand(9, D).round().astype(np.float32))


def _crash_once_at(trainer, epoch_index, train_fn):
    """Make ``trainer.train`` raise once from its progress callback at
    ``epoch_index`` (after the previous epochs' checkpoints exist)."""
    crashed = []

    def boom(epoch, tr, vl):
        if epoch == epoch_index and not crashed:
            crashed.append(epoch)
            raise RuntimeError("injected host failure")

    def train(*args, **kwargs):
        kwargs["progress_cb"] = boom
        return train_fn(trainer, *args, **kwargs)

    trainer.train = train
    return crashed


def test_latest_checkpoint_selection(tmp_path):
    pat = str(tmp_path / "state_{epoch}.npz")
    assert TE.latest_checkpoint(pat) is None
    for ep in (2, 10, 6):
        (tmp_path / f"state_{ep}.npz").write_bytes(b"x")
    (tmp_path / "state_99.npz.tmp").write_bytes(b"x")  # in-flight: ignored
    (tmp_path / "other_3.npz").write_bytes(b"x")       # different template
    assert TE.latest_checkpoint(pat) == str(tmp_path / "state_10.npz")


def test_crash_and_restart_matches_uninterrupted(tmp_path):
    train_x, val_x = _data()
    straight = TT.create_trainer("v2", _cfg(TConfig), D, device="cpu")
    tl_ref, vl_ref, _ = straight.train(train_x, val_x)

    crashy = TT.create_trainer("v2", _cfg(TConfig), D, device="cpu")
    crashed = _crash_once_at(crashy, 5, TT.VAETrainer.train)
    tl, vl, epochs, restarts = TE.train_with_restarts(
        crashy, train_x, val_x, checkpoint_path=str(tmp_path / "st_{epoch}.npz"),
        checkpoint_every=2, max_restarts=2)
    assert crashed == [5] and restarts == 1 and epochs == 8
    assert tl == tl_ref and vl == vl_ref  # bit for bit
    for k, v in crashy.final_state.model.flat_params().items():
        assert v.detach().numpy().tobytes() == \
            straight.final_state.model.flat_params()[k].detach().numpy().tobytes(), k

    # the JAX package's restarted run, with the same crash
    jt = JT.create_trainer("v2", _cfg(JConfig), input_dim=D)
    _crash_once_at(jt, 5, JT.VAETrainer.train)
    jtl, jvl, jepochs, jrestarts = JE.train_with_restarts(
        jt, train_x, val_x, checkpoint_path=str(tmp_path / "jst_{epoch}.npz"),
        checkpoint_every=2, max_restarts=2)
    assert (jepochs, jrestarts) == (epochs, restarts)
    np.testing.assert_allclose(tl, jtl, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(vl, jvl, rtol=1e-4, atol=5e-3)


def test_gives_up_after_max_restarts(tmp_path):
    train_x, val_x = _data()
    tr = TT.create_trainer("v2", _cfg(TConfig, n_epochs=3), D, device="cpu")

    def always_boom(*a, **k):
        raise RuntimeError("permanent failure")

    tr.train = always_boom
    with pytest.raises(RuntimeError, match="permanent failure"):
        TE.train_with_restarts(tr, train_x, val_x,
                               checkpoint_path=str(tmp_path / "s_{epoch}.npz"),
                               max_restarts=2)


def test_runner_restarts_with_max_restarts(tmp_path, monkeypatch):
    """``max_restarts`` with ``checkpoint_every``: the runner trains through
    the restart loop; a crash after the epoch-1 checkpoint ends in the
    uninterrupted run's histories and model."""
    from genome_minimizer_2_torch.data import synthetic
    from genome_minimizer_2_torch.experiments import IntegratedExperimentRunner

    info = synthetic.make_dataset_root(tmp_path / "root", n_samples=50,
                                       n_genes=130, genome_length=4000, seed=0)
    monkeypatch.setenv("GM2_ROOT", info["root"])
    monkeypatch.delenv("GM2_PROFILE_DIR", raising=False)
    results = {}
    for name, crash in (("straight", False), ("crashy", True)):
        cfg = _cfg(TConfig, n_epochs=3, batch_size=8, hidden_dim=16,
                   latent_dim=4, checkpoint_every=1, max_restarts=1,
                   experiment_name=name, calculate_metrics=False,
                   explore_latent_space=False, generate_plots=False)
        runner = IntegratedExperimentRunner(cfg, device="cpu")
        runner.prep_data()
        runner.setup_model_and_training()
        crashed = (_crash_once_at(runner.trainer, 1, TT.VAETrainer.train)
                   if crash else [])
        runner.train_model()
        results[name] = (runner.results, crashed)
    (straight, _), (crashy, crashed) = results["straight"], results["crashy"]
    assert crashed == [1] and crashy["restarts"] == 1 and straight["restarts"] == 0
    assert crashy["train_loss_vals"] == straight["train_loss_vals"]
    assert crashy["val_loss_vals"] == straight["val_loss_vals"]
    p_a = tckpt.load_checkpoint(straight["model_path"])[0]
    p_b = tckpt.load_checkpoint(crashy["model_path"])[0]
    assert all(np.array_equal(p_a[k], p_b[k]) for k in p_a)


def _launch(shared_dir, crash_epoch):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    port = free_port()
    return [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", str(port), str(shared_dir),
         str(crash_epoch)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]


def _finish(procs, what):
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"{what}: rank {r}:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_crash_restart_drill(tmp_path):
    """Rank 1 of a 2-rank gloo group dies mid-train (os._exit between an
    epoch's compute and its checkpoint); the supervisor (this test) kills
    the survivor and relaunches both on a fresh port; they resume from the
    shared atomic checkpoint and end with the uninterrupted run's
    histories and parameters, bit for bit."""
    ref_dir, crash_dir = tmp_path / "ref", tmp_path / "crash"
    ref_dir.mkdir()
    crash_dir.mkdir()
    ref = _finish(_launch(ref_dir, -1), "reference")
    assert ref[0]["epochs"] == 4 and ref[0]["train"] == ref[1]["train"]

    procs = _launch(crash_dir, 2)
    try:
        assert procs[1].wait(timeout=240) == 17  # the injected death
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    assert (crash_dir / "es_1.npz").exists() and (crash_dir / "es_2.npz").exists()

    outs = _finish(_launch(crash_dir, -1), "relaunch")
    for o in outs:
        assert o["resumed_from"] in (2, 3), o["resumed_from"]
        assert o["epochs"] == 4
        assert o["train"] == ref[0]["train"] and o["val"] == ref[0]["val"]
    p_ref, s_ref, _, _ = tckpt.load_checkpoint(ref_dir / "es_4.npz")
    p_res, s_res, _, _ = tckpt.load_checkpoint(crash_dir / "es_4.npz")
    assert sorted(p_ref) == sorted(p_res)
    for k in p_ref:
        np.testing.assert_array_equal(p_ref[k], p_res[k])
    for k in s_ref:
        np.testing.assert_array_equal(s_ref[k], s_res[k])


@pytest.mark.parametrize("world", [2, 4])
def test_restart_under_tensor_parallelism_is_bit_equal(world, tmp_path):
    """On a grid of data x model 2 gloo ranks (tests/_torch_mp_tp_worker.py,
    v3 for 3 epochs): every rank crashes after the epoch-1 checkpoint and
    ``train_with_restarts`` (``max_restarts`` 1, ``checkpoint_every`` 1)
    resumes each rank's gene slice from the full leaves rank 0 wrote; the
    histories, the parameters and the moments each rank holds are
    bit-equal to the uninterrupted run's."""
    from tests.test_torch_port_tp import run_ranks

    outs = run_ranks(world, {"runs": [{
        "label": "restart", "version": "v3", "data": world // 2, "model": 2,
        "epochs": 3, "restart": str(tmp_path)}]})
    for o in outs:
        got = o["restart"]
        assert got["restarts"] == [0, 1] and got["crashed"] == [1]
        assert got["same_history"] and got["different_leaves"] == []
        assert got["held"]["p/encoder/0/w"] == [64, 16]
        assert got["held"]["nu/decoder/3/w"] == [16, 64]
        assert got["train"] == outs[0]["restart"]["train"]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"{n}_{e}.npz" for n in ("crashed", "straight")
                     for e in (1, 2, 3)]
    with np.load(tmp_path / "crashed_3.npz") as z:
        assert z["params/encoder/0/w"].shape == (128, 16)
