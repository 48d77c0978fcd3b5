"""The port's VAETrainer against the JAX package's on the CPU at float32,
both from one seed and one numpy dataset: three epochs with a remainder
batch, on the exact row-permutation branch (v0-v3) and on the 8-row block
shuffle (the JAX trainer's TPU branch, taken by monkeypatching its
``_mesh_platform``; the port's CUDA branch, taken by monkeypatching its
``_platform``, with the gather's plain version on CPU tensors); train-state
files resumed across the packages; and the CLI's experiment and training
modes on a tiny synthetic dataset.

Tolerances: per-epoch loss histories rtol 1e-4 (float32 sums in another
order, through three epochs of Adam), validation ones also atol 5e-3 (eval
BatchNorm reads running means that carry the pre-BatchNorm biases' noise,
below; it shows in the small KL term). Parameters: each leaf's distance
from JAX's, over the distance JAX's moved from the common initialization,
at most 1e-3 for v1-v3 and 5e-2 for v0. Adam divides every moment by the
root of the second one, so a value whose gradient is near zero turns
rounding differences into steps of up to lr; v1-v3's L1 term gives every
value a gradient of at least lambda, v0 has none and so the looser bound.
The Linear biases ahead of a BatchNorm have a zero gradient in exact
arithmetic and are held to |p| <= 3 lr x steps in both packages instead;
the BatchNorm running statistics, which follow them, to that bound plus
the leaves' relative one.
"""

import jax
import numpy as np
import pytest

from genome_minimizer_2_torch.train import trainer as TT
from genome_minimizer_2_torch.utils.config import get_preset_config as t_preset
from genome_minimizer_2_tpu.train import trainer as JT
from genome_minimizer_2_tpu.utils import checkpoint as jckpt
from genome_minimizer_2_tpu.utils.config import get_preset_config as j_preset

D = 300
PRE_BN = {f"{t}/{i}/b" for t in ("encoder", "decoder") for i in range(3)}


def _data(n, nv, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.1, 0.9, D)
    return ((rng.rand(n, D) < p).astype(np.float32),
            (rng.rand(nv, D) < p).astype(np.float32))


def _configs(version, batch, epochs=3):
    out = []
    for make in (j_preset, t_preset):
        c = make(version)
        c.hidden_dim, c.latent_dim, c.n_epochs = 32, 8, epochs
        c.batch_size, c.print_every, c.seed = batch, 1000, 7
        out.append(c)
    return out


def _trainers(version, batch, block, epochs=3):
    jc, tc = _configs(version, batch, epochs)
    jt = JT.create_trainer(version, jc, D)
    tt = TT.create_trainer(version, tc, D, device="cpu")
    if block:
        jt._mesh_platform = lambda: "tpu"
        tt._platform = lambda: "cuda"
    return jt, tt


def _assert_same_run(jt, tt, steps):
    for k in jt.train_losses:
        np.testing.assert_allclose(tt.train_losses[k], jt.train_losses[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(tt.val_losses[k], jt.val_losses[k],
                                   rtol=1e-4, atol=5e-3, err_msg=k)
    js, ts = jt.final_state, tt.final_state
    assert int(ts.counter) == int(js.counter)
    np.testing.assert_array_equal(
        ts.rng.numpy(), np.asarray(jax.random.key_data(js.rng)).astype(np.int64))
    assert tt.early_stopping.epochs_no_improve == jt.early_stopping.epochs_no_improve
    np.testing.assert_allclose(tt.early_stopping.best_loss,
                               jt.early_stopping.best_loss, rtol=1e-4)
    want = jckpt._flatten(js.params, "")
    init = tt.init_state().model.flat_params()  # bit-equal to JAX's init
    lr = jt.config.learning_rate
    upd_rtol = 5e-2 if tt.spec.lambda_l1 == 0.0 else 1e-3
    for k, v in ts.model.flat_params().items():
        got = v.detach().numpy()
        if k in PRE_BN:
            assert np.abs(got).max() <= 3 * lr * steps, k
            assert np.abs(want[k]).max() <= 3 * lr * steps, k
        else:
            moved = want[k] - init[k].detach().numpy()
            err = np.linalg.norm(got - want[k]) / max(np.linalg.norm(moved), 1e-12)
            assert err <= upd_rtol, (k, err)
    wstats = jckpt._flatten(js.batch_stats, "")
    for k, v in ts.model.flat_stats().items():
        # running means follow the pre-BatchNorm biases
        np.testing.assert_allclose(v.numpy(), wstats[k], rtol=upd_rtol,
                                   atol=3 * lr * steps, err_msg=k)


@pytest.mark.parametrize("version", ["v0", "v1", "v2", "v3"])
def test_three_epochs_match_jax_row_permutation(version):
    x, xv = _data(100, 40)  # 3 batches of 32 + a remainder of 4
    jt, tt = _trainers(version, 32, block=False)
    jl = jt.train(x, xv)
    tl = tt.train(x, xv)
    assert tl[2] == jl[2] == 3
    _assert_same_run(jt, tt, steps=3 * 4)


@pytest.mark.parametrize("version", ["v0", "v3"])
def test_three_epochs_match_jax_block_shuffle(version, monkeypatch):
    from genome_minimizer_2_torch.ops import kernels as K

    x, xv = _data(520, 24, seed=1)  # 2 batches of 256 + 8; 65 blocks of 8
    jt, tt = _trainers(version, 256, block=True)
    assert tt._use_block_shuffle(520) and not tt._use_block_shuffle(516)
    calls = []
    real = K.gather_row_blocks
    monkeypatch.setattr(K, "gather_row_blocks",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    jt.train(x, xv)
    tt.train(x, xv)
    assert len(calls) == 3  # one shuffle per train epoch
    _assert_same_run(jt, tt, steps=3 * 3)


def _resumed(trainer, path, x, xv):
    state, start = trainer.resume_from(str(path))
    trainer.train(x, xv, state=state, start_epoch=start)
    return trainer


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_train_state_resumes_across_packages(writer, tmp_path):
    """Two epochs with a train-state file after each; the epoch-1 file,
    written by one package, resumed for epochs 2-3 by both. The two resumed
    runs agree as three-epoch runs do."""
    x, xv = _data(100, 40, seed=2)
    jt, tt = _trainers("v2", 32, block=False, epochs=2)
    first = jt if writer == "jax" else tt
    first.train(x, xv, checkpoint_path=str(tmp_path / "s_{epoch}.npz"),
                checkpoint_every=1)
    path = tmp_path / "s_1.npz"
    jt2, tt2 = _trainers("v2", 32, block=False, epochs=3)
    _resumed(jt2, path, x, xv)
    _resumed(tt2, path, x, xv)
    assert len(tt2.train_losses["total"]) == len(jt2.train_losses["total"]) == 3
    _assert_same_run(jt2, tt2, steps=3 * 4)


def test_port_train_state_file_has_the_jax_layout(tmp_path):
    x, xv = _data(40, 8, seed=3)
    _, tt = _trainers("v0", 16, block=False, epochs=1)
    tt.train(x, xv, checkpoint_path=str(tmp_path / "t_{epoch}.npz"),
             checkpoint_every=1)
    jt, _ = _trainers("v0", 16, block=False, epochs=1)
    jax_file = tmp_path / "j.npz"
    jckpt.save_train_state(jax_file, jt.init_state(), jt.config, 0)
    with np.load(tmp_path / "t_1.npz") as a, np.load(jax_file) as b:
        assert set(a.files) == set(b.files)
        for k in b.files:
            if k != "__config_json__":
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


def test_data_parallel_raises_with_its_roadmap_item():
    """A model axis that does not divide the group's size W (1 without a
    group) is refused, naming the sizes that would; so is a data axis
    other than W / model."""
    _, tc = _configs("v0", 16)
    tc.model_parallel = 2
    with pytest.raises(ValueError, match=r"must divide the process group's "
                                         r"1 process\(es\); divisors: \[1\]"):
        TT.create_trainer("v0", tc, D, device="cpu")
    tc.model_parallel, tc.data_parallel = 1, 2
    with pytest.raises(ValueError, match="pass 0 or 1"):
        TT.create_trainer("v0", tc, D, device="cpu")


def test_data_parallel_zero_is_the_group_size_one_process():
    """``--data-parallel 0`` means the whole group: one process without a
    group is W = 1, and trains as data_parallel=1 does, bit for bit."""
    x, xv = _data(40, 8, seed=4)
    runs = []
    for dp in (0, 1):
        _, tc = _configs("v1", 16, epochs=2)
        tc.data_parallel = dp
        tt = TT.create_trainer("v1", tc, D, device="cpu")
        assert tt.grid is None
        runs.append(tt.train(x, xv))
    assert runs[0] == runs[1]


def _synthetic_root(tmp_path, monkeypatch):
    from genome_minimizer_2_torch.data import synthetic

    info = synthetic.make_dataset_root(tmp_path / "root", n_samples=50,
                                       n_genes=130, genome_length=4000, seed=0)
    monkeypatch.setenv("GM2_ROOT", info["root"])
    return info


def test_cli_experiment_on_cpu_writes_a_checkpoint_both_packages_read(
        tmp_path, monkeypatch):
    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.core import prng
    from genome_minimizer_2_torch.sample.sampler import load_sampler

    info = _synthetic_root(tmp_path, monkeypatch)
    rc = cli.main(["--mode", "experiment", "--device", "cpu",
                   "--trainer-version", "v1", "--hidden-dim", "16",
                   "--latent-dim", "4", "--batch-size", "8", "--n-epochs", "2",
                   "--experiment-name", "tiny", "--no-generate-plots"])
    assert rc == 0
    path = tmp_path / "root" / "models" / "trained_models" / "tiny" / "saved_VAE_v1.npz"
    params, stats, config, extra = jckpt.load_checkpoint(path)
    assert extra["input_dim"] == 130 and extra["epochs_trained"] == 2
    assert config.hidden_dim == 16 and params["decoder/3/w"].shape == (16, 256)
    sampler, _ = load_sampler(str(path), device="cpu")
    packed, z = sampler.sample_packed(prng.key(0, "cpu"), 9)
    assert packed.shape == (9, (130 + 7) // 8) and z.shape == (9, 4)
    assert info["root"]


def test_cli_training_mode_runs_the_preset(tmp_path, monkeypatch):
    from genome_minimizer_2_torch import cli

    _synthetic_root(tmp_path, monkeypatch)
    args = cli.parse_arguments(["--mode", "training", "--device", "cpu",
                                "--preset", "v0", "--epochs", "1"])
    results = cli.run_single_experiment(args)
    assert results["epochs_trained"] == 1
    assert np.isfinite(results["train_loss_vals"]).all()
    assert 0.0 <= results["f1_overall"] <= 1.0


@pytest.mark.parametrize("world,overrides,refusal", [
    (1, {"model_parallel": 2}, r"must divide the process group's 1 process"),
    (4, {"model_parallel": 3}, r"divisors: \[1, 2, 4\]"),
    (4, {"model_parallel": 2, "data_parallel": 1}, "pass 0 or 2"),
    # 300 genes unpadded do not split into 2 slices of whole bytes
    (2, {"model_parallel": 2, "pad_features": False},
     r"gene axis of 300 does not split into 2 slices .* would, dividing the "
     r"2 process\(es\): \[1\]")])
def test_runner_refuses_unported_options(world, overrides, refusal, monkeypatch):
    """The grids the runner refuses, before any group forms: a model axis
    that does not divide W, a data axis other than W / model, and gene
    slices that are not whole multiples of 8 genes (each names the sizes
    that would do)."""
    from genome_minimizer_2_torch.experiments import IntegratedExperimentRunner
    from genome_minimizer_2_torch.parallel import mesh

    monkeypatch.setattr(mesh, "rank_and_world", lambda: (0, world))
    _, tc = _configs("v0", 16)
    for field, value in overrides.items():
        setattr(tc, field, value)
    runner = IntegratedExperimentRunner(tc, device="cpu")
    runner.input_dim = D
    with pytest.raises(ValueError, match=refusal):
        runner.setup_model_and_training()


def _traced_runner(tmp_path, monkeypatch, profile_dir):
    from genome_minimizer_2_torch.experiments import IntegratedExperimentRunner

    _synthetic_root(tmp_path, monkeypatch)
    _, tc = _configs("v0", 8, epochs=1)
    tc.profile_dir = profile_dir
    tc.calculate_metrics = tc.explore_latent_space = tc.generate_plots = False
    runner = IntegratedExperimentRunner(tc, device="cpu")
    runner.prep_data()
    runner.setup_model_and_training()
    runner.train_model()
    return runner


def _trace_files(d):
    import json

    files = sorted(d.glob("gm2_rank0.*.pt.trace.json"))
    assert len(files) == 1, files
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    for phase in ("gm2/shuffle", "gm2/train_step", "gm2/validation",
                  "gm2/epoch_begin", "gm2/epoch_sync", "gm2/step/forward",
                  "gm2/step/loss", "gm2/step/loss/reconstruction",
                  "gm2/step/loss/kl", "gm2/step/backward", "gm2/step/clip_norm",
                  "gm2/step/update", "gm2/step/stats"):
        assert phase in names, phase
    return files


def test_runner_traces_training_into_profile_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("GM2_PROFILE_DIR", raising=False)
    _traced_runner(tmp_path, monkeypatch, str(tmp_path / "trace"))
    _trace_files(tmp_path / "trace")


def test_runner_honours_gm2_profile_dir(tmp_path, monkeypatch):
    """Queue 3 fault 1: with GM2_PROFILE_DIR set and no profile_dir, the
    JAX package traces training (utils/profiling.py:22); the port trained
    with no trace and no error. It now writes the trace there."""
    monkeypatch.setenv("GM2_PROFILE_DIR", str(tmp_path / "env_trace"))
    _traced_runner(tmp_path, monkeypatch, "")
    _trace_files(tmp_path / "env_trace")
