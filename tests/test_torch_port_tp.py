"""The port's gene-axis tensor parallelism on gloo ranks (CPU), held to the
JAX package's one-process trainer: the counterpart of the ``tp`` case of
tests/test_multiprocess.py::test_two_process_dp_training_matches_single_process
(its worker, tests/_mp_worker.py: D = 70, hidden 16, latent 4, batch 8,
44 training and 13 validation rows, 2 epochs).

Grids of data 1 x model 2 (two ranks) and data 2 x model 2 (four ranks;
the model axis varies fastest). The padded gene axis of 128 splits into
two slices of 64 genes: each rank holds its slice of ``encoder/0/w``'s
rows, ``decoder/3/w``'s columns, ``decoder/3/b`` and their moments, every
other leaf whole, and its share of the rows (44 / data) of its 64
columns. v0 holds the encoder's model-axis sum, the output layer and BCE
on the slices and the KL term counted once; v3 adds the gene abundance
(the slices' per-gene sums) and the L1 term (the slices on every model
rank, the other leaves once). Tolerances are the JAX contract's, rtol 2e-4
/ atol 1e-5 (tests/test_multiprocess.py:92-96), on the totals that
``train()`` returns; each component also with the atol of the port's
trainer test for the small, noisy KL term (tests/test_torch_port_dp.py).

The traps are wrong implementations patched into the worker; each must
miss the JAX reference by more than the tolerance. The first encoder
layer's bias added before the model-axis sum is removed again by the
BatchNorm that follows in training, and the bias starts at 0 and gets
only rounding noise as its gradient (a pre-BatchNorm bias), so that trap
runs from a state whose bias is 0.5 in both packages: the running means,
and through them validation, then see the bias twice.
"""

import functools

import numpy as np
import pytest
import torch

from genome_minimizer_2_torch.core import prng as tprng
from genome_minimizer_2_torch.eval import metrics as TM
from genome_minimizer_2_torch.parallel import mesh as tmesh
from genome_minimizer_2_torch.train import trainer as TT
from genome_minimizer_2_torch.utils.config import ExperimentConfig
from genome_minimizer_2_tpu.train import trainer as JT
from genome_minimizer_2_tpu.utils import checkpoint as jckpt
from genome_minimizer_2_tpu.utils.config import ExperimentConfig as JConfig
from tests import test_torch_port_dp as dp
from tests.test_torch_port_bringup import run_two

D, DP = 70, 128
WORKER = dp.REPO / "tests" / "_torch_mp_tp_worker.py"
RTOL, ATOL = dp.RTOL, dp.ATOL
BIAS = 0.5
SLICED = {"encoder/0/w": [64, 16], "decoder/3/w": [16, 64], "decoder/3/b": [64]}
TRAPS = {"bias": "v0", "kl": "v0", "l1": "v3", "norm": "v0"}


def _test_rows():
    return np.random.RandomState(1).rand(9, D).round().astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_reference(version: str, bias: float = 0.0) -> tuple:
    """The JAX package's one-process trainer, from its initial state with
    ``encoder/0/b`` set to ``bias``: (train_losses, val_losses)."""
    if not bias:
        return dp.jax_reference(version)
    import jax.numpy as jnp

    cfg = JConfig(hidden_dim=16, latent_dim=4, n_epochs=2, batch_size=8,
                  trainer_version=version, print_every=1000)
    t = JT.create_trainer(version, cfg, input_dim=D)
    state = t.init_state()
    state.params["encoder"][0]["b"] = jnp.full((16,), bias, jnp.float32)
    t.train(*dp._data(), state=state)
    return t.train_losses, t.val_losses


@functools.lru_cache(maxsize=None)
def port_one_process(version: str):
    """The port's one-process trainer: (its final model, flat params)."""
    cfg = ExperimentConfig(hidden_dim=16, latent_dim=4, n_epochs=2,
                           batch_size=8, trainer_version=version,
                           print_every=1000)
    t = TT.create_trainer(version, cfg, D, device="cpu")
    t.train(*dp._data())
    model = t.final_state.model
    return model, {k: v.detach().numpy() for k, v in model.flat_params().items()}


def run_ranks(world: int, spec: dict) -> list:
    return dp.run_ranks(world, spec, worker=WORKER)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every training run of this file, one launch of the ranks per grid:
    ``tp_runs(world)`` -> (the ranks' JSON, checkpoint dirs by version)."""
    cache = {}

    def get(world):
        if world not in cache:
            data, dirs, runs = world // 2, {}, []
            for v in ("v0", "v3"):
                dirs[v] = tmp_path_factory.mktemp(f"tp_{v}_{world}")
                runs.append({"label": v, "version": v, "data": data,
                             "model": 2, "ckpt": str(dirs[v])})
            if world == 2:
                runs.append({"label": "v0_bias", "version": "v0", "data": 1,
                             "model": 2, "bias": BIAS})
                runs += [{"label": t, "version": v, "data": 1, "model": 2,
                          "trap": t, "bias": BIAS if t == "bias" else 0.0}
                         for t, v in TRAPS.items()]
            cache[world] = run_ranks(world, {"runs": runs}), dirs
        return cache[world]

    return get


GRIDS = [("v0", 2), ("v3", 2), ("v0", 4), ("v3", 4)]


@pytest.mark.parametrize("version,world", GRIDS)
def test_tensor_parallel_training_matches_jax(version, world, tp_runs):
    outs, _ = tp_runs(world)
    data = world // 2
    for r, o in enumerate(outs):
        run = o[version]
        assert run["train"] == outs[0][version]["train"], r
        assert run["val"] == outs[0][version]["val"], r
        # rank r: data index r // 2, model index r % 2
        assert run["grid"] == [r // 2, data, r % 2, 2]
        assert run["genes"] == [64 * (r % 2), 64 * (r % 2 + 1)]
        assert run["counter"] == 2 * (6 + 2)  # 6 train + 2 val steps
    dp.assert_close(outs[0][version], jax_reference(version),
                    f"{version} at {data} x 2 vs JAX")


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_holds_its_slice_and_rows(world, tp_runs):
    outs, _ = tp_runs(world)
    full = {k: list(v.shape) for k, v in port_one_process("v0")[0]
            .flat_params().items()}
    want = {k: SLICED.get(k, s) for k, s in full.items()}
    assert {k: full[k] for k in SLICED} == {"encoder/0/w": [DP, 16],
                                           "decoder/3/w": [16, DP],
                                           "decoder/3/b": [DP]}
    for o in outs:
        for v in ("v0", "v3"):
            assert o[v]["held"] == want and o[v]["moments"] == want
            # its share of the 44 rows, its 64 of the padded columns
            assert o[v]["rows"] == [44 // (world // 2), 64]


PRE_BN = {f"{t}/{i}/b" for t in ("encoder", "decoder") for i in range(3)}


@pytest.mark.parametrize("version,world", GRIDS)
def test_checkpoint_is_full_and_equals_one_process(version, world, tp_runs):
    """Rank 0 alone writes; the file holds full leaves in the JAX layout,
    equal to the ranks' slices put together, loads in the JAX package,
    and equals a one-process port run. Every leaf is held to the JAX
    contract's rtol 2e-4 / atol 1e-5 but those whose gradient is zero in
    exact arithmetic, which Adam turns from rounding noise into steps of
    up to lr (tests/test_torch_train_trainer.py): the Linear biases ahead
    of a BatchNorm, held to |p| <= 3 lr x steps in both runs as there, and
    at v0 the mean head's bias through epoch 1 (beta 0: the decoder's
    BatchNorm removes a shift common to all rows), held to 3 lr x that
    epoch's steps of the one-process value; the running statistics follow
    the pre-BatchNorm biases and take 3 lr x steps as their atol."""
    outs, dirs = tp_runs(world)
    assert outs[0][version]["wrote"] == ["tp_1.npz", "tp_2.npz", "model.npz"]
    assert all(o[version]["wrote"] == [] for o in outs[1:])
    params, stats, _, extra = jckpt.load_checkpoint(dirs[version] / "model.npz")
    model, one = port_one_process(version)
    assert sorted(params) == sorted(one) and extra["input_dim"] == D
    for k in SLICED:  # the model axis's slices, in gene order
        dim = tmesh.gene_dim(k)
        whole = np.concatenate([np.asarray(o[version]["slices"][k], np.float32)
                                for o in outs[:2]], axis=dim)
        np.testing.assert_array_equal(params[k], whole, err_msg=k)
    lr, steps = 1e-3, 2 * 6
    for k, v in one.items():
        if k in PRE_BN:
            assert np.abs(params[k]).max() <= 3 * lr * steps, k
            assert np.abs(v).max() <= 3 * lr * steps, k
        elif k == "mean/b" and version == "v0":
            np.testing.assert_allclose(params[k], v, rtol=0, atol=3 * lr * 6)
        else:
            np.testing.assert_allclose(params[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    for k, v in model.flat_stats().items():
        np.testing.assert_allclose(stats[k], v.numpy(), rtol=RTOL,
                                   atol=3 * lr * steps, err_msg=k)
    with np.load(dirs[version] / "tp_2.npz") as state:
        for k in SLICED:
            np.testing.assert_array_equal(state["params/" + k], params[k])
            for m in ("opt_state/1/.mu/", "opt_state/1/.nu/"):
                assert state[m + k].shape == one[k].shape, m + k


def _one_process_decode(path):
    """F1, accuracy, bits and logits of a one-process decode of a
    checkpoint's parameters (the test rows, the workers' key)."""
    from genome_minimizer_2_torch.models import vae

    params, stats, _, _ = jckpt.load_checkpoint(path)
    model = vae.params_from_flat(params, stats, vae.VAEConfig(D, 16, 4),
                                 device="cpu")
    key, x = tprng.key(1, "cpu"), _test_rows()
    f1, acc, _, _ = TM.calculate_reconstruction_metrics(model, x, key,
                                                        batch_size=8)
    bits = TM.reconstruct_binary(model, x, key, batch_size=8)
    with torch.no_grad():
        logits = torch.cat([model.forward(model.gene_columns(torch.from_numpy(
            x[lo: lo + 8])), tprng.fold_in(key, i), False)[0][:, :D]
            for i, lo in enumerate(range(0, len(x), 8))])
    breakdown = TM.calculate_reconstruction_loss_breakdown(model, x, key, 8)
    return f1, acc, bits, logits.numpy(), breakdown


@pytest.mark.parametrize("version,world", GRIDS)
def test_test_set_metrics_equal_one_process(version, world, tp_runs):
    """Every rank decodes its gene slice of the test rows and gathers the
    packed bytes: the bits, F1 and accuracy equal a one-process decode of
    the same (gathered) parameters, where a bit may differ only at a logit
    within 1e-4 of 0 (the first layer's sum over the slices is another
    order of float32 additions); the loss breakdown, the slices' BCE
    summed over the model axis, within the JAX contract's tolerance."""
    outs, dirs = tp_runs(world)
    f1, acc, bits, logits, breakdown = _one_process_decode(
        dirs[version] / "model.npz")
    for o in outs:
        assert o[version]["bits"] == outs[0][version]["bits"]
    got = outs[0][version]
    differ = np.asarray(got["bits"]) != bits
    assert not (differ & (np.abs(logits) >= 1e-4)).any()
    if not differ.any():
        assert (got["f1"], got["accuracy"]) == (f1, acc)
    for k, v in breakdown.items():
        np.testing.assert_allclose(got["breakdown"][k], v, rtol=RTOL, atol=ATOL)


def test_a_nonzero_first_layer_bias_matches_jax(tp_runs):
    """From a state whose ``encoder/0/b`` is 0.5 in both packages: the bias
    is added once, after the model-axis sum."""
    outs, _ = tp_runs(2)
    dp.assert_close(outs[0]["v0_bias"], jax_reference("v0", BIAS),
                    "v0 from encoder/0/b = 0.5 vs JAX")




@functools.lru_cache(maxsize=None)
def one_process_step(version: str, bias: float = 0.0) -> dict:
    """The workers' first step on one process: the first 8 training rows
    from the initial state (``encoder/0/b`` = ``bias``)."""
    from genome_minimizer_2_torch.ops import losses as TL
    from genome_minimizer_2_torch.ops import optimizer as TO

    cfg = ExperimentConfig(hidden_dim=16, latent_dim=4, n_epochs=2,
                           batch_size=8, trainer_version=version)
    t = TT.create_trainer(version, cfg, D, device="cpu")
    state = t.init_state()
    with torch.no_grad():
        state.model.encoder[0].b.fill_(bias)
    batch = t.prepare_data(dp._data()[0])[:8]
    comps, grads, _ = t.loss_and_grads(state, batch, 1, tprng.key(7, "cpu"))
    return {"loss": float(comps[TL.TOTAL].detach()),
            "norm": float(TO.global_norm(grads)),
            "grads": {k: g.numpy() for k, g in grads.items()}}


def step_gaps(got: dict, want: dict) -> dict:
    """Relative gaps of the loss, the norm and each leaf's gradient (in
    norm); the pre-BatchNorm biases' gradients, rounding noise, are left
    out."""
    gaps = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "norm": abs(got["norm"] - want["norm"]) / want["norm"]}
    for k, w in want["grads"].items():
        if k not in PRE_BN:
            g = np.asarray(got["grads"][k], np.float32)
            gaps[k] = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    return gaps


STEP_RTOL = 1e-5  # float32 sums in another order, one step, no Adam


@pytest.mark.parametrize("version,world", GRIDS)
def test_first_step_matches_one_process(version, world, tp_runs):
    """One global batch from the initial state: the loss, the global norm
    (the slices' squares summed over the model axis, every other leaf's
    counted once) and every leaf's summed gradient, gathered, against one
    process's on the same rows."""
    outs, _ = tp_runs(world)
    for o in outs:
        assert o[version]["step"] == outs[0][version]["step"]
    gaps = step_gaps(outs[0][version]["step"], one_process_step(version))
    assert max(gaps.values()) <= STEP_RTOL, gaps


@pytest.mark.parametrize("trap", sorted(TRAPS))
def test_tensor_parallel_checks_catch_a_wrong_implementation(trap, tp_runs):
    """Each trap misses the JAX histories or the one-process step by more
    than the tolerance. Adam is blind to a gradient scale common to every
    leaf, so the norm trap (a clip factor off by a nearly constant ratio)
    barely moves the histories: the step's norm catches it."""
    outs, _ = tp_runs(2)
    bias = BIAS if trap == "bias" else 0.0
    got = outs[0][trap]
    step = step_gaps(got["step"], one_process_step(TRAPS[trap], bias))
    assert (not dp.close(got, jax_reference(TRAPS[trap], bias))
            or max(step.values()) > STEP_RTOL), trap


def test_cli_training_and_experiment_with_model_parallel(tmp_path, monkeypatch):
    """``--mode experiment`` and ``--mode training`` with ``--model-parallel
    2`` through the CLI on two processes (torchrun's variables, gloo): the
    checkpoints hold full leaves, both packages read them, and the
    experiment's history equals a one-process CLI run's within the JAX
    contract's tolerance."""
    import json

    from genome_minimizer_2_torch import cli
    from genome_minimizer_2_torch.data import synthetic
    from genome_minimizer_2_torch.sample.sampler import load_sampler
    from genome_minimizer_2_torch.utils import checkpoint as tckpt

    info = synthetic.make_dataset_root(tmp_path / "root", n_samples=40,
                                       n_genes=120, genome_length=4000, seed=0)
    experiment = ("--mode experiment --device cpu --trainer-version v3 "
                  "--hidden-dim 16 --latent-dim 4 --batch-size 8 --n-epochs 2 "
                  "--no-generate-plots --checkpoint-every 1 --experiment-name {}")
    outs = run_two(info, experiment.format("tp2") + " --model-parallel 2",
                   "--mode training --device cpu --preset v0 --epochs 1 "
                   "--model-parallel 2 --data-parallel 0")
    assert all(out.count("PROCESS COMPLETED!") == 2 for out in outs)
    monkeypatch.setenv("GM2_ROOT", info["root"])
    assert cli.main(experiment.format("solo").split()) == 0
    models = tmp_path / "root" / "models" / "trained_models"
    for name, version in (("tp2", "v3"), ("solo", "v3"), ("v0_model", "v0")):
        path = models / name / f"saved_VAE_{version}.npz"
        params, _, config, extra = jckpt.load_checkpoint(path)
        assert params["decoder/3/w"].shape == (config.hidden_dim, 128), name
        assert params["encoder/0/w"].shape == (128, config.hidden_dim), name
        assert params["decoder/3/b"].shape == (128,), name
        assert tckpt.load_checkpoint(path)[0].keys() == params.keys()
        assert extra["input_dim"] == 120
        load_sampler(str(path), device="cpu")
        if name != "solo":
            assert config.model_parallel == 2, name
    hist = {}
    for name in ("tp2", "solo"):
        with np.load(models / name / "train_state_2.npz") as z:
            extra = json.loads(bytes(z["__config_json__"]).decode())["extra"]
        hist[name] = (extra["train_losses"]["total"], extra["val_losses"]["total"])
    for a, b in zip(hist["tp2"], hist["solo"]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
