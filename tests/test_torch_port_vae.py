"""The port's VAE against the JAX package's at float32, from the same
parameters (carried with ``params_from_flat``), and checkpoint round trips
between the packages.

Tolerance: rtol 1e-5, atol 1e-5 on logits, hidden activations and means
(float32 matmuls summed in different orders by XLA and torch)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genome_minimizer_2_torch.models import vae as tvae
from genome_minimizer_2_torch.utils import checkpoint as tckpt
from genome_minimizer_2_torch.utils.config import get_v0_config as t_v0
from genome_minimizer_2_tpu.models import vae as jvae
from genome_minimizer_2_tpu.utils import checkpoint as jckpt
from genome_minimizer_2_tpu.utils.config import get_v0_config as j_v0

RTOL = ATOL = 1e-5
DIMS = [(60, 10, 3), (120, 16, 4), (128, 12, 3)]


def _jax_state(D, H, L, seed):
    """JAX-initialized params with BatchNorm statistics and affine terms
    perturbed (numpy, seeded) so eval-mode BN is not the identity."""
    cfg = jvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L)
    params, stats = jvae.init(cfg, jax.random.key(seed))
    rng = np.random.RandomState(seed)
    for tree in ("encoder", "decoder"):
        for i in range(3):
            n = stats[tree][i]["mean"].shape[0]
            stats[tree][i] = {"mean": jnp.asarray(0.1 * rng.randn(n), jnp.float32),
                              "var": jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)}
            params[tree][i]["bn"] = {
                "scale": jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32),
                "bias": jnp.asarray(0.1 * rng.randn(n), jnp.float32)}
            params[tree][i]["b"] = jnp.asarray(0.05 * rng.randn(n), jnp.float32)
    return cfg, params, stats


def _port_model(cfg_j, params, stats):
    cfg = tvae.VAEConfig(input_dim=cfg_j.input_dim, hidden_dim=cfg_j.hidden_dim,
                         latent_dim=cfg_j.latent_dim)
    return tvae.params_from_flat(jckpt._flatten(params, ""),
                                 jckpt._flatten(stats, ""), cfg, device="cpu")


@pytest.mark.parametrize("dims", DIMS)
def test_decode_matches_jax(dims):
    cfg, params, stats = _jax_state(*dims, seed=sum(dims))
    model = _port_model(cfg, params, stats)
    z = np.random.RandomState(1).randn(17, cfg.latent_dim).astype(np.float32)
    want_logits, _ = jvae.decode_logits(cfg, params, stats, jnp.asarray(z), False)
    want_h, _ = jvae.decode_hidden(cfg, params, stats, jnp.asarray(z), False)
    zt = torch.from_numpy(z)
    np.testing.assert_allclose(model.decode_logits(zt).numpy(),
                               np.asarray(want_logits), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(model.decode_hidden(zt).numpy(),
                               np.asarray(want_h), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dims", DIMS)
def test_encode_mean_matches_jax(dims):
    cfg, params, stats = _jax_state(*dims, seed=sum(dims) + 1)
    model = _port_model(cfg, params, stats)
    x = (np.random.RandomState(2).rand(9, cfg.input_dim) < 0.5).astype(np.float32)
    xj = cfg.pad_inputs(jnp.asarray(x))
    want_mean, want_logvar, _ = jvae.encode(cfg, params, stats, xj, False)
    mean, logvar = model.encode(model.cfg.pad_inputs(torch.from_numpy(x)))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(want_logvar),
                               rtol=RTOL, atol=ATOL)


def test_params_from_flat_rejects_bad_leaves():
    cfg, params, stats = _jax_state(60, 10, 3, seed=0)
    flat_p, flat_s = jckpt._flatten(params, ""), jckpt._flatten(stats, "")
    tcfg = tvae.VAEConfig(input_dim=60, hidden_dim=10, latent_dim=3)
    missing = dict(flat_p)
    del missing["decoder/3/w"]
    with pytest.raises(KeyError, match="decoder/3/w"):
        tvae.params_from_flat(missing, flat_s, tcfg, device="cpu")
    wrong = dict(flat_p, **{"mean/w": np.zeros((10, 4), np.float32)})
    with pytest.raises(ValueError, match="mean/w"):
        tvae.params_from_flat(wrong, flat_s, tcfg, device="cpu")


def test_port_paths_cover_the_jax_tree():
    cfg, params, stats = _jax_state(60, 10, 3, seed=0)
    model = _port_model(cfg, params, stats)
    assert set(model.flat_params()) == set(jckpt._flatten(params, ""))
    assert set(model.flat_stats()) == set(jckpt._flatten(stats, ""))


def test_jax_checkpoint_round_trips_through_the_port(tmp_path):
    cfg, params, stats = _jax_state(60, 10, 3, seed=4)
    config = j_v0()
    config.hidden_dim, config.latent_dim = 10, 3
    src = tmp_path / "jax.npz"
    jckpt.save_checkpoint(src, params, stats, config, extra={"input_dim": 60})

    flat_p, flat_s, tconfig, extra = tckpt.load_checkpoint(src)
    assert extra == {"input_dim": 60}
    assert tconfig.to_dict() == config.to_dict()
    tcfg = tvae.VAEConfig(input_dim=60, hidden_dim=10, latent_dim=3)
    model = tvae.params_from_flat(flat_p, flat_s, tcfg, device="cpu")
    back = tmp_path / "port.npz"
    tckpt.save_checkpoint(back, model.flat_params(), model.flat_stats(),
                          tconfig, extra=extra)

    jp, js, jconfig, jextra = jckpt.load_checkpoint(back)
    op, os_, oconfig, oextra = jckpt.load_checkpoint(src)
    assert jconfig.to_dict() == oconfig.to_dict()
    assert jextra == oextra
    assert set(jp) == set(op) and set(js) == set(os_)
    for a, b in ((jp, op), (js, os_)):
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the file's config blob is JSON the JAX loader reads unchanged
    with np.load(back) as z:
        meta = json.loads(bytes(z["__config_json__"]).decode())
    assert meta["config"]["hidden_dim"] == 10


def test_configs_have_the_same_fields():
    assert t_v0().to_dict() == j_v0().to_dict()


def test_port_init_layout():
    """Xavier-uniform at the true dims, zero-padded rows/columns, zero
    biases, identity BatchNorm (JAX ``vae.init`` semantics)."""
    cfg = tvae.VAEConfig(input_dim=100, hidden_dim=12, latent_dim=3)
    model = tvae.init(cfg, torch.Generator().manual_seed(0))
    assert cfg.padded_dim == 128
    w_out, w_in = model.output.w, model.encoder[0].w
    assert tuple(w_out.shape) == (12, 128) and tuple(w_in.shape) == (128, 12)
    assert float(w_out[:, 100:].abs().sum()) == 0.0
    assert float(w_in[100:].abs().sum()) == 0.0
    bound = (6.0 / (12 + 100)) ** 0.5
    assert float(w_out.abs().max()) <= bound and float(w_out[:, :100].std()) > 0
    for name, t in model.flat_params().items():
        if name.endswith("/b") or name.endswith("bn/bias"):
            assert float(t.abs().sum()) == 0.0, name
    logits = model.decode_logits(torch.randn(4, 3))
    assert float(logits[:, 100:].abs().sum()) == 0.0  # padded logits are 0
