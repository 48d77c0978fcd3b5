"""The port's training pieces against the JAX package on the CPU at float32,
from numpy inputs made from a seed: the train-mode forward and BatchNorm
statistics, the initialization, every loss component and its gradients
(v0-v3), one step's gradients at the bf16 policy, the output-layer
backward's plain version, the plain clip + Adam, the plain row-block
gather, and no write to the TF32 switch.

Tolerances are stated beside each check; "bit-equal" means exactly equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from genome_minimizer_2_torch.core import prng as P
from genome_minimizer_2_torch.core.dtypes import Policy
from genome_minimizer_2_torch.models import vae as tvae
from genome_minimizer_2_torch.ops import kernels as K
from genome_minimizer_2_torch.ops import losses as TL
from genome_minimizer_2_torch.ops import optimizer as TO
from genome_minimizer_2_torch.utils.config import get_preset_config as t_preset
from genome_minimizer_2_tpu.core.dtypes import FULL as J_FULL, MIXED as J_MIXED
from genome_minimizer_2_tpu.models import vae as jvae
from genome_minimizer_2_tpu.ops import losses as JL
from genome_minimizer_2_tpu.ops.optimizer import fused_clip_adam_apply
from genome_minimizer_2_tpu.ops.pallas_kernels import gather_row_blocks as j_gather
from genome_minimizer_2_tpu.train.trainer import make_optimizer
from genome_minimizer_2_tpu.utils import checkpoint as jckpt
from genome_minimizer_2_tpu.utils.config import get_preset_config as j_preset

D, H, L, B = 300, 32, 8, 24  # input_dim (padded to 384), hidden, latent, batch


def _jax_model(seed, D=D, H=H, L=L):
    cfg = jvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L)
    params, stats = jvae.init(cfg, jax.random.key(seed))
    return cfg, params, stats


def _port_model(cfg, params, stats):
    tcfg = tvae.VAEConfig(input_dim=cfg.input_dim, hidden_dim=cfg.hidden_dim,
                          latent_dim=cfg.latent_dim)
    return tvae.params_from_flat(jckpt._flatten(params, ""),
                                 jckpt._flatten(stats, ""), tcfg, device="cpu")


def _data(seed, n=B, d=D):
    rng = np.random.RandomState(seed)
    x = (rng.rand(n, d) < rng.uniform(0.1, 0.9, d)).astype(np.float32)
    return np.pad(x, ((0, 0), (0, 384 - d)))


@pytest.mark.parametrize("seed", [0, 3])
def test_init_from_key_bit_equal(seed):
    cfg, params, stats = _jax_model(seed)
    tcfg = tvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L)
    model = tvae.init_from_key(tcfg, P.key(seed, "cpu"))
    want_p, want_s = jckpt._flatten(params, ""), jckpt._flatten(stats, "")
    got_p, got_s = model.flat_params(), model.flat_stats()
    assert list(got_p) == list(want_p)  # the JAX leaf order
    for want, got in ((want_p, got_p), (want_s, got_s)):
        for k in want:
            np.testing.assert_array_equal(got[k].detach().numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(train):
    """Logits, mean, logvar and the new BatchNorm statistics, with eps drawn
    from one key (normals bit-equal). rtol/atol 1e-5: float32 sums in
    another order."""
    cfg, params, stats = _jax_model(1)
    model = _port_model(cfg, params, stats)
    x = _data(2)
    key = 17
    logits, mu, logvar, new_stats = jvae.forward(cfg, params, stats, jnp.asarray(x),
                                                 jax.random.key(key), train=train)
    tl, tmu, tlv, tstats = model.forward(torch.from_numpy(x), P.key(key, "cpu"), train)
    for a, b in ((logits, tl), (mu, tmu), (logvar, tlv)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    want = jckpt._flatten(new_stats, "")
    for k, v in tstats.items():
        np.testing.assert_allclose(v.detach().numpy(), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    h = np.maximum(rng.randn(B, H), 0).astype(np.float32)
    mu = (0.3 * rng.randn(B, L)).astype(np.float32)
    logvar = (0.2 * rng.randn(B, L)).astype(np.float32)
    return h, mu, logvar, _data(seed + 1)


@pytest.mark.parametrize("version", ["v0", "v1", "v2", "v3"])
def test_losses_and_gradients_match_jax(version):
    """Every component and the gradients of the total with respect to every
    parameter (the L1 subgradient at exact zeros included: biases and the
    padding start at 0), h, mu and logvar, against jax.grad. The cosine
    presets run at a counter that moves beta. rtol 2e-5, atol 1e-6."""
    cfg, params, stats = _jax_model(4)
    model = _port_model(cfg, params, stats)
    h, mu, logvar, x = _loss_inputs(5)
    jc = j_preset(version)
    jc.n_epochs = 7
    spec_j = JL.spec_for_preset(version, jc)
    tc = t_preset(version)
    tc.n_epochs = 7
    spec_t = TL.spec_for_preset(version, tc)
    epoch, counter = 2, 13
    mask_j = cfg.feature_mask()

    def jax_total(p, h_, mu_, lv_):
        out = p["decoder"][-1]
        logits = jnp.dot(h_, out["w"], preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST) + out["b"]
        return JL.compute_losses(spec_j, p, logits, jnp.asarray(x), mu_, lv_,
                                 jnp.int32(epoch), jnp.int32(counter), mask_j)

    (jt, jcomps), jgrads = jax.value_and_grad(jax_total, argnums=(0, 1, 2, 3),
                                              has_aux=True)(
        params, jnp.asarray(h), jnp.asarray(mu), jnp.asarray(logvar))
    flat = model.flat_params()
    th = torch.from_numpy(h).requires_grad_()
    tmu = torch.from_numpy(mu).requires_grad_()
    tlv = torch.from_numpy(logvar).requires_grad_()
    tt, tcomps = TL.compute_losses(
        spec_t, flat, th, torch.from_numpy(x), tmu, tlv, epoch,
        torch.tensor(counter, dtype=torch.int32), model.cfg.feature_mask("cpu"),
        model.cfg.policy)
    assert tuple(tcomps) == spec_j.component_names()
    for k in tcomps:
        np.testing.assert_allclose(float(tcomps[k].detach()), float(jcomps[k]), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    inputs = list(flat.values()) + [th, tmu, tlv]
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(
        inputs, torch.autograd.grad(tt, inputs, allow_unused=True))]
    want = jckpt._flatten(jgrads[0], "")
    for (k, _), g in zip(flat.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=2e-5, atol=1e-6, err_msg=k)
    for g, w in zip(grads[len(flat):], jgrads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=1e-6)


# Per-leaf relative error in norm of one bf16 step's gradients against JAX's.
# The port rounds as JAX's transpose does (the float32 cotangent times the
# bf16 operands, the gradients rounded to bf16), so the output layer's dW is
# equal to JAX's; the leaves upstream differ where a float32 sum taken in
# another order flips a bf16 rounding, which the BatchNorm backwards (a
# centred sum of nearly equal terms) carry on. Measured by the test below
# (its printed worst leaf, shown with -rP): 2.3e-3 (seed 0,
# encoder/0/bn/bias) to 1.7e-4 (seed 1), at most 5.3e-3 (seed 2, mean/b).
# Before the rounding moved to JAX's place, 1.15e-2 to 1.54e-2.
BF16_STEP_RTOL = 6e-3


def _bf16_ulps(a, b) -> int:
    """Largest distance in bf16 units of the last place between two float
    arrays holding bf16 values (ordered through the sign)."""
    def ordered(x):
        i = torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
        i = i.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("seed", range(6))
def test_bf16_step_gradients_match_jax(seed):
    """One v0 training step's gradients at the bf16 policy: the train-mode
    forward with eps from one key, the loss and every parameter's gradient,
    against jax.grad of the JAX model under its bf16 policy, which the
    port runs on the CPU with the card's roundings. Each leaf within
    BF16_STEP_RTOL of JAX's in norm, the output layer's weight within 1 bf16
    ulp per element; the bf16 policy itself moves JAX's gradients further
    than that from its float32 ones in some leaf, so a port that skipped a
    rounding would fail. The Linear biases ahead of a BatchNorm have a zero
    gradient in exact arithmetic: both packages' are held below 1e-4."""
    cfg = jvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L, policy=J_MIXED)
    params, stats = jvae.init(cfg, jax.random.key(seed))
    x = _data(seed + 10)
    epoch, counter, key = 1, 5, 11 + seed
    spec_j = JL.spec_for_preset("v0", j_preset("v0"))

    def jax_total(p, cfg_=cfg):
        logits, mu, logvar, _ = jvae.forward(cfg_, p, stats, jnp.asarray(x),
                                             jax.random.key(key), train=True)
        total, _ = JL.compute_losses(spec_j, p, logits, jnp.asarray(x), mu, logvar,
                                     jnp.int32(epoch), jnp.int32(counter),
                                     cfg.feature_mask())
        return total

    jt, jgrads = jax.value_and_grad(jax_total)(params)
    want = jckpt._flatten(jgrads, "")
    full = jckpt._flatten(jax.grad(jax_total)(
        params, dataclasses.replace(cfg, policy=J_FULL)), "")
    tcfg = tvae.VAEConfig(input_dim=D, hidden_dim=H, latent_dim=L,
                          policy=Policy("bfloat16"))
    model = tvae.params_from_flat(jckpt._flatten(params, ""),
                                  jckpt._flatten(stats, ""), tcfg, device="cpu")
    flat = model.flat_params()
    xt = torch.from_numpy(x)
    h, mu, logvar, _ = model.forward_hidden(xt, P.key(key, "cpu"), True)
    tt, _ = TL.compute_losses(
        TL.spec_for_preset("v0", t_preset("v0")), flat, h, xt, mu, logvar, epoch,
        torch.tensor(counter, dtype=torch.int32), tcfg.feature_mask("cpu"),
        tcfg.policy)
    np.testing.assert_allclose(float(tt.detach()), float(jt), rtol=1e-5)
    grads = dict(zip(flat, torch.autograd.grad(tt, list(flat.values()))))
    policy_moves, errs = 0.0, {}
    for k, g in grads.items():
        got = g.numpy()
        if k.split("/")[0] in ("encoder", "decoder") and k[-2:] == "/b" \
                and k != "decoder/3/b":
            assert max(np.abs(got).max(), np.abs(want[k]).max()) <= 1e-4, k
        else:
            norm = np.linalg.norm(want[k])
            errs[k] = np.linalg.norm(got - want[k]) / norm
            policy_moves = max(policy_moves, np.linalg.norm(full[k] - want[k]) / norm)
    worst = max(errs, key=errs.get)
    print(f"seed {seed}: worst leaf {worst} at {errs[worst]:.3g} in norm")  # -rP shows it
    assert errs[worst] <= BF16_STEP_RTOL, (worst, errs[worst])
    assert _bf16_ulps(grads["decoder/3/w"].numpy(), want["decoder/3/w"]) <= 1
    assert policy_moves > BF16_STEP_RTOL


@pytest.mark.parametrize("abundance", [False, True])
def test_output_layer_bf16_grads_match_jax_vjp(abundance):
    """Under the bf16 policy: dW and dh of the output layer within 1 bf16
    ulp per element of jax.vjp of ``dot(h.astype(bf16), W.astype(bf16),
    preferred_element_type=f32) + b`` from the same bf16 logits cotangent
    (the port's, from bf16 logits), db within 1e-6 of JAX's float32 sum."""
    rng = np.random.RandomState(12)
    h = np.maximum(rng.randn(B, H), 0).astype(np.float32)
    w = (0.1 * rng.randn(H, 384)).astype(np.float32)
    b = (0.1 * rng.randn(384)).astype(np.float32)
    y = _data(13)
    mask = np.zeros(384, np.float32)
    mask[:D] = 1.0
    g = torch.tensor(0.7)
    logits = (torch.from_numpy(h).to(torch.bfloat16).float()
              @ torch.from_numpy(w).to(torch.bfloat16).float()
              + torch.from_numpy(b)).to(torch.bfloat16)
    g_logits = (torch.from_numpy(0.05 * rng.randn(B, 384).astype(np.float32))
                .to(torch.bfloat16) if abundance else None)
    yt, mt = torch.from_numpy(y), torch.from_numpy(mask)
    dl = K.output_layer_dl(logits, yt, mt, g, g_logits)

    def f(h_, w_, b_):
        return jnp.dot(h_.astype(jnp.bfloat16), w_.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) + b_

    _, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    want_dh, want_dw, want_db = vjp(jnp.asarray(dl.numpy()))
    dw, db, dh = K.output_layer_bwd(logits, yt, mt, torch.from_numpy(h),
                                    torch.from_numpy(w), g, g_logits)
    assert _bf16_ulps(dw.numpy(), want_dw) <= 1
    assert _bf16_ulps(dh.numpy(), want_dh) <= 1
    for t in (dw, dh):
        assert torch.equal(t, t.to(torch.bfloat16).float())
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=1e-6, atol=1e-6)


# (rows, in, out); the last is the training cells' skinny weight gradient:
# 32 rows, a ragged gene-like width, an output width a multiple of 8
@pytest.mark.parametrize("shape", [(24, 32, 40), (7, 300, 130), (32, 1003, 64)])
def test_bf16_product_backward_matches_jax_transpose(shape):
    """The bf16 product's backward (the float32 cotangent split into two
    bf16 terms) against jax.vjp of the JAX package's product under its bf16
    policy: dX and dW bf16-valued and within 1 bf16 ulp per element, except
    where the sum cancels: a float32 sum in another order (and the split,
    which leaves out 2^-17 of each cotangent) then moves the result by up
    to 2^-16 of the sum of its terms' magnitudes, which is allowed."""
    n, k, m = shape
    rng = np.random.RandomState(n + k)
    x = rng.randn(n, k).astype(np.float32)
    w = (rng.randn(k, m) / np.sqrt(k)).astype(np.float32)
    ct = rng.randn(n, m).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jvae._matmul(a, b, J_MIXED), jnp.asarray(x),
                     jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    tvae.matmul(xt, wt, Policy("bfloat16")).backward(torch.from_numpy(ct))
    rb = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().abs().numpy()
    scales = (np.abs(ct) @ rb(w).T, rb(x).T @ np.abs(ct))
    for got, want, scale in ((xt.grad, want_dx, scales[0]),
                             (wt.grad, want_dw, scales[1])):
        got, want = got.numpy(), np.asarray(want)
        assert got.dtype == np.float32
        assert np.array_equal(got, torch.from_numpy(got).to(torch.bfloat16).float().numpy())
        far = np.abs(got - want) > 2.0 ** -16 * scale
        if far.any():
            assert _bf16_ulps(got[far], want[far]) <= 1


@pytest.mark.parametrize("abundance", [False, True])
def test_output_layer_bwd_plain_matches_jax_vjp(abundance):
    """dW, db, dh of bce (+ the gene-abundance term through the logits)
    against jax.vjp of the JAX output layer and loss, with a cotangent g
    != 1. rtol 1e-5, atol 1e-6."""
    rng = np.random.RandomState(8)
    h = np.maximum(rng.randn(B, H), 0).astype(np.float32)
    w = (0.1 * rng.randn(H, 384)).astype(np.float32)
    w[:, D:] = 0.0
    b = (0.1 * rng.randn(384)).astype(np.float32)
    b[D:] = 0.0
    y = _data(9)
    mask = np.zeros(384, np.float32)
    mask[:D] = 1.0
    g = np.float32(0.7)
    scale = 0.3

    def f(h_, w_, b_):
        logits = jnp.dot(h_, w_, precision=jax.lax.Precision.HIGHEST) + b_
        out = JL.bce_sum_logits(logits, jnp.asarray(y), jnp.asarray(mask))
        if abundance:
            out = out + scale * JL.gene_abundance(logits, jnp.asarray(mask))
        return out

    _, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    want_dh, want_dw, want_db = vjp(jnp.float32(g))
    logits = torch.from_numpy(h) @ torch.from_numpy(w) + torch.from_numpy(b)
    g_logits = None
    if abundance:
        lt = logits.clone().requires_grad_()
        ga = scale * TL.gene_abundance(lt, torch.from_numpy(mask))
        (g_logits,) = torch.autograd.grad(ga * float(g), lt)
    dw, db, dh = K.output_layer_bwd(
        logits, torch.from_numpy(y), torch.from_numpy(mask), torch.from_numpy(h),
        torch.from_numpy(w), torch.tensor(g), g_logits)
    for got, want in ((dw, want_dw), (db, want_db), (dh, want_dh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert float(dw[:, D:].abs().sum()) == 0.0 and float(db[D:].abs().sum()) == 0.0


def _adam_inputs(seed, n=5000):
    rng = np.random.RandomState(seed)
    g = (0.3 * rng.randn(n)).astype(np.float32)
    m = (0.01 * rng.randn(n)).astype(np.float32)
    v = (1e-4 * np.abs(rng.randn(n))).astype(np.float32)
    p = rng.randn(n).astype(np.float32)
    return g, m, v, p


@pytest.mark.parametrize("max_norm", [1.0, 1e6])  # the clip / no-clip branch
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_plain_clip_adam_bit_equal_to_jax(max_norm, moments):
    """The plain clip + Adam against ``fused_clip_adam_apply`` run op by op
    (jax.disable_jit: every op rounds once, the optax order), bit-equal, at
    float32 and bf16 moments; and at float32 against the optax chain run
    op by op, bit-equal. The norm, count and lr are the JAX ones."""
    g, m, v, p = _adam_inputs(3)
    mdt = jnp.float32 if moments == "float32" else jnp.bfloat16
    tx = make_optimizer(max_norm)
    params = {"a": jnp.asarray(p)}
    opt = tx.init(params)
    opt = (opt[0], opt[1]._replace(count=jnp.int32(4),
                                   mu={"a": jnp.asarray(m).astype(mdt)},
                                   nu={"a": jnp.asarray(v).astype(mdt)}))
    lr = jnp.float32(1e-3)
    with jax.disable_jit():
        jp, jopt = fused_clip_adam_apply({"a": jnp.asarray(g)}, opt, params, lr,
                                         max_norm=max_norm)
        norm = jnp.sqrt(jnp.sum(jnp.square(jnp.asarray(g))))
        bc1 = (1 - 0.9 ** jnp.int32(5)).astype(jnp.float32)
        bc2 = (1 - 0.999 ** jnp.int32(5)).astype(jnp.float32)
    tdt = torch.float32 if moments == "float32" else torch.bfloat16
    # copies: JAX on the CPU may share the numpy buffers the kernel updates
    tm = torch.tensor(np.array(opt[1].mu["a"].astype(jnp.float32))).to(tdt)
    tv = torch.tensor(np.array(opt[1].nu["a"].astype(jnp.float32))).to(tdt)
    tp = torch.from_numpy(p.copy())
    scalars = torch.tensor([float(norm), float(bc1), float(bc2), 1e-3],
                           dtype=torch.float32)
    K.clip_adam_apply(torch.tensor(g), tm, tv, tp, scalars, max_norm)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp["a"]))
    np.testing.assert_array_equal(tm.float().numpy(),
                                  np.asarray(jopt[1].mu["a"].astype(jnp.float32)))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jopt[1].nu["a"].astype(jnp.float32)))
    if moments == "float32":
        with jax.disable_jit():
            updates, _ = tx.update({"a": jnp.asarray(g)}, opt, params)
            op = optax.apply_updates(params, jax.tree.map(lambda u: (-lr) * u, updates))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(op["a"]))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])  # the clip / no-clip branch
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_plain_clip_adam_step_over_a_models_leaves_bit_equal_to_jax(max_norm,
                                                                   moments):
    """A whole ``clip_adam_step`` over every leaf of a small VAE (one call
    of the multi-leaf entry, its plain version here) against
    ``fused_clip_adam_apply`` run op by op (jax.disable_jit), bit-equal:
    every leaf's parameters and both moments, and the count. The
    gradients are multiples of 2^-10 below 2^-6, so every partial sum of
    their squares is exact and the global norm has one value whatever the
    order of the sums."""
    _, params, _ = _jax_model(0)
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.RandomState(7)
    g = [(rng.randint(-15, 16, x.shape) * 2.0 ** -10).astype(np.float32)
         for x in leaves]
    m = [(0.01 * rng.randn(*x.shape)).astype(np.float32) for x in leaves]
    v = [(1e-4 * np.abs(rng.randn(*x.shape))).astype(np.float32) for x in leaves]
    norm = np.sqrt(sum(np.square(x.astype(np.float64)).sum() for x in g))
    assert (norm > max_norm) == (max_norm == 0.5)
    mdt = jnp.float32 if moments == "float32" else jnp.bfloat16
    tree = lambda xs, dt: jax.tree.unflatten(  # noqa: E731
        treedef, [jnp.asarray(x).astype(dt) for x in xs])
    tx = make_optimizer(max_norm)
    opt = tx.init(params)
    opt = (opt[0], opt[1]._replace(count=jnp.int32(4), mu=tree(m, mdt),
                                   nu=tree(v, mdt)))
    with jax.disable_jit():
        jp, jopt = fused_clip_adam_apply(tree(g, jnp.float32), opt, params,
                                         jnp.float32(1e-3), max_norm=max_norm)
    tdt = torch.float32 if moments == "float32" else torch.bfloat16
    keys = [str(i) for i in range(len(leaves))]
    # copies: JAX on the CPU may share the numpy buffers the update writes
    tp = {k: torch.tensor(np.array(x, np.float32)) for k, x in zip(keys, leaves)}
    state = TO.AdamState(torch.tensor(4, dtype=torch.int32),
                         {k: torch.tensor(x).to(tdt) for k, x in zip(keys, m)},
                         {k: torch.tensor(x).to(tdt) for k, x in zip(keys, v)})
    TO.clip_adam_step(tp, {k: torch.tensor(x) for k, x in zip(keys, g)}, state,
                      torch.tensor(1e-3), max_norm)
    assert int(state.count) == int(jopt[1].count) == 5
    want = [jax.tree.leaves(t) for t in (jp, jopt[1].mu, jopt[1].nu)]
    for i, k in enumerate(keys):
        for got, w in zip((tp[k], state.mu[k], state.nu[k]), want):
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(w[i].astype(jnp.float32)))


def test_optimizer_step_matches_jitted_optax():
    """A whole clip_adam_step (global norm, bias corrections from the
    count, every leaf) against the jitted optax chain the JAX trainer runs
    on the CPU: XLA contracts multiply-adds into FMAs there, so the bound is
    4 ulp on params and moments, not bit equality."""
    rng = np.random.RandomState(11)
    shapes = {"a": (40, 7), "b": (7,), "c": (3, 5)}
    grads = {k: (0.3 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = make_optimizer(1.0)
    opt = tx.init({k: jnp.asarray(v) for k, v in params.items()})

    @jax.jit
    def step(g, o, p):
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, jax.tree.map(lambda x: (-1e-3) * x, u)), o

    jp, jo = {k: jnp.asarray(v) for k, v in params.items()}, opt
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = TO.AdamState.zeros(tp, torch.float32)
    for _ in range(3):
        jp, jo = step({k: jnp.asarray(v) for k, v in grads.items()}, jo, jp)
        TO.clip_adam_step(tp, {k: torch.from_numpy(v) for k, v in grads.items()},
                          state, torch.tensor(1e-3), 1.0)
    assert int(state.count) == int(jo[1].count) == 3
    for k in shapes:
        for got, want in ((tp[k], jp[k]), (state.mu[k], jo[1].mu[k]),
                          (state.nu[k], jo[1].nu[k])):
            gi = got.numpy().view(np.int32).astype(np.int64)
            wi = np.asarray(want).view(np.int32).astype(np.int64)
            assert np.abs(gi - wi).max() <= 4, k


@pytest.mark.parametrize("count", [1, 2, 10, 100, 1000, 2956, 2958, 3606,
                                   "1..300000"])
def test_bias_corrections_match_xla(count):
    """Equal to XLA's jitted float32 ``1 - b ** count`` on the CPU (glibc's
    powf), one count or all counts 1..300,000 in one jitted call; a float64
    power rounded to float32 differs at 2,958 and 3,606 (b2)."""
    c = (np.arange(1, 300_001, dtype=np.int32) if count == "1..300000"
         else np.int32(count))
    want = [np.asarray(jax.jit(lambda c: (1 - b ** c).astype(jnp.float32))(
        jnp.asarray(c))) for b in (0.9, 0.999)]
    got = TO.bias_corrections(torch.tensor(c, dtype=torch.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("block", [8, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gather_bit_equal_to_jax(block, dtype):
    """The plain row-block gather against the JAX package's off-TPU
    ``jnp.take`` path, bit-equal; 101 rows (trailing rows not addressed)."""
    rng = np.random.RandomState(2)
    x = rng.randn(101, 19).astype(np.float32)
    idx = rng.permutation(101 // block).astype(np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(j_gather(jnp.asarray(x).astype(jdt), jnp.asarray(idx))
                      if block == 8 else jnp.take(jnp.asarray(x).astype(jdt),
                                                  jnp.asarray(idx), axis=0))
    got = K.gather_row_blocks(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(idx), block)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_no_write_to_the_tf32_switch(monkeypatch):
    """vae.matmul, decode_logits_reference and one training step leave
    torch.backends.cuda.matmul.allow_tf32 (and every other attribute of
    that module) unwritten."""
    from genome_minimizer_2_torch.train import trainer as TT

    writes = []
    cls = type(torch.backends.cuda.matmul)
    real = cls.__setattr__
    monkeypatch.setattr(cls, "__setattr__",
                        lambda self, name, value: (writes.append(name),
                                                   real(self, name, value)))
    tvae.matmul(torch.ones(2, 3), torch.ones(3, 4), tvae.FULL)
    K.decode_logits_reference(torch.ones(2, 3), torch.ones(3, 4), torch.zeros(4),
                              torch.float32)
    cfg = t_preset("v0")
    cfg.hidden_dim, cfg.latent_dim, cfg.batch_size = 8, 2, 4
    trainer = TT.create_trainer("v0", cfg, 20, device="cpu")
    state = trainer.init_state()
    x = trainer.prepare_data((np.random.RandomState(0).rand(4, 20) < 0.5))
    trainer._train_step(state, x, 0, torch.tensor(1e-3))
    assert writes == []


def test_metrics_and_latent_means_match_jax():
    """Reconstruction metrics (eval BatchNorm, eps keyed per batch with
    fold_in), the loss breakdown and the latent means against the JAX
    package. The port thresholds the logit and JAX the sigmoid, with float32
    sums in another order, so at most 1e-3 of the reconstructed bits may
    differ and F1 / accuracy agree within 1e-3; the losses within rtol
    1e-5, the means within 1e-5."""
    from genome_minimizer_2_torch.eval import metrics as TM
    from genome_minimizer_2_torch.sample.sampler import Sampler as TSampler
    from genome_minimizer_2_tpu.eval import metrics as JM
    from genome_minimizer_2_tpu.sample.sampler import Sampler as JSampler

    cfg, params, stats = _jax_model(6)
    model = _port_model(cfg, params, stats)
    x = _data(7, n=45)[:, :D]
    jkey, tkey = jax.random.key(3), P.key(3, "cpu")
    jf1, jacc, jf1s, _ = JM.calculate_reconstruction_metrics(
        cfg, params, stats, x, jkey, batch_size=16)
    tf1, tacc, tf1s, _ = TM.calculate_reconstruction_metrics(
        model, x, tkey, batch_size=16)
    want = JM.reconstruct_binary(cfg, params, stats, x, jkey, batch_size=16)
    got = TM.reconstruct_binary(model, x, tkey, batch_size=16)
    assert got.shape == want.shape == (45, D)
    assert (got != want).mean() <= 1e-3
    np.testing.assert_allclose([tf1, tacc], [jf1, jacc], atol=1e-3)
    jb = JM.calculate_reconstruction_loss_breakdown(cfg, params, stats, x, jkey, 16)
    tb = TM.calculate_reconstruction_loss_breakdown(model, x, tkey, 16)
    assert tb["total_samples"] == jb["total_samples"] == 45
    for k in ("avg_reconstruction_loss", "avg_kl_divergence_loss"):
        np.testing.assert_allclose(tb[k], jb[k], rtol=1e-5)
    jmeans = JSampler(cfg=cfg, params=params, batch_stats=stats).encode_means(x, 16)
    tmeans = TSampler(model=model).encode_means(x, 16)
    np.testing.assert_allclose(tmeans, jmeans, rtol=1e-5, atol=1e-5)
