"""MLP VAE in PyTorch: the eval forward (sampling) and the train forward.

Same architecture, parameter names and layout as the JAX package's
``models/vae.py``: encoder = 3 x [Linear -> BatchNorm -> ReLU], mean/logvar
heads, decoder = 3 x [Linear -> BatchNorm -> ReLU] + output Linear,
returning pre-sigmoid logits. Two choices follow from holding the port to
the JAX checkpoints as they are:

- weights stay in the JAX **(in, out)** layout (``x @ w``), so a checkpoint
  loads with no transpose and the CUDA kernels read the output weight
  ``W (K, N)`` row-major directly;
- the gene axis is padded to a multiple of 128 (``padded_dim``) with zero
  rows of the first encoder weight and zero columns and bias of the output
  layer, so padded logits are exactly 0 and threshold to 0 bits.

BatchNorm follows torch semantics (eps 1e-5, momentum 0.1): train mode
normalizes with the biased batch variance and moves the running variance
with the unbiased one; eval normalizes with the running statistics
(``vae.py:177-198``); on W > 1 data-parallel ranks the batch statistics
are the global batch's (all-reduced sums). Matmuls follow the dtype
policy: operands rounded to the compute dtype, float32 products and sums
(:func:`matmul`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..core import prng
from ..core.dtypes import (FULL, Policy, require_ieee_float32_matmul,
                           resolve_device, round_up)
from ..parallel.mesh import RowShare, all_reduce_sum

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention: new = (1-m)*running + m*batch


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    input_dim: int           # true number of gene columns (e.g. 55039)
    hidden_dim: int
    latent_dim: int
    pad_features: bool = True
    policy: Policy = FULL

    @property
    def padded_dim(self) -> int:
        return round_up(self.input_dim, 128) if self.pad_features else self.input_dim

    def feature_mask(self, device: str | torch.device = "cuda") -> torch.Tensor:
        """(padded_dim,) float32 mask: 1 for real genes, 0 for padding."""
        mask = torch.zeros(self.padded_dim, dtype=torch.float32, device=device)
        mask[: self.input_dim] = 1.0
        return mask

    def pad_inputs(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad (N, input_dim) -> (N, padded_dim)."""
        extra = self.padded_dim - x.shape[-1]
        return x if extra == 0 else nn.functional.pad(x, (0, extra))


def _mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> float32 product with float32 accumulation: on CUDA
    ``aten::mm.dtype`` (no global flag); on the CPU the operands are
    upcast, whose products are exact in float32."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _mm_f32_bf16(g: torch.Tensor, b: torch.Tensor, g_left: bool) -> torch.Tensor:
    """The float32 ``g`` times the bf16 ``b`` (``g @ b`` or ``b @ g``) as two
    bf16 products: g = g_hi + g_lo with g_hi = bf16(g), g_lo = bf16(g -
    g_hi), which leaves out at most about 2^-17 of g, far under the bf16
    rounding of the result."""
    g = g.float()
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    if g_left:
        return _mm_bf16(hi, b) + _mm_bf16(lo, b)
    return _mm_bf16(b, hi) + _mm_bf16(b, lo)


class _BF16Matmul(torch.autograd.Function):
    """The bf16 policy's product and its backward, the same roundings on
    the card and on the CPU. The operands come in at any float dtype and
    are rounded to bf16 here. The backward is JAX's transpose of its
    product (``jax.lax.dot_general`` with ``preferred_element_type``): the
    float32 cotangent times the bf16 operands (:func:`_mm_f32_bf16`), each
    gradient rounded to bf16 and returned in its input's dtype."""

    @staticmethod
    def forward(ctx, x, w):
        xc, wc = x.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xc, wc)
        ctx.dtypes = (x.dtype, w.dtype)
        return _mm_bf16(xc, wc)

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_f32_bf16(g, wc.t(), True).to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = _mm_f32_bf16(g, xc.t(), False).to(torch.bfloat16).to(ctx.dtypes[1])
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Operands rounded to the compute dtype, float32 products and sums (the
    JAX ``preferred_element_type=float32`` contraction, ``vae.py:160-174``).

    Under bf16 the product takes bf16 operands with float32 output
    (:class:`_BF16Matmul`); under float32 on CUDA it requires IEEE float32
    (raises if TF32 is on). No process-global precision flag is written
    here."""
    if policy.compute_dtype == torch.bfloat16:
        return _BF16Matmul.apply(x, w)
    if x.device.type == "cuda":
        require_ieee_float32_matmul()
    return x.float() @ w.float()


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored (in, out), as the JAX package does."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        return matmul(x, self.w, policy) + self.b


class Block(Linear):
    """Linear -> BatchNorm -> ReLU. Returns (y, new running (mean, var)):
    train mode normalizes with the batch statistics and returns the moved
    running ones; eval normalizes with, and returns, the running ones."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out)
        self.bn_scale = nn.Parameter(torch.ones(d_out))
        self.bn_bias = nn.Parameter(torch.zeros(d_out))
        self.register_buffer("bn_mean", torch.zeros(d_out))
        self.register_buffer("bn_var", torch.ones(d_out))

    def forward(self, x: torch.Tensor, policy: Policy, train: bool = False,
                share: RowShare | None = None):
        h = super().forward(x, policy)
        if train and share is not None:
            # the global batch's statistics, two passes as below: its mean,
            # then the mean square about it (the backward goes through the
            # same sums)
            n = share.total
            mean = all_reduce_sum(h.sum(dim=0), share.axis) / n
            var = all_reduce_sum((h - mean).square().sum(dim=0), share.axis) / n
            unbiased = var * (n / max(n - 1, 1))
            stats = ((1 - BN_MOMENTUM) * self.bn_mean + BN_MOMENTUM * mean.detach(),
                     (1 - BN_MOMENTUM) * self.bn_var + BN_MOMENTUM * unbiased.detach())
        elif train:
            mean = h.mean(dim=0)
            var = (h - mean).square().mean(dim=0)  # biased
            n = h.shape[0]
            unbiased = var * (n / max(n - 1, 1))
            stats = ((1 - BN_MOMENTUM) * self.bn_mean + BN_MOMENTUM * mean.detach(),
                     (1 - BN_MOMENTUM) * self.bn_var + BN_MOMENTUM * unbiased.detach())
        else:
            mean, var = self.bn_mean, self.bn_var
            stats = (mean, var)
        inv = torch.rsqrt(var + BN_EPS)
        h = (h - mean) * inv * self.bn_scale + self.bn_bias
        return torch.clamp_min(h, 0.0), stats


def reparameterize(key: torch.Tensor, mean: torch.Tensor,
                   logvar: torch.Tensor,
                   share: RowShare | None = None) -> torch.Tensor:
    """z = mean + exp(0.5 * logvar) * eps with eps = ``prng.normal(key,
    mean.shape)``, the draw of JAX's ``vae.py:251-255``. Under a
    :class:`RowShare` one key draws the global batch's normals and this
    rank takes its rows of them."""
    key = key.to(mean.device)
    if share is None:
        eps = prng.normal(key, tuple(mean.shape))
    else:
        lo = share.offset
        eps = prng.normal(key, (share.total, mean.shape[1]))[lo: lo + mean.shape[0]]
    return mean + torch.exp(0.5 * logvar) * eps


class VAE(nn.Module):
    """Parameters of one VAE plus its apply functions."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        Dp, H, L = cfg.padded_dim, cfg.hidden_dim, cfg.latent_dim
        self.encoder = nn.ModuleList([Block(Dp, H), Block(H, H), Block(H, H)])
        self.mean = Linear(H, L)
        self.logvar = Linear(H, L)
        self.decoder = nn.ModuleList([Block(L, H), Block(H, H), Block(H, H)])
        self.output = Linear(H, Dp)  # decoder/3 in the checkpoint

    # -- apply (autograd-enabled) ---------------------------------------------

    def _stack(self, tree: str, x: torch.Tensor, train: bool,
               share: RowShare | None = None):
        stats: Dict[str, torch.Tensor] = {}
        for i, block in enumerate(getattr(self, tree)):
            x, (mean, var) = block(x, self.cfg.policy, train, share)
            stats[f"{tree}/{i}/mean"], stats[f"{tree}/{i}/var"] = mean, var
        return x, stats

    def encode_stats(self, x: torch.Tensor, train: bool,
                     share: RowShare | None = None):
        """x (N, padded_dim) -> (mean, logvar, new encoder stats)."""
        h, stats = self._stack("encoder", x, train, share)
        policy = self.cfg.policy
        return self.mean(h, policy), self.logvar(h, policy), stats

    def forward_hidden(self, x: torch.Tensor, key: torch.Tensor, train: bool,
                       share: RowShare | None = None):
        """The forward up to the decoder's last hidden layer: (h (N,
        hidden_dim), mean, logvar, new batch stats as {path: tensor}). The
        loss takes the output layer from here (ops/output_layer.py). With
        ``share``, ``x`` is this rank's rows of a global batch: BatchNorm
        takes the global batch's statistics and the noise its rows of the
        global draw."""
        mean, logvar, stats = self.encode_stats(x, train, share)
        z = reparameterize(key, mean, logvar, share)
        h, dec_stats = self._stack("decoder", z, train, share)
        stats.update(dec_stats)
        return h, mean, logvar, stats

    def forward(self, x: torch.Tensor, key: torch.Tensor, train: bool):
        """Full VAE forward (``vae.py:258-266``): (logits (N, padded_dim) in
        the policy's logits dtype, mean, logvar, new batch stats)."""
        h, mean, logvar, stats = self.forward_hidden(x, key, train)
        logits = self.output(h, self.cfg.policy).to(self.cfg.policy.logits_dtype)
        return logits, mean, logvar, stats

    # -- eval apply (the sampling path) ---------------------------------------

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (N, padded_dim) -> (mean, logvar), eval mode."""
        mean, logvar, _ = self.encode_stats(x, False)
        return mean, logvar

    @torch.no_grad()
    def decode_hidden(self, z: torch.Tensor) -> torch.Tensor:
        """Decoder hidden stack: z (N, latent_dim) -> h (N, hidden_dim)."""
        return self._stack("decoder", z, False)[0]

    @torch.no_grad()
    def decode_logits(self, z: torch.Tensor) -> torch.Tensor:
        """z -> logits (N, padded_dim), stored in the policy's logits dtype
        (bf16 under the mixed policy, as in the JAX package)."""
        logits = self.output(self.decode_hidden(z), self.cfg.policy)
        return logits.to(self.cfg.policy.logits_dtype)

    # -- checkpoint layout ----------------------------------------------------

    def flat_params(self) -> dict[str, torch.Tensor]:
        """{'/'-joined JAX pytree path: tensor} for the ``params`` tree, in
        the JAX tree's leaf order (sorted dict keys, list order)."""
        flat = {}
        for tree, blocks in (("decoder", self.decoder), ("encoder", self.encoder)):
            for i, blk in enumerate(blocks):
                flat[f"{tree}/{i}/b"] = blk.b
                flat[f"{tree}/{i}/bn/bias"] = blk.bn_bias
                flat[f"{tree}/{i}/bn/scale"] = blk.bn_scale
                flat[f"{tree}/{i}/w"] = blk.w
            if tree == "decoder":
                flat["decoder/3/b"] = self.output.b
                flat["decoder/3/w"] = self.output.w
        for head in ("logvar", "mean"):
            flat[f"{head}/b"] = getattr(self, head).b
            flat[f"{head}/w"] = getattr(self, head).w
        return flat

    def flat_stats(self) -> dict[str, torch.Tensor]:
        """{'/'-joined path: tensor} for the ``batch_stats`` tree."""
        flat = {}
        for tree, blocks in (("decoder", self.decoder), ("encoder", self.encoder)):
            for i, blk in enumerate(blocks):
                flat[f"{tree}/{i}/mean"] = blk.bn_mean
                flat[f"{tree}/{i}/var"] = blk.bn_var
        return flat


def param_count(cfg: VAEConfig) -> int:
    """Trainable parameter count at the true (unpadded) dims, as the
    reference's torch model counts it (the JAX package's ``vae.py:144``)."""
    D, H, L = cfg.input_dim, cfg.hidden_dim, cfg.latent_dim
    lin = lambda i, o: i * o + o
    bn = lambda d: 2 * d
    enc = lin(D, H) + bn(H) + 2 * (lin(H, H) + bn(H))
    dec = lin(L, H) + bn(H) + 2 * (lin(H, H) + bn(H)) + lin(H, D)
    return enc + 2 * lin(H, L) + dec


def pour(flat: dict, target: dict, what: str = "Checkpoint") -> None:
    """Copy {path: array} into the tensors of ``target`` ({path: tensor}),
    unchanged. Missing leaves and shape mismatches raise."""
    for key, tensor in target.items():
        if key not in flat:
            raise KeyError(f"{what} missing leaf {key!r}")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{what} leaf {key!r} has shape "
                             f"{tuple(arr.shape)}, expected "
                             f"{tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(arr.astype(np.float32, copy=True))
                         .to(tensor.dtype))


def params_from_flat(flat_params: dict, flat_stats: dict, cfg: VAEConfig,
                     device: str | torch.device = "cuda") -> VAE:
    """Pour the JAX package's flat {path: numpy array} params and batch
    stats (``utils/checkpoint.py::load_checkpoint``) into a VAE on
    ``device``, unchanged. Missing leaves and shape mismatches raise. The
    optimizer state follows the same paths (``train/trainer.py``)."""
    device = resolve_device(device)
    model = VAE(cfg)
    pour(flat_params, model.flat_params())
    pour(flat_stats, model.flat_stats())
    return model.to(device)


def init(cfg: VAEConfig, generator: torch.Generator) -> VAE:
    """Fresh parameters (JAX ``vae.init`` semantics, torch random numbers):
    Xavier-uniform weights drawn at the TRUE dims then zero-padded, zero
    biases, BatchNorm scale 1 / bias 0 / running mean 0 / var 1. Tensors
    are made on the generator's device."""
    def draw(true_in, true_out, bound):
        w = torch.empty(true_in, true_out, device=generator.device)
        return w.uniform_(-bound, bound, generator=generator)

    return _xavier_model(cfg, draw, generator.device)


def init_from_key(cfg: VAEConfig, key: torch.Tensor) -> VAE:
    """Fresh parameters bit-equal to JAX ``vae.init(cfg, key)`` (``vae.py:
    107-141``): keys ``split(key, 10)``, Xavier draws ``uniform(k, (in,
    out), -bound, bound)`` at the true dims, then zero padding. Made on the
    key's device."""
    order = iter(prng.split(key, 10))

    def draw(true_in, true_out, bound):
        return prng.uniform(next(order), (true_in, true_out), -bound, bound)

    return _xavier_model(cfg, draw, key.device)


def _xavier_model(cfg: VAEConfig, draw, device) -> VAE:
    D, H, L = cfg.input_dim, cfg.hidden_dim, cfg.latent_dim
    model = VAE(cfg).to(device)

    def xavier(lin: Linear, true_in: int, true_out: int) -> None:
        bound = (6.0 / (true_in + true_out)) ** 0.5
        with torch.no_grad():
            lin.w.zero_()
            lin.w[:true_in, :true_out] = draw(true_in, true_out, bound)

    # the JAX key order: encoder 0-2, mean, logvar, decoder 0-2, output
    xavier(model.encoder[0], D, H)
    xavier(model.encoder[1], H, H)
    xavier(model.encoder[2], H, H)
    xavier(model.mean, H, L)
    xavier(model.logvar, H, L)
    xavier(model.decoder[0], L, H)
    xavier(model.decoder[1], H, H)
    xavier(model.decoder[2], H, H)
    xavier(model.output, H, D)
    return model
