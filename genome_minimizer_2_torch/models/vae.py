"""MLP VAE in PyTorch, eval forward (the sampling path).

Same architecture, parameter names and layout as the JAX package's
``models/vae.py``: encoder = 3 x [Linear -> BatchNorm -> ReLU], mean/logvar
heads, decoder = 3 x [Linear -> BatchNorm -> ReLU] + output Linear,
returning pre-sigmoid logits. Two choices follow from holding the port to
the JAX checkpoints as they are:

- weights stay in the JAX **(in, out)** layout (``x @ w``), so a checkpoint
  loads with no transpose and the CUDA decode kernel reads the output
  weight ``W (K, N)`` row-major directly;
- the gene axis is padded to a multiple of 128 (``padded_dim``) with zero
  rows of the first encoder weight and zero columns and bias of the output
  layer, so padded logits are exactly 0 and threshold to 0 bits.

BatchNorm follows torch semantics (eps 1e-5; eval normalizes with the
running statistics), as ``vae.py:177-198`` does. Matmuls follow the dtype
policy: operands rounded to the compute dtype, float32 products and sums.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from ..core.dtypes import FULL, Policy, resolve_device, round_up

BN_EPS = 1e-5


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


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` stored (in, out), as the JAX package does."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(d_out), requires_grad=False)

    def forward(self, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        return matmul(x, self.w, policy) + self.b


class Block(Linear):
    """Linear -> BatchNorm (eval: running statistics) -> ReLU."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__(d_in, d_out)
        self.bn_scale = nn.Parameter(torch.ones(d_out), requires_grad=False)
        self.bn_bias = nn.Parameter(torch.zeros(d_out), requires_grad=False)
        self.register_buffer("bn_mean", torch.zeros(d_out))
        self.register_buffer("bn_var", torch.ones(d_out))

    def forward(self, x: torch.Tensor, policy: Policy) -> torch.Tensor:
        h = super().forward(x, policy)
        inv = torch.rsqrt(self.bn_var + BN_EPS)
        h = (h - self.bn_mean) * inv * self.bn_scale + self.bn_bias
        return torch.clamp_min(h, 0.0)


def matmul(x: torch.Tensor, w: torch.Tensor, policy: Policy) -> torch.Tensor:
    """Operands rounded to the compute dtype, float32 products and sums (the
    JAX ``preferred_element_type=float32`` contraction). bf16 x bf16
    products are exact in float32, so the upcast matmul with TF32 off is
    that contraction."""
    cd = policy.compute_dtype
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return x.to(cd).float() @ w.to(cd).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class VAE(nn.Module):
    """Parameters of one VAE plus its eval-mode apply functions."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        Dp, H, L = cfg.padded_dim, cfg.hidden_dim, cfg.latent_dim
        self.encoder = nn.ModuleList([Block(Dp, H), Block(H, H), Block(H, H)])
        self.mean = Linear(H, L)
        self.logvar = Linear(H, L)
        self.decoder = nn.ModuleList([Block(L, H), Block(H, H), Block(H, H)])
        self.output = Linear(H, Dp)  # decoder/3 in the checkpoint

    # -- apply --------------------------------------------------------------

    @torch.no_grad()
    def encode(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x (N, padded_dim) -> (mean, logvar), eval mode."""
        h = x
        for block in self.encoder:
            h = block(h, self.cfg.policy)
        return self.mean(h, self.cfg.policy), self.logvar(h, self.cfg.policy)

    @torch.no_grad()
    def decode_hidden(self, z: torch.Tensor) -> torch.Tensor:
        """Decoder hidden stack: z (N, latent_dim) -> h (N, hidden_dim)."""
        h = z
        for block in self.decoder:
            h = block(h, self.cfg.policy)
        return h

    @torch.no_grad()
    def decode_logits(self, z: torch.Tensor) -> torch.Tensor:
        """z -> logits (N, padded_dim), stored in the policy's logits dtype
        (bf16 under the mixed policy, as in the JAX package)."""
        logits = self.output(self.decode_hidden(z), self.cfg.policy)
        return logits.to(self.cfg.policy.logits_dtype)

    # -- checkpoint layout ----------------------------------------------------

    def flat_params(self) -> dict[str, torch.Tensor]:
        """{'/'-joined JAX pytree path: tensor} for the ``params`` tree."""
        flat = {}
        for tree, blocks in (("encoder", self.encoder), ("decoder", self.decoder)):
            for i, blk in enumerate(blocks):
                flat[f"{tree}/{i}/w"] = blk.w
                flat[f"{tree}/{i}/b"] = blk.b
                flat[f"{tree}/{i}/bn/scale"] = blk.bn_scale
                flat[f"{tree}/{i}/bn/bias"] = blk.bn_bias
        flat["decoder/3/w"] = self.output.w
        flat["decoder/3/b"] = self.output.b
        for head in ("mean", "logvar"):
            flat[f"{head}/w"] = getattr(self, head).w
            flat[f"{head}/b"] = getattr(self, head).b
        return flat

    def flat_stats(self) -> dict[str, torch.Tensor]:
        """{'/'-joined path: tensor} for the ``batch_stats`` tree."""
        flat = {}
        for tree, blocks in (("encoder", self.encoder), ("decoder", self.decoder)):
            for i, blk in enumerate(blocks):
                flat[f"{tree}/{i}/mean"] = blk.bn_mean
                flat[f"{tree}/{i}/var"] = blk.bn_var
        return flat


def params_from_flat(flat_params: dict, flat_stats: dict, cfg: VAEConfig,
                     device: str | torch.device = "cuda") -> VAE:
    """Pour the JAX package's flat {path: numpy array} params and batch
    stats (``utils/checkpoint.py::load_checkpoint``) into a VAE on
    ``device``, unchanged. Missing leaves and shape mismatches raise."""
    device = resolve_device(device)
    model = VAE(cfg)
    for flat, target in ((flat_params, model.flat_params()),
                         (flat_stats, model.flat_stats())):
        for key, tensor in target.items():
            if key not in flat:
                raise KeyError(f"Checkpoint missing leaf {key!r}")
            arr = np.asarray(flat[key], dtype=np.float32)
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f"Checkpoint leaf {key!r} has shape "
                                 f"{tuple(arr.shape)}, expected "
                                 f"{tuple(tensor.shape)}")
            tensor.data.copy_(torch.from_numpy(arr.copy()))
    return model.to(device)


def init(cfg: VAEConfig, generator: torch.Generator) -> VAE:
    """Fresh parameters (JAX ``vae.init`` semantics, torch random numbers):
    Xavier-uniform weights drawn at the TRUE dims then zero-padded, zero
    biases, BatchNorm scale 1 / bias 0 / running mean 0 / var 1. Tensors
    are made on the generator's device."""
    D, H, L = cfg.input_dim, cfg.hidden_dim, cfg.latent_dim
    model = VAE(cfg).to(generator.device)

    def xavier(lin: Linear, true_in: int, true_out: int) -> None:
        bound = math.sqrt(6.0 / (true_in + true_out))
        w = torch.empty(true_in, true_out, device=generator.device)
        w.uniform_(-bound, bound, generator=generator)
        lin.w.data.zero_()
        lin.w.data[:true_in, :true_out] = w

    xavier(model.encoder[0], D, H)
    for blk in list(model.encoder[1:]) + list(model.decoder[1:]):
        xavier(blk, H, H)
    xavier(model.mean, H, L)
    xavier(model.logvar, H, L)
    xavier(model.decoder[0], L, H)
    xavier(model.output, H, D)
    return model

