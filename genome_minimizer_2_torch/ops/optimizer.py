"""Fused clip-by-global-norm + Adam + apply: the port of the JAX package's
``ops/optimizer.py`` (:43-99), the update its trainer applies every step.

The global norm (float32 sum of squares over all leaves, in leaf order) is
computed outside the kernel, on the device, as JAX does; the bias
corrections come from the step count on the device; the update is the
``clip_adam_apply_leaves`` kernel (``ops/kernels.py``), one launch over
every leaf, which reads norm, bc1, bc2 and lr from device memory, so a
step never waits on the host. The update is in place (the JAX version
returns new arrays): params, m and v keep their storage from step to step.

The state mirrors optax's ``(EmptyState, ScaleByAdamState(count, mu,
nu))``: an int32 count and first/second moments per parameter path.
Moments are stored in float32 or bf16 (the compute dtype on CUDA under
``adam_state_dtype='auto'``) with float32 update math; on the CPU they are
float32 and the update follows the optax chain's op order.
"""

from __future__ import annotations

import dataclasses
import functools
from decimal import Decimal, localcontext
from typing import Dict

import numpy as np
import torch

from ..parallel.mesh import Axis, gene_dim
from ..utils.profiling import span
from . import kernels as K

_INT32_MAX = 2 ** 31 - 1


@dataclasses.dataclass
class AdamState:
    count: torch.Tensor              # int32, 0-dim, on the device
    mu: Dict[str, torch.Tensor]      # first moments by parameter path
    nu: Dict[str, torch.Tensor]      # second moments by parameter path

    @classmethod
    def zeros(cls, params: Dict[str, torch.Tensor],
              moment_dtype: torch.dtype) -> "AdamState":
        device = next(iter(params.values())).device
        new = lambda: {k: torch.zeros(p.shape, dtype=moment_dtype, device=device)
                       for k, p in params.items()}
        return cls(torch.zeros((), dtype=torch.int32, device=device), new(), new())


def global_norm(grads: Dict[str, torch.Tensor],
                gene_axis: Axis | None = None) -> torch.Tensor:
    """sqrt(0 + sum(g1^2) + sum(g2^2) + ...) over the leaves {path: grad}
    in leaf order, in float32 (optax.global_norm; the root through float64
    is the correctly rounded float32 root). With ``gene_axis`` (tensor
    parallelism) the gene-sliced leaves' sums of squares are summed over
    that model axis, in one all-reduce; every other leaf, the same on
    every rank, counts once."""
    squares = {k: g.float().square().sum() for k, g in grads.items()}
    if gene_axis is not None and gene_axis.world > 1:
        sliced = [k for k in squares if gene_dim(k) is not None]
        summed = gene_axis.all_reduce_(torch.stack([squares[k] for k in sliced]))
        squares.update(zip(sliced, summed.unbind()))
    total = None
    for s in squares.values():
        total = s if total is None else total + s
    return total.double().sqrt().float()


# XLA's CPU backend lowers the float32 ``b ** count`` of the JAX optimizer
# (``pow`` of a weak float and an int32 count, the count converted to
# float32) to a call of the C library's ``powf``. glibc's powf (e_powf.c,
# the x86-64 FMA build) takes log2(b) from a 16-entry table and a degree-5
# polynomial, multiplies by the exponent in float64, and evaluates exp2 of
# that from a 32-entry table of 2^(j/32) and a cubic, then rounds once to
# float32. That is not the correctly rounded power: at b2 = 0.999 it
# differs from a float64 power rounded to float32 at counts 2,958 and 3,606.
# :func:`bias_corrections` runs the same float64 steps. log2(b) depends on b
# alone, so it is a constant here (glibc's own value for each float32 b).
_POWF_LOG2 = {K.ADAM_B1: float.fromhex("-0x1.374d6afb0f10bp-3"),
              K.ADAM_B2: float.fromhex("-0x1.7a60d193ca756p-10")}
_EXP2_SHIFT = float.fromhex("0x1.8p+47")  # rounds x to a multiple of 1/32
_EXP2_POLY = [float.fromhex(c) for c in (
    "0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3", "0x1.62e42ff0c52d6p-1")]
with localcontext() as _ctx:  # the correctly rounded float64 2^(j/32), j < 32
    _ctx.prec = 40              # (glibc's table), as their bits
    _EXP2_BITS = [int(np.float64(float(Decimal(2) ** (Decimal(j) / 32))).view(np.int64))
                  for j in range(32)]


@functools.lru_cache(maxsize=None)
def _exp2_table(device: torch.device) -> torch.Tensor:
    """The table on the device, copied there once: a copy from pageable host
    memory waits for the stream, and a step must not; a captured CUDA graph
    cannot hold one either, so the trainer's first (eager) epoch makes it
    before any capture."""
    return torch.tensor(_EXP2_BITS, dtype=torch.int64, device=device)


def _powf(b: float, count: torch.Tensor) -> torch.Tensor:
    """float32 ``b ** count`` as glibc's powf computes it (b = ADAM_B1 or
    ADAM_B2, int32 count >= 1), in float64 tensor ops on count's device."""
    xd = count.float().double() * _POWF_LOG2[b]
    kd = (xd + _EXP2_SHIFT) - _EXP2_SHIFT
    r = xd - kd
    n = (kd * 32).to(torch.int64)
    j = torch.remainder(n, 32)
    e = torch.div(n - j, 32, rounding_mode="floor")
    # torch.take: indexing by a 0-dim tensor (``table[j]``) reads j on the
    # host, a wait for the stream that a captured graph cannot hold
    s = (torch.take(_exp2_table(count.device), j)
         + e * (1 << 52)).view(torch.float64)  # 2^(n/32)
    c0, c1, c2 = _EXP2_POLY
    y = (c0 * r + c1) * (r * r) + (c2 * r + 1.0)
    p = (y * s).float()
    return torch.where(xd <= -150.0, torch.zeros_like(p), p)  # underflow


def bias_corrections(count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^count, 1 - b2^count) in float32 for the incremented count,
    equal to XLA's float32 result on the CPU (glibc's powf, above; tests/
    test_torch_train_ops.py checks every count from 1 to 300,000)."""
    return tuple(1.0 - _powf(b, count) for b in (K.ADAM_B1, K.ADAM_B2))


@torch.no_grad()
def clip_adam_step(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], state: AdamState,
                   lr: torch.Tensor, max_norm: float,
                   apply_leaves=K.clip_adam_apply_leaves,
                   gene_axis: Axis | None = None) -> None:
    """One optimizer step in place: ``state.count`` += 1 in its storage
    (saturating, as optax.safe_increment), then every leaf through
    ``apply_leaves`` (the ``clip_adam_apply_leaves`` kernel, one launch;
    its plain version for a check). ``lr`` is a float32 0-dim tensor on
    the device. Under tensor parallelism the leaves are what this rank
    holds and ``gene_axis`` is the model axis of the global norm
    (:func:`global_norm`)."""
    with span("gm2/step/update"):
        count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
        bc1, bc2 = bias_corrections(count)
    with span("gm2/step/clip_norm"):
        norm = global_norm({k: grads[k] for k in params}, gene_axis)
    with span("gm2/step/update"):
        scalars = torch.stack([norm, bc1, bc2, lr.float()]).contiguous()
        apply_leaves([grads[k].float().contiguous() for k in params],
                     [state.mu[k] for k in params], [state.nu[k] for k in params],
                     [p.data for p in params.values()], scalars, max_norm)
        state.count.copy_(count)
