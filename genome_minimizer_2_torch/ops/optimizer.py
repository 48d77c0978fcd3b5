"""Fused clip-by-global-norm + Adam + apply: the port of the JAX package's
``ops/optimizer.py`` (:43-99), the update its trainer applies every step.

The global norm (float32 sum of squares over all leaves, in leaf order) is
computed outside the kernel, on the device, as JAX does; the bias
corrections come from the step count on the device; the per-leaf update is
the ``clip_adam_apply`` kernel (``ops/kernels.py``), one launch per leaf,
which reads norm, bc1, bc2 and lr from device memory, so a step never
waits on the host. The update is in place (the JAX version returns new
arrays): params, m and v keep their storage from step to step.

The state mirrors optax's ``(EmptyState, ScaleByAdamState(count, mu,
nu))``: an int32 count and first/second moments per parameter path.
Moments are stored in float32 or bf16 (the compute dtype on CUDA under
``adam_state_dtype='auto'``) with float32 update math; on the CPU they are
float32 and the update follows the optax chain's op order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

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


def global_norm(grads) -> torch.Tensor:
    """sqrt(0 + sum(g1^2) + sum(g2^2) + ...) in float32 (optax.global_norm;
    the root through float64 is the correctly rounded float32 root)."""
    total = None
    for g in grads:
        s = g.float().square().sum()
        total = s if total is None else total + s
    return total.double().sqrt().float()


def bias_corrections(count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^count, 1 - b2^count) in float32 for the incremented count.
    The powers are taken in float64 and rounded to float32, which equals
    XLA's float32 pow for every count below 2,957 (both corrections)."""
    c = count.double()
    bc = [1.0 - torch.pow(torch.tensor(float(np.float32(b)), dtype=torch.float64,
                                       device=count.device), c).float()
          for b in (K.ADAM_B1, K.ADAM_B2)]
    return bc[0], bc[1]


@torch.no_grad()
def clip_adam_step(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], state: AdamState,
                   lr: torch.Tensor, max_norm: float,
                   apply_leaf=K.clip_adam_apply) -> None:
    """One optimizer step in place: ``state.count`` += 1 (saturating, as
    optax.safe_increment), then every leaf through ``apply_leaf`` (the
    ``clip_adam_apply`` kernel; its plain version for a check). ``lr`` is a
    float32 0-dim tensor on the device."""
    count = torch.where(state.count < _INT32_MAX, state.count + 1, state.count)
    bc1, bc2 = bias_corrections(count)
    norm = global_norm(grads[k] for k in params)
    scalars = torch.stack([norm, bc1, bc2, lr.float()]).contiguous()
    for k, p in params.items():
        apply_leaf(grads[k].float().contiguous(), state.mu[k], state.nu[k],
                   p.data, scalars, max_norm)
    state.count = count
