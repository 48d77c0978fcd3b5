"""VAE loss components: the port of the JAX package's ``ops/losses.py``
(:36-227), with its quirks:

- reconstruction: BCE summed over all elements in the stable logits form,
  masked over the padded gene columns; it goes through
  :func:`ops.output_layer.output_layer_bce`, whose backward is the
  ``output_layer_bwd`` kernel;
- KL: -0.5 * sum(1 + logvar - mu^2 - exp(logvar)) with linear / cosine /
  constant beta schedules; the cosine one uses ``t = epoch*32 + counter``
  where the counter counts every loss evaluation, validation included;
- gene abundance: weight * gamma * sum(|sum_batch(sigmoid(logits))|) with
  linear gamma annealing;
- L1 / L2 over all trainable parameters; ``abs`` has torch's sign(0) = 0
  subgradient, the JAX package's ``_abs_torch_subgrad``.

Schedules of the epoch are computed on the host in float32 (the epoch is
a host integer); the counter stays on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from ..parallel.mesh import RowShare, all_reduce_sum
from .output_layer import bce_sum_logits, output_layer_bce  # noqa: F401

RECONSTRUCTION = "reconstruction"
KL_DIVERGENCE = "kl_divergence"
GENE_ABUNDANCE = "gene_abundance"
L1_REGULARIZATION = "l1_regularization"
L2_REGULARIZATION = "l2_regularization"
TOTAL = "total"


@dataclasses.dataclass(frozen=True)
class LossSpec:
    """Static description of the active loss components for one trainer preset."""

    n_epochs: int
    # KL
    scheduler_type: str = "linear"  # 'linear' | 'cosine' | 'constant'
    min_beta: float = 0.0
    max_beta: float = 1.0
    T: int = 10
    # abundance
    use_abundance: bool = False
    gamma_start: float = 0.0
    gamma_end: float = 1.0
    weight: float = 1.0
    # regularization
    lambda_l1: float = 0.0
    use_l1: bool = False
    lambda_l2: float = 0.0
    use_l2: bool = False

    def component_names(self) -> tuple[str, ...]:
        names = [RECONSTRUCTION, KL_DIVERGENCE]
        if self.use_abundance:
            names.append(GENE_ABUNDANCE)
        if self.use_l1:
            names.append(L1_REGULARIZATION)
        if self.use_l2:
            names.append(L2_REGULARIZATION)
        names.append(TOTAL)
        return tuple(names)


def spec_for_preset(version: str, cfg) -> LossSpec:
    """Loss bundle per trainer preset (reference: trainer.py:193-257);
    min_beta/max_beta are the linear presets' beta_start/beta_end."""
    common = dict(n_epochs=cfg.n_epochs, min_beta=cfg.min_beta, max_beta=cfg.max_beta)
    if version == "v0":
        return LossSpec(scheduler_type="linear", **common)
    if version == "v1":
        return LossSpec(
            scheduler_type="linear", use_abundance=True,
            gamma_start=cfg.gamma_start, gamma_end=cfg.gamma_end,
            use_l1=True, lambda_l1=cfg.lambda_l1, **common)
    if version == "v2":
        return LossSpec(
            scheduler_type="cosine", T=10, use_abundance=True,
            gamma_start=cfg.gamma_start, gamma_end=cfg.gamma_end,
            use_l1=True, lambda_l1=cfg.lambda_l1, **common)
    if version == "v3":
        return LossSpec(
            scheduler_type="cosine", T=50, use_abundance=True,
            gamma_start=cfg.gamma_start, gamma_end=cfg.gamma_end,
            weight=cfg.weight, use_l1=True, lambda_l1=cfg.lambda_l1, **common)
    raise ValueError(f"Unknown trainer version: {version}")


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

def kl_divergence(mu, logvar) -> torch.Tensor:
    """-0.5 * sum(1 + logvar - mu^2 - exp(logvar)) (loss_components.py:77)."""
    return -0.5 * (1.0 + logvar - mu.square() - torch.exp(logvar)).sum()


def _linear(start: float, end: float, epoch: int, n_epochs: int) -> float:
    """start + (end - start) * epoch / n_epochs in float32 ops, as the JAX
    package computes it with a traced int32 epoch."""
    f = np.float32
    return float(f(start) + (f(end - start) * f(epoch)) / f(n_epochs))


def beta_schedule(spec: LossSpec, epoch: int, counter: torch.Tensor):
    """Beta at (epoch, counter): a float for the linear and constant
    schedules, a device tensor for the cosine one (its counter lives on the
    device)."""
    if spec.scheduler_type == "linear":
        return _linear(spec.min_beta, spec.max_beta, epoch, spec.n_epochs)
    if spec.scheduler_type == "cosine":
        t = (epoch * 32 + counter.to(torch.int32)) % spec.T
        phase = torch.cos(float(np.float32(math.pi)) * t.float() / float(spec.T))
        amp = float(np.float32(spec.max_beta - spec.min_beta) / np.float32(2.0))
        return spec.min_beta + amp * (1.0 + phase)
    return float(np.float32(spec.max_beta))


def gamma_schedule(spec: LossSpec, epoch: int) -> float:
    return _linear(spec.gamma_start, spec.gamma_end, epoch, spec.n_epochs)


def gene_abundance(logits, feature_mask, share: RowShare | None = None
                   ) -> torch.Tensor:
    """sum(|sum over batch of recon probabilities|) (loss_components.py:113-114).
    Under a :class:`RowShare` the per-gene sums are the global batch's,
    all-reduced before the ``abs``."""
    col = (torch.sigmoid(logits.float()) * feature_mask).sum(dim=0)
    if share is not None:
        col = all_reduce_sum(col, share.axis)
    return col.abs().sum()


def _leaf_sum(values: Iterable[torch.Tensor]) -> torch.Tensor:
    """Python's ``sum``: 0 + s1 + s2 + ..., in leaf order."""
    total = None
    for v in values:
        total = v if total is None else total + v
    return total


def l1_penalty(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """sum |p| over all trainable params; d|p|/dp = sign(p), sign(0) = 0,
    so padding neither contributes nor receives gradient."""
    return _leaf_sum(p.abs().sum() for p in params)


def l2_penalty(params: Iterable[torch.Tensor]) -> torch.Tensor:
    return _leaf_sum(p.square().sum() for p in params)


def compute_losses(
    spec: LossSpec,
    params: Dict[str, torch.Tensor],
    h: torch.Tensor,
    data: torch.Tensor,
    mu: torch.Tensor,
    logvar: torch.Tensor,
    epoch: int,
    counter: torch.Tensor,
    feature_mask: torch.Tensor,
    policy,
    share: RowShare | None = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss + per-component dict for one batch. ``params`` is the
    model's ``flat_params()`` (JAX leaf order; ``decoder/3/{w,b}`` is the
    output layer), ``h`` the decoder's last hidden activations.

    Under a :class:`RowShare` (W > 1 data-parallel ranks, ``h`` and
    ``data`` this rank's rows of the global batch) each component is this
    rank's term of the global one, so that the terms sum to it over the
    ranks, and so do the gradients: the reconstruction and KL sums over its
    rows; the gene abundance of the global batch, and the L1 / L2 terms,
    which are functions of the parameters, on rank 0 only (every rank still
    runs the abundance's all-reduce, forward and backward)."""
    comps: Dict[str, torch.Tensor] = {}
    bce, logits = output_layer_bce(h, params["decoder/3/w"], params["decoder/3/b"],
                                   data, feature_mask, policy)
    comps[RECONSTRUCTION] = bce
    comps[KL_DIVERGENCE] = beta_schedule(spec, epoch, counter) * kl_divergence(mu, logvar)
    counted = share is None or share.axis.rank == 0
    if spec.use_abundance:
        scale = float(np.float32(spec.weight) * np.float32(gamma_schedule(spec, epoch)))
        abundance = scale * gene_abundance(logits, feature_mask, share)
        comps[GENE_ABUNDANCE] = abundance if counted else abundance * 0.0
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    if spec.use_l1:
        comps[L1_REGULARIZATION] = (
            zero if spec.lambda_l1 == 0.0 or not counted
            else spec.lambda_l1 * l1_penalty(params.values()))
    if spec.use_l2:
        comps[L2_REGULARIZATION] = (
            zero if spec.lambda_l2 == 0.0 or not counted
            else spec.lambda_l2 * l2_penalty(params.values()))
    total = zero
    for v in comps.values():
        total = total + v
    comps[TOTAL] = total
    return total, comps
