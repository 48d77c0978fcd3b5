"""The grid of ranks of the port: the counterpart of the JAX package's
``parallel/mesh.py`` (``make_mesh``, ``local_row_range``, ``shard_rows``,
``param_sharding``).

The process group is a grid of ``W = data x model`` ranks, one process per
card. As ``jax.devices()`` reshaped ``(data, model)``, the model axis
varies fastest: rank r has data index ``r // model`` and model index
``r % model``, so one node's adjacent cards share a gene axis. A trainer
on W > 1 ranks holds a :class:`Grid` of three :class:`Axis` objects: its
data group (the ranks of its model index), its model group (the ranks of
its data index) and the whole group. An :class:`Axis` keeps in one place
every collective the parallel paths need:

- ``all_reduce_`` (a sum in place) and its differentiable form
  :func:`all_reduce_sum` (the backward sums the cotangents, as
  SyncBatchNorm's does): gradients, BatchNorm statistics, the per-gene
  abundance sums, the first encoder layer's partial products over the
  gene slices, the epoch's loss sums;
- :meth:`Axis.exchange_rows`: each rank's rows of an epoch, taken from
  the ranks that hold them, once per epoch (``all_to_all_single``);
- :meth:`Axis.all_gather_rows`: the rows each rank decoded, on every
  rank, in rank order (``all_gather``);
- :meth:`Axis.all_gather_genes`: each rank's gene slice of a tensor,
  concatenated in rank order (checkpoints, the packed test-set bits).

Tensor parallelism splits the padded gene axis ``Dp`` into ``model``
contiguous slices (:func:`gene_slice`): each rank holds its slice of the
leaves :func:`gene_dim` names (``param_sharding``'s rule, JAX
``mesh.py:132-150``) and of their Adam moments, and every other leaf
whole.

Under NCCL every collective runs on device tensors. gloo has CUDA forms of
``all_reduce`` and ``broadcast`` only, so under gloo the exchange and the
gathers of CUDA tensors copy them through host memory, here and nowhere
else; the compute stays on the card. A collective that fails raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .distributed import rank_and_world

# the gene dimension of each leaf split over the model axis; a suffix, so
# that the optimizer's moments follow their parameters
GENE_DIMS = {"encoder/0/w": 0, "decoder/3/w": 1, "decoder/3/b": 0}
# a slice is a whole number of packed bytes, so the slices' bits concatenate
GENE_SLICE_ALIGN = 8


def gene_dim(path: str) -> int | None:
    """The dimension of leaf ``path`` ('/'-joined, e.g. ``encoder/0/w``)
    that is split over the model axis, or None for a replicated leaf."""
    for suffix, dim in GENE_DIMS.items():
        if path.endswith(suffix):
            return dim
    return None


def gene_slice(padded_dim: int, index: int, size: int) -> tuple[int, int]:
    """The contiguous ``[m*Dp/P, (m+1)*Dp/P)`` genes of model index m."""
    step = padded_dim // size
    return index * step, (index + 1) * step


def data_axis_size(requested: int, model: int = 1) -> int:
    """The data axis for ``--data-parallel`` beside a model axis of
    ``model`` ranks: 0 means W / model; any other value must equal it."""
    _, world = rank_and_world()
    if model < 1 or world % model:
        raise ValueError(
            f"--model-parallel {model} must divide the process group's "
            f"{world} process(es); divisors: "
            f"{[p for p in range(1, world + 1) if world % p == 0]}")
    size = world // model
    if requested == 0:
        return size
    if requested != size:
        raise ValueError(
            f"--data-parallel {requested}: the data axis is the process "
            f"group over the model axis, {world} process(es) / "
            f"{model}; pass 0 or {size} (start one process per card, e.g. "
            "with torchrun)")
    return size


def check_gene_slices(padded_dim: int, model: int) -> None:
    """Under a model axis the padded gene axis must split into ``model``
    slices of whole multiples of 8 genes; raises naming the model sizes
    that would."""
    if model > 1 and padded_dim % (model * GENE_SLICE_ALIGN):
        _, world = rank_and_world()
        fits = [p for p in range(1, world + 1) if world % p == 0 and (
            p == 1 or padded_dim % (p * GENE_SLICE_ALIGN) == 0)]
        raise ValueError(
            f"--model-parallel {model}: the padded gene axis of {padded_dim} "
            f"does not split into {model} slices of whole multiples of "
            f"{GENE_SLICE_ALIGN} genes; model sizes that would, dividing the "
            f"{world} process(es): {fits}")


def local_row_range(n: int, rank: int | None = None,
                    world: int | None = None) -> tuple[int, int]:
    """The contiguous ``[r*n//W, (r+1)*n//W)`` rows of rank r."""
    if rank is None or world is None:
        rank, world = rank_and_world()
    return rank * n // world, (rank + 1) * n // world


@dataclasses.dataclass(frozen=True)
class Axis:
    """Ranks of the process group along one axis: this rank's place
    ``rank`` of ``world``, and their ``group`` (None: the whole group). An
    axis of one rank runs no collective."""

    rank: int
    world: int
    group: Any = None

    @classmethod
    def from_group(cls) -> "Axis":
        rank, world = rank_and_world()
        return cls(rank, world)

    @property
    def _via_host(self) -> bool:
        return dist.get_backend() == "gloo"

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (on the device under either
        backend); returns it."""
        if self.world > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def share(self, n: int) -> tuple[int, int]:
        return local_row_range(n, self.rank, self.world)

    def exchange_rows(self, local: torch.Tensor, n: int,
                      need: Sequence[torch.Tensor]) -> torch.Tensor:
        """Rows of an ``n``-row set held in contiguous shares
        (:func:`local_row_range`; ``local`` is this rank's) to the ranks
        that use them: ``need[q]`` is the int64 list of global rows rank q
        uses, in its order, the same on every rank. Returns this rank's
        ``local[need[rank]]`` rows, gathered from their holders in one
        ``all_to_all_single`` (rows travel as bytes)."""
        dev = local.device
        if self.world == 1:
            return local.index_select(0, need[0].to(dev))
        # the end of every share but the last: a row's owner is the number
        # of ends at or below it
        bounds = torch.tensor([local_row_range(n, q, self.world)[1]
                               for q in range(self.world - 1)],
                              dtype=torch.int64, device=dev)
        lo = self.share(n)[0]
        owner = lambda ids: torch.bucketize(ids, bounds, right=True)  # noqa: E731
        sends = []
        for q in range(self.world):
            ids = need[q].to(dev)
            sends.append(ids[owner(ids) == self.rank] - lo)
        send_idx = torch.cat(sends)
        mine = need[self.rank].to(dev)
        own = owner(mine)
        recv_counts = torch.bincount(own, minlength=self.world).tolist()
        send_counts = [int(s.numel()) for s in sends]
        row = local.shape[1] * local.element_size()
        inp = local.index_select(0, send_idx).contiguous().view(torch.uint8)
        out = torch.empty((sum(recv_counts), row), dtype=torch.uint8, device=dev)
        if self._via_host and dev.type == "cuda":
            out_h = torch.empty(out.shape, dtype=torch.uint8)
            dist.all_to_all_single(out_h, inp.cpu(), recv_counts, send_counts,
                                   group=self.group)
            out.copy_(out_h)
        else:
            dist.all_to_all_single(out, inp, recv_counts, send_counts,
                                   group=self.group)
        rows = torch.empty((mine.numel(), row), dtype=torch.uint8, device=dev)
        rows[torch.argsort(own, stable=True)] = out
        return rows.view(local.dtype).reshape(mine.numel(), *local.shape[1:])

    def _all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (one shape on every rank), in rank order, on
        ``t``'s device."""
        host = self._via_host and t.device.type == "cuda"
        src = t.cpu() if host else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        return [p.to(t.device) for p in parts] if host else parts

    def all_gather_rows(self, t: torch.Tensor,
                        counts: Sequence[int]) -> torch.Tensor:
        """Every rank's rows (rank q contributes ``counts[q]`` rows of
        ``t``'s width), concatenated in rank order, on every rank."""
        width = tuple(t.shape[1:])
        pad = torch.zeros((max(counts),) + width, dtype=t.dtype, device=t.device)
        pad[: t.shape[0]] = t
        return torch.cat([p[:c] for p, c in zip(self._all_gather(pad), counts)])

    def all_gather_genes(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's slice ``t`` (one shape on every rank) concatenated
        along ``dim`` in rank order, on every rank."""
        if self.world == 1:
            return t
        return torch.cat(self._all_gather(t), dim=dim)


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the ``data x model`` grid: its data group (the
    ranks that hold its gene slice, one per row share), its model group
    (the ranks that hold its rows, one per gene slice) and every rank."""

    data: Axis
    model: Axis
    everyone: Axis

    def holds_slice(self, path: str) -> bool:
        """Does this rank hold only its gene slice of leaf ``path``?"""
        return self.model.world > 1 and gene_dim(path) is not None


def make_grid(data_parallel: int, model_parallel: int,
              padded_dim: int) -> Grid | None:
    """The grid for ``--data-parallel`` / ``--model-parallel`` (JAX
    ``make_mesh``), None on one process. Every rank forms every subgroup
    (``dist.new_group``), in the same order: the data groups, then the
    model groups."""
    data = data_axis_size(data_parallel, model_parallel)
    check_gene_slices(padded_dim, model_parallel)
    rank, world = rank_and_world()
    if world == 1:
        return None
    everyone = Axis(rank, world)
    P = model_parallel
    if P == 1:
        return Grid(everyone, Axis(0, 1), everyone)
    if data == 1:
        return Grid(Axis(0, 1), everyone, everyone)
    data_groups = [dist.new_group([d * P + m for d in range(data)])
                   for m in range(P)]
    model_groups = [dist.new_group([d * P + m for m in range(P)])
                    for d in range(data)]
    d, m = divmod(rank, P)
    return Grid(Axis(d, data, data_groups[m]), Axis(m, P, model_groups[d]),
                everyone)


def gather_genes(flat: Dict[str, torch.Tensor],
                 axis: Axis | None) -> Dict[str, torch.Tensor]:
    """The full leaves of ``flat`` ({path: tensor}): each gene-sliced leaf
    all-gathered over the model ``axis``. A collective: every rank of the
    axis calls it, with the same paths in the same order."""
    if axis is None or axis.world == 1:
        return flat
    return {k: (v if gene_dim(k) is None
                else axis.all_gather_genes(v.detach(), gene_dim(k)))
            for k, v in flat.items()}


def slice_genes(flat: Dict[str, Any], genes: tuple[int, int]
                ) -> Dict[str, np.ndarray]:
    """``flat``'s full leaves ({path: array}) cut to the gene slice
    ``genes`` = (lo, hi) where :func:`gene_dim` names a gene dimension."""
    lo, hi = genes
    out = {}
    for k, v in flat.items():
        v, dim = np.asarray(v), gene_dim(k)
        out[k] = v if dim is None else np.take(v, np.arange(lo, hi), axis=dim)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.clone()), None


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the cotangent of
    each rank's input is the sum of every rank's output cotangent (each
    rank's loss is one term of the global loss)."""
    return _AllReduceSum.apply(x, axis)


@dataclasses.dataclass(frozen=True)
class RowShare:
    """This rank's rows ``[offset, offset + m)`` of a global batch of
    ``total`` rows, on the data axis ``axis``, and the ``model`` axis over
    which its gene slices lie (None: no model axis): what BatchNorm, the
    noise draw and the losses need to compute over the global batch."""

    axis: Axis
    offset: int
    total: int
    model: Axis | None = None
