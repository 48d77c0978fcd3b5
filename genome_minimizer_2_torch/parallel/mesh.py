"""The data axis of the port: the counterpart of the JAX package's
``parallel/mesh.py`` (``make_mesh``, ``local_row_range``, ``shard_rows``).

The port's data axis is the process group, one process per card. A
trainer or sampler on W > 1 ranks holds a :class:`DataAxis`, which keeps in
one place every collective the data-parallel paths need:

- ``all_reduce_`` (a sum in place) and its differentiable form
  :func:`all_reduce_sum` (the backward sums the cotangents, as
  SyncBatchNorm's does): gradients, BatchNorm statistics, the per-gene
  abundance sums, the epoch's loss sums;
- :meth:`DataAxis.exchange_rows`: each rank's rows of an epoch, taken from
  the ranks that hold them, once per epoch (``all_to_all_single``);
- :meth:`DataAxis.all_gather_rows`: the rows each rank decoded, on every
  rank, in rank order (``all_gather``).

Under NCCL every collective runs on device tensors. gloo has CUDA forms of
``all_reduce`` and ``broadcast`` only, so under gloo the exchange and the
gather of CUDA tensors copy them through host memory, here and nowhere
else; the compute stays on the card. A collective that fails raises.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch
import torch.distributed as dist

from .distributed import rank_and_world

TENSOR_PARALLEL_ITEM = ("model parallelism (--model-parallel > 1, the gene "
                        "axis split over cards) is not ported yet (ROADMAP.md "
                        "Queue 1 item 14d); set model_parallel=1")


def data_axis_size(requested: int) -> int:
    """The data axis for ``--data-parallel``: 0 means the group's size W;
    any other value must equal W (one process per card)."""
    _, world = rank_and_world()
    if requested == 0:
        return world
    if requested != world:
        raise ValueError(
            f"--data-parallel {requested}: the data axis is the process "
            f"group, which has {world} process(es); pass 0 or {world} (start "
            "one process per card, e.g. with torchrun)")
    return world


def check_model_parallel(requested: int) -> None:
    if requested != 1:
        raise NotImplementedError(TENSOR_PARALLEL_ITEM)


def local_row_range(n: int, rank: int | None = None,
                    world: int | None = None) -> tuple[int, int]:
    """The contiguous ``[r*n//W, (r+1)*n//W)`` rows of rank r."""
    if rank is None or world is None:
        rank, world = rank_and_world()
    return rank * n // world, (rank + 1) * n // world


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The W > 1 ranks of the process group as the data axis."""

    rank: int
    world: int

    @classmethod
    def from_group(cls) -> "DataAxis":
        rank, world = rank_and_world()
        return cls(rank, world)

    @property
    def _via_host(self) -> bool:
        return dist.get_backend() == "gloo"

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place (on the device under either
        backend); returns it."""
        dist.all_reduce(t)
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
            dist.all_to_all_single(out_h, inp.cpu(), recv_counts, send_counts)
            out.copy_(out_h)
        else:
            dist.all_to_all_single(out, inp, recv_counts, send_counts)
        rows = torch.empty((mine.numel(), row), dtype=torch.uint8, device=dev)
        rows[torch.argsort(own, stable=True)] = out
        return rows.view(local.dtype).reshape(mine.numel(), *local.shape[1:])

    def all_gather_rows(self, t: torch.Tensor,
                        counts: Sequence[int]) -> torch.Tensor:
        """Every rank's rows (rank q contributes ``counts[q]`` rows of
        ``t``'s width), concatenated in rank order, on every rank."""
        width = tuple(t.shape[1:])
        most = max(counts)
        pad = torch.zeros((most,) + width, dtype=t.dtype, device=t.device)
        pad[: t.shape[0]] = t
        host = self._via_host and t.device.type == "cuda"
        src = pad.cpu() if host else pad
        parts: List[torch.Tensor] = [torch.empty_like(src)
                                     for _ in range(self.world)]
        dist.all_gather(parts, src)
        out = torch.cat([p[:c] for p, c in zip(parts, counts)])
        return out.to(t.device) if host else out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce_(g.clone()), None


def all_reduce_sum(x: torch.Tensor, axis: DataAxis) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the cotangent of
    each rank's input is the sum of every rank's output cotangent (each
    rank's loss is one term of the global loss)."""
    return _AllReduceSum.apply(x, axis)


@dataclasses.dataclass(frozen=True)
class RowShare:
    """This rank's rows ``[offset, offset + m)`` of a global batch of
    ``total`` rows, on the data axis ``axis``: what BatchNorm, the noise
    draw and the losses need to compute over the global batch."""

    axis: DataAxis
    offset: int
    total: int
