"""Process-group bring-up for multi-process runs: the port's counterpart of
the JAX package's ``parallel/distributed.py`` (``maybe_initialize``,
``host_shard``).

One process per card, as ``torchrun`` starts them: each process reads its
place from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and :func:`maybe_initialize`
forms the group before anything else runs, NCCL for ``cuda`` and gloo for
``cpu``. ``torch.cuda.set_device(LOCAL_RANK)`` runs before the first CUDA
tensor exists, so a bare ``"cuda"`` names this process's card
(``core/dtypes.py::resolve_device``). Without that environment there is no
group and the run is one process; a caller may also form the group itself
(``init_process_group`` with its address, world size and rank), which
these functions then read.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) under torch.distributed, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def running_under_torchrun() -> bool:
    """Does the environment place this process in a group (torchrun's
    variables, all of them)?"""
    return all(os.environ.get(k) for k in _TORCHRUN_ENV)


def local_rank() -> int:
    """This process's card on its host (torchrun's ``LOCAL_RANK``, else 0)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_initialize(device_type: str = "cuda") -> bool:
    """Form the process group from torchrun's environment: NCCL on
    ``cuda`` (after ``torch.cuda.set_device(LOCAL_RANK)``), gloo on
    ``cpu``. Does nothing when a group exists already or the environment
    names none. Returns True when a group is active."""
    if dist.is_initialized():
        return True
    if not running_under_torchrun():
        return False
    if device_type == "cuda":
        torch.cuda.set_device(local_rank())
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device type {device_type!r}")
    dist.init_process_group(
        backend, init_method=(f"tcp://{os.environ['MASTER_ADDR']}:"
                              f"{os.environ['MASTER_PORT']}"),
        rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    rank, world = rank_and_world()
    logger.info("torch.distributed initialized: %s, process %d/%d", backend,
                rank, world)
    return True


def host_shard(n: int) -> tuple[int, int]:
    """Contiguous [lo, hi) share of ``n`` items owned by this process."""
    rank, world = rank_and_world()
    return rank * n // world, (rank + 1) * n // world
