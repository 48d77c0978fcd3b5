"""Process rank and count for multi-process runs (the port's counterpart of
the JAX package's ``parallel/distributed.py``): taken from torch.distributed
when a process group is initialized, else a single process. The caller
initializes the group itself (``init_process_group`` with its address,
world size and rank)."""

from __future__ import annotations

import torch.distributed as dist


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) under torch.distributed, else (0, 1)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
