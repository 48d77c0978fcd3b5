"""Tracing and throughput: the port of the JAX package's
``utils/profiling.py``.

:func:`trace` records the enclosed block with ``torch.profiler`` (host
operations, and the card's kernels and copies where CUDA is present) when
a directory is given, as an argument (``profile_dir``, ``--profile-dir``)
or in ``GM2_PROFILE_DIR``, and writes one Chrome / TensorBoard trace file
per process there, ``gm2_rank{r}.<time>.pt.trace.json`` (open it in
chrome://tracing or Perfetto, or point TensorBoard at the directory). The
trainer marks its phases with ``record_function`` ranges, ``gm2/shuffle``,
``gm2/train_step``, ``gm2/validation`` and ``gm2/checkpoint``, so the
trace reads by phase. ``Throughput`` is the windowed items/s meter the
sample and minimizer modes report with.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict

PROFILE_ENV = "GM2_PROFILE_DIR"


@contextlib.contextmanager
def trace(profile_dir: str | None = None):
    """Profile the enclosed block if a directory is given (argument or
    ``GM2_PROFILE_DIR``); no-op otherwise."""
    profile_dir = profile_dir or os.environ.get(PROFILE_ENV)
    if not profile_dir:
        yield
        return
    from torch import profiler

    from ..parallel.distributed import rank_and_world

    os.makedirs(profile_dir, exist_ok=True)
    handler = profiler.tensorboard_trace_handler(
        profile_dir, worker_name=f"gm2_rank{rank_and_world()[0]}")
    with profiler.profile(activities=sorted(profiler.supported_activities(),
                                            key=str),
                          on_trace_ready=handler):
        yield


@dataclass
class Throughput:
    """Windowed throughput meter: items/s over named phases."""

    counts: Dict[str, float] = field(default_factory=dict)
    seconds: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, items: float):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, items, time.perf_counter() - t0)

    def add(self, name: str, items: float, seconds: float) -> None:
        """Record a phase measured externally (item count known only after)."""
        self.counts[name] = self.counts.get(name, 0.0) + items
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def rate(self, name: str) -> float:
        return self.counts.get(name, 0.0) / max(self.seconds.get(name, 0.0), 1e-12)

    def report(self) -> str:
        return "\n".join(f"{name}: {self.rate(name):,.1f}/s "
                         f"({self.counts[name]:,.0f} in {self.seconds[name]:.2f}s)"
                         for name in self.counts)
