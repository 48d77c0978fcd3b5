"""Throughput meter: the port's copy of ``Throughput`` from the JAX
package's ``utils/profiling.py`` (items/s over named phases; the sample and
minimizer modes report with it). The profiler trace is not ported yet
(ROADMAP.md Queue 1 item 15)."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict


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
