"""A traced slice of a run: torch.profiler over the last few epochs or calls
after the window, its Chrome trace written under ``TMPDIR``, read and
deleted, and reduced to what the per-layer metrics read.

The device is busy where any kernel, copy or fill runs: the union of those
spans, as ``chip_smoke.py::device_busy`` takes it. An idle gap is a stretch
between two of the union's spans; it is named by the innermost range the
host was in (the program's ``gm2/*`` ranges, the benchmark's own
``portbench/*``) and the runtime call it was making, if any.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each list of the breakdown


class Slice:
    """The profiler over a slice of the run: ``start()``, the work,
    ``stop()`` (both synchronise; ``seconds`` is the slice's host time),
    then ``events()``."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.seconds = None

    def start(self) -> None:
        self._torch.cuda.synchronize()
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        self._prof.stop()

    def events(self) -> list:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


def union(spans) -> list[tuple[float, float]]:
    """Sorted (start, end) spans merged where they overlap or touch."""
    out: list[list[float]] = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def _labels(times: list, host: list) -> list[str]:
    """For each of the sorted ``times``, the innermost host range around it
    and, inside it, the runtime call in progress: one sweep over the host
    events sorted by start."""
    host = sorted(host)
    active: list = []
    out, i = [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [e for e in active if e[1] > t]
        ranges = [e for e in active if e[3] == "range"]
        calls = [e for e in active if e[3] == "runtime"]
        name = min(ranges, key=lambda e: e[1] - e[0])[2] if ranges else "no range"
        if calls:
            name += " > " + min(calls, key=lambda e: e[1] - e[0])[2]
        out.append(name)
    return out


def summarize(events: list) -> dict:
    """Busy seconds, device time by kernel name, and idle time by what the
    host was doing, from Chrome trace events (us)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity")
    by_name: dict = {}
    for e in dev:
        tot, cnt = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + e["dur"] / 1e6, cnt + 1)
    merged = union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy = sum(b - a for a, b in merged) / 1e6
    host = [(e["ts"], e["ts"] + e["dur"], e["name"],
             "range" if e.get("cat") == "user_annotation" else "runtime")
            for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in ("user_annotation", "cuda_runtime", "cuda_driver")]
    gaps = [(end, start) for (_, end), (start, _) in zip(merged, merged[1:])]
    idle: dict = {}
    for (end, start), label in zip(gaps, _labels([g[0] for g in gaps], host)):
        idle[label] = idle.get(label, 0.0) + (start - end) / 1e6
    return {"busy_s": busy, "kernels": by_name, "idle": idle}


def breakdown(summary: dict) -> dict:
    top = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:TOP]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[name[:120], s] for name, (s, _) in top],
            "idle_gaps": [[name[:120], s] for name, s in gaps]}


def kernel_seconds(summary: dict, patterns) -> float:
    """Device seconds of the kernels whose names hold any of ``patterns``."""
    return sum(s for name, (s, _) in summary["kernels"].items()
               if any(p in name for p in patterns))
