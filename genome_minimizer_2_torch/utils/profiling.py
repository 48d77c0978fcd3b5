"""Tracing and throughput: the port of the JAX package's
``utils/profiling.py``, with the port's own ranges and their reducer.

:func:`trace` records the enclosed block with ``torch.profiler`` (host
operations, and the card's kernels and copies where CUDA is present) when
a directory is given, as an argument (``profile_dir``, ``--profile-dir``)
or in ``GM2_PROFILE_DIR``, and writes one Chrome / TensorBoard trace file
per process there, ``gm2_rank{r}.<time>.pt.trace.json`` (open it in
chrome://tracing or Perfetto, or point TensorBoard at the directory).

The port marks its layers with :func:`span` ranges, ``record_function``
ranges while a profiler runs and a shared no-op otherwise:

- the trainer: ``gm2/shuffle``, ``gm2/train_step``, ``gm2/validation``,
  ``gm2/checkpoint``, ``gm2/epoch_begin`` (the epoch's device scalars),
  ``gm2/epoch_sync`` (its one host sync), and on a card ``gm2/warm_epoch``
  (a program's first, eager epoch) and ``gm2/capture``. A training
  epoch, eager or a replay of its CUDA graphs, is one ``gm2/shuffle``
  then one ``gm2/train_step`` over all its steps;
- the eager step's phases: ``gm2/step/forward`` (key split, encoder,
  noise, decoder, bf16 weight casts), ``gm2/step/loss`` with
  ``gm2/step/loss/{reconstruction,kl,abundance,l1,l2}`` inside it,
  ``gm2/step/backward``, ``gm2/step/clip_norm``, ``gm2/step/update``
  (bias corrections, gradient copies, clip + Adam, the count) and
  ``gm2/step/stats`` (BatchNorm statistics, counter, key);
- the sampler, every chunked mode: ``gm2/sample/draw``,
  ``gm2/sample/submit`` (a chunk's latents to the card, its decode and
  the copy to pinned memory), ``gm2/sample/wait``, ``gm2/sample/on_chunk``
  (the caller's callback), ``gm2/sample/count_genes`` and
  ``gm2/sample/count_essential``, all inside ``gm2/sample/chunks`` (the
  chunk loop, the host's steps between those stages included).

:func:`device_by_range` puts every kernel, copy and fill of a trace under
the innermost ``gm2/`` range of the runtime call that launched it, and a
backward kernel under the range of the forward op autograd links it to;
``python -m genome_minimizer_2_torch.utils.profiling TRACE.json`` prints
that table. :func:`step_phases` traces eager train steps on a copy of a
state and returns the table a step. ``Throughput`` is the windowed
items/s meter the sample and minimizer modes report with.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.profiler import record_function

PROFILE_ENV = "GM2_PROFILE_DIR"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
NO_RANGE = "(no gm2 range)"
BACKWARD_NODE = "autograd::engine::evaluate_function: "
_NOOP = contextlib.nullcontext()


def span(name: str | None):
    """The range ``name`` (``record_function``) while a profiler runs, else
    a shared no-op context (also for a ``name`` of None): a
    ``record_function`` costs some 10 us of host time even with no
    profiler, the check under 1 us."""
    if name and torch._C._autograd._profiler_enabled():
        return record_function(name)
    return _NOOP


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


# ---------------------------------------------------------------------------
# device time by range
# ---------------------------------------------------------------------------

def _thread(e: dict) -> tuple:
    return e.get("pid"), e.get("tid")


def _around(spans: list, points: list) -> list:
    """For each ``(key, time)`` of ``points``, the ``(start, end, event)``
    of ``spans[key]`` that hold the time, outermost first: one sweep a key
    over its spans sorted by start (the profiler's host spans nest)."""
    out = [None] * len(points)
    by_key: dict = {}
    for i, (key, t) in enumerate(points):
        by_key.setdefault(key, []).append((t, i))
    for key, queries in by_key.items():
        ivs = sorted(spans.get(key, ()), key=lambda iv: (iv[0], -iv[1]))
        active: list = []
        j = 0
        for t, i in sorted(queries):
            while j < len(ivs) and ivs[j][0] <= t:
                active.append(ivs[j])
                j += 1
            active = [iv for iv in active if iv[1] > t]
            out[i] = list(active)
    return out


def _spans(events: list, keep) -> dict:
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and "dur" in e and keep(e):
            out.setdefault(_thread(e), []).append((e["ts"], e["ts"] + e["dur"], e))
    return out


def device_by_range(events: list) -> dict:
    """Device seconds by ``gm2/`` range from Chrome trace events (us), as
    ``{range: {"forward_s", "backward_s", "ops": {op: seconds}}}``.

    Each kernel, copy and fill is matched by ``correlation`` to the runtime
    call that launched it, and goes to the innermost ``gm2/`` range around
    that call on its thread, or, where its thread has none (the autograd
    engine's device thread), the innermost on any thread. A kernel
    launched by an autograd node (``autograd::engine::evaluate_function``)
    is a backward kernel: it goes to the range of the forward op the node
    came from, found by the profiler's ``fwdbwd`` flow; one that no
    forward range claims stays where it was launched
    (``gm2/step/backward`` in a train step). An op
    is the outermost ``aten::`` op around the launch (under the node for a
    backward kernel), else the kernel's own name. Work launched outside
    every range counts under ``NO_RANGE``."""
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    ranges = _spans(events, lambda e: e.get("cat") == "user_annotation"
                    and e["name"].startswith("gm2/"))
    anywhere = {None: [iv for ivs in ranges.values() for iv in ivs]}
    ops = _spans(events, lambda e: e.get("cat") == "cpu_op")
    # a backward node's link to its forward op: the fwdbwd flow, which ends
    # on the op of the node's name that the node runs first (torch 2.11 on
    # the card and 2.13 on the CPU put it there on every node but
    # AccumulateGrad, which has no forward op)
    starts, ends = {}, {}
    for e in events:
        if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
            (starts if e["ph"] == "s" else ends)[e.get("id")] = (_thread(e), e["ts"])
    flow = {ends[k]: starts[k] for k in ends if k in starts}
    node_home = {}
    for thread, ivs in ops.items():
        ivs = sorted(ivs, key=lambda iv: (iv[0], -iv[1]))
        for (t0, t1, e), nxt in zip(ivs, ivs[1:]):
            if e["name"].startswith(BACKWARD_NODE) and nxt[0] < t1 \
                    and nxt[2]["name"] == e["name"][len(BACKWARD_NODE):]:
                home = flow.get((thread, nxt[0]))
                if home is not None:
                    node_home[id(e)] = home

    launched = [runtime.get(e.get("args", {}).get("correlation")) for e in device]
    points = [(_thread(r), r["ts"]) if r is not None else (None, -1.0)
              for r in launched]
    homes, kinds = [], []  # where the kernel's range is looked up; (backward?, op)
    for d, point, stack in zip(device, points, _around(ops, points)):
        node = next((i for i, iv in enumerate(stack)
                     if iv[2]["name"].startswith(BACKWARD_NODE)), None)
        under = stack if node is None else stack[node:]
        op = next((iv[2]["name"] for iv in under
                   if iv[2]["name"].startswith("aten::")), d["name"][:60])
        home = point
        if node is not None:
            op = under[0][2]["name"][len(BACKWARD_NODE):] + " > " + op
            home = node_home.get(id(under[0][2]), point)
        homes.append(home)
        kinds.append((node is not None, op))

    def innermost(spans, where):
        return [min(s, key=lambda iv: iv[1] - iv[0])[2]["name"] if s else None
                for s in _around(spans, where)]

    # a forward op outside every range leaves the kernel where it was
    # launched
    names = zip(innermost(ranges, homes), innermost(ranges, points),
                innermost(anywhere, [(None, t) for _, t in points]))
    table: dict = {}
    for d, (backward, op), found in zip(device, kinds, names):
        name = next((n for n in found if n), NO_RANGE)
        row = table.setdefault(name, {"forward_s": 0.0, "backward_s": 0.0, "ops": {}})
        s = d["dur"] / 1e6
        row["backward_s" if backward else "forward_s"] += s
        row["ops"][op] = row["ops"].get(op, 0.0) + s
    return table


def format_table(table: dict, top: int = 3) -> str:
    """The table of :func:`device_by_range` in ms, the largest range first."""
    rows = sorted(table.items(),
                  key=lambda kv: -(kv[1]["forward_s"] + kv[1]["backward_s"]))
    lines = [f"{'range':<32} {'forward ms':>12} {'backward ms':>12}  top ops"]
    for name, r in rows:
        ops = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:top]
        lines.append(f"{name:<32} {r['forward_s'] * 1e3:>12.4f} "
                     f"{r['backward_s'] * 1e3:>12.4f}  " + "; ".join(
                         f"{k} {v * 1e3:.4f}" for k, v in ops))
    total = sum(r["forward_s"] + r["backward_s"] for r in table.values())
    lines.append(f"{'total':<32} {total * 1e3:>12.4f}")
    return "\n".join(lines)


def load_trace(path: str) -> list:
    """The events of a Chrome trace file."""
    with open(path) as f:
        return json.load(f)["traceEvents"]


def profiler_events(prof) -> list:
    """The Chrome trace events of a stopped ``torch.profiler.profile``
    (written to a temporary file, read and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return load_trace(path)
    finally:
        os.unlink(path)


def step_phases(trainer, state, batch: torch.Tensor, steps: int = 8) -> dict:
    """Device seconds a train step by ``gm2/`` range: one warm step, then
    ``steps`` eager steps (``trainer.train_step``) on ``batch`` (a device
    tensor of padded rows) under torch.profiler, all on
    ``state.clone()``, reduced by :func:`device_by_range` and divided by
    ``steps``. ``state`` is left as it was. One process only (no
    grid)."""
    from torch.profiler import ProfilerActivity, profile

    if trainer.grid is not None:
        raise ValueError("step_phases traces one process's step; this "
                         "trainer runs on a grid of ranks")
    copy = state.clone()
    cuda = batch.device.type == "cuda"

    def step():
        trainer.train_step(copy, batch)

    step()
    if cuda:
        torch.cuda.synchronize(batch.device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        if cuda:
            torch.cuda.synchronize(batch.device)
    table = device_by_range(profiler_events(prof))
    return {name: {"forward_s": r["forward_s"] / steps,
                   "backward_s": r["backward_s"] / steps,
                   "ops": {k: v / steps for k, v in r["ops"].items()}}
            for name, r in table.items()}


def main(argv=None) -> int:
    """Print the device time by range of each trace file given."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m genome_minimizer_2_torch.utils.profiling "
              "TRACE.json [TRACE.json ...]\n\n" + device_by_range.__doc__)
        return 0 if argv else 2
    for path in argv:
        print(path)
        print(format_table(device_by_range(load_trace(path))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
