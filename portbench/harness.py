"""What every run shares: finding a cell's pieces by name, the result line,
the checks' lines, the card's description and the check that the run
loaded nothing of JAX.

A cell ``<cell>`` of ``BENCHMARK.json`` is found through
``workloads/<cell>.json`` (its limits), its configuration's ``file`` and
``traffic/<traffic>.json`` (the driver that runs it and its parameters);
the driver is ``drivers/<driver>.py``, each metric ``metrics/<name>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "genome_minimizer_2_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell's configuration, traffic, limits and metrics."""

    def __init__(self, name: str, root: Path = ROOT):
        base = root / "portbench"
        bench = load_json(root / "BENCHMARK.json")
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        configs = {c["name"]: c for c in bench["configs"]}
        self.name = name
        self.entry = entry
        self.chips = int(entry["chips"])
        self.config = load_json(root / configs[entry["config"]]["file"])
        self.traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
        self.limits = load_json(base / "workloads" / f"{name}.json")["limits"]
        self.driver = self.traffic["driver"]

        def mine(metric):
            return name in metric.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]


def read_metrics(metrics: list, record: dict) -> dict:
    """{name: {value, unit}} of each metric whose reader finds something."""
    out = {}
    for m in metrics:
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def process_age() -> float:
    """Seconds since this process started, from /proc (0 where unknown)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return max(0.0, time.clock_gettime(time.CLOCK_BOOTTIME)
                   - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read (nvidia-smi failed)"


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level name."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def p90(values: list[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def finish(result: dict, checks: dict) -> int:
    """Print each number compared beside its limit, last on stderr and last
    in the result line, then the line itself; 0 if correct."""
    forbidden = loaded_forbidden()
    if forbidden:
        log(f"JAX is loaded in this process: {forbidden}")
        return 3
    checks = {k: {"value": c["value"] if math.isfinite(c["value"])
                  else str(c["value"]), "limit": c["limit"]}
              for k, c in checks.items()}
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit
