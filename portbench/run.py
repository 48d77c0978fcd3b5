"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is looked up in ``BENCHMARK.json``;
its configuration, traffic, limits, driver and metrics are files under
``portbench/`` found by name (``harness.Cell``). The run needs as many CUDA
devices as the cell asks for and never falls back to the CPU. The last
line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``, each number compared with its limit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, device, clock: dict, cell=None) -> tuple[dict, dict]:
    """(result without checks, checks) of one run of a cell on ``device``
    (by default ``args.workload``'s); the checks decide ``correct``."""
    import torch

    cell = cell or harness.Cell(args.workload)
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.driver}.py")
    rec, checks = driver.run(cell, args, device, clock)
    rec.update(cell=cell.name, config=cell.config, traffic=cell.traffic)
    metrics = harness.read_metrics(cell.per_layer if args.trace else cell.end_to_end,
                                   rec)
    correct = (rec.get("failed", 0) == 0
               and all(harness.within(c["value"], c["limit"]) for c in checks.values()))
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": cell.chips, "memory_peak_bytes": rec["memory_peak_bytes"]}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": correct,
              "attempted": rec["epochs"] if rec["driver"] == "train" else rec["genomes"],
              "failed": rec.get("failed", 0), "metrics": metrics, "device": dev}
    if args.trace:
        from portbench import trace

        tr = rec["trace"]
        dev.update(busy_s=tr["busy_s"], window_s=tr["seconds"])
        result["breakdown"] = trace.breakdown(tr)
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    t = time.perf_counter()
    import torch

    now = time.perf_counter()
    # the process's age when this module started, so set-up counts from the
    # process's start
    clock = {"t0": T0, "age": harness.process_age() - (now - T0), "import": now - t}
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"{args.workload} needs {cell.chips} CUDA device(s); "
                    f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                    f"{torch.cuda.device_count()} found")
        return 2
    harness.log(f"device: {torch.cuda.get_device_name(0)}; count "
                f"{torch.cuda.device_count()}, using {cell.chips}; "
                f"nvidia-smi: {harness.card_line()}")
    result, checks = run(args, torch.device("cuda", 0), clock)
    return harness.finish(result, checks)


if __name__ == "__main__":
    sys.exit(main())
