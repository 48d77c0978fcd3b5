"""The readings a pipeline cell's limits are set from, on the card at the
cell's own size, in one process:

- the program: for each seed, set-up, a short window at the cell's load
  and the comparison with the reference that a run makes;
- the control: the reference's decode at the precision below the cell's
  (fp8 products for bf16), in the program's place;
- the faults (``drivers/pipeline.py::FAULTS``): a bit of each kept genome
  flipped after its record was written; the essential genes' union left
  out of the conversion; one feature's interval a base longer. The first
  is planted in the program's answers, the others in the reference put in
  the program's place.

    python3 portbench/calibrate_pipeline.py --workload <cell> --seeds 1,2,... \
        [--controls 3] [--faults 3] [--seconds 20]

prints one JSON line a reading and a summary line: the largest of the
program's readings and the smallest of the control's and of each fault's.
A cell held back in ``deferred/`` runs once its entries are appended to
``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import calibrate as CAL  # noqa: E402
from portbench import harness  # noqa: E402


def readings(cell, driver, seeds, controls, faults, seconds, device) -> list:
    out = []
    for i, seed in enumerate(seeds):
        parts: dict = {}
        s = driver.setup(cell, seed, device, parts)
        rec = driver.window(s, cell, seed, seconds, False)
        driver.release(s)
        kept = rec["kept"]
        got = driver.readings(cell, seed, kept, device)
        out.append(CAL.emit("program", seed, {k: got[k] for k in driver.CHECKED},
                            bits_differing=got["bits_differing"], records=got["records"],
                            calls=rec["calls"],
                            genomes_per_s=rec["genomes"] / rec["window_s"],
                            setup=parts))
        if i < controls:
            ctl = CAL.CONTROL[cell.traffic["compute_dtype"]]
            got = driver.readings(cell, seed, kept, device, precision=ctl)
            out.append(CAL.emit("control", seed, {k: got[k] for k in driver.CHECKED},
                                precision=ctl, bits_differing=got["bits_differing"]))
        if i < faults:
            for fault in driver.FAULTS:
                got = driver.readings(cell, seed, kept, device, fault=fault)
                out.append(CAL.emit(f"fault.{fault}", seed,
                                    {k: got[k] for k in driver.CHECKED},
                                    records=got["records"]))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("calibrate_pipeline needs a CUDA device")
        return 2
    harness.log(f"device: {torch.cuda.get_device_name(0)}; {harness.card_line()}")
    cell = harness.Cell(args.workload)
    if cell.driver != "pipeline":
        harness.log(f"{args.workload} is not a pipeline cell; use calibrate.py")
        return 2
    driver = harness.load_module(harness.HERE / "drivers" / "pipeline.py")
    seeds = [int(s) for s in args.seeds.split(",")]
    t = time.perf_counter()
    lines = readings(cell, driver, seeds, args.controls, args.faults, args.seconds,
                     torch.device("cuda", 0))
    summary = {"kind": "summary", "cell": cell.name, "seconds": time.perf_counter() - t}
    for k in driver.CHECKED:
        for kind in sorted({ln["kind"] for ln in lines}):
            vals = [ln[k] for ln in lines if ln["kind"] == kind]
            summary[f"{kind}.{k}"] = max(vals) if kind == "program" else min(vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
