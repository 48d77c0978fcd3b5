"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process:

- the program: for each seed, what a run of it checks (training: set-up
  once, then each seed's start written into the same tensors and the
  window's first two epochs; sampling: set-up and a short window at the cell's
  load), then the same comparison with the float32 reference as a run
  makes;
- the control: the reference itself at the precision below the cell's
  (fp8 products for bf16, TF32 for float32) in the program's place;
- the faults a cell can have, planted in the reference put in the program's
  place (half of each batch left out, the rest scaled up to the whole) or
  in the program's answers (a bit of each kept genome flipped where it is
  produced). A state left unchanged reads 1 by the measure of every
  training number and needs no run.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--controls 3] [--faults 3] [--seconds 2]

prints one JSON line a reading and a summary line, the largest of the
program's readings and the smallest of the control's and of each fault's.
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.reference import train as RT  # noqa: E402

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def emit(kind: str, seed: int, numbers: dict, **extra) -> dict:
    line = {"kind": kind, "seed": seed, **numbers, **extra}
    print(json.dumps(line), flush=True)
    return line


def _detail(g: dict) -> dict:
    """What the look at a training reading needs: the worst leaves, each
    step's gap by loss component, and the median leaf's gaps."""
    import statistics

    return {"worst_grad_leaf": g["worst_grad_leaf"],
            "worst_change_leaf": g["worst_change_leaf"],
            "loss_by_step": g["loss_by_step"],
            "median_grad_gap": statistics.median(g["grad_by_leaf"].values()),
            "median_change_gap": statistics.median(g["change_by_leaf"].values()),
            "grad_by_leaf": g["grad_by_leaf"], "change_by_leaf": g["change_by_leaf"]}


def train_readings(cell, driver, seeds, controls, faults, device) -> list:
    """Set-up once (its warm epoch builds and captures), then for each seed
    its start written into the same tensors and the window's first two
    epochs, as a run of that seed makes them."""
    out = []
    s = driver.setup(cell, seeds[0], device, {})
    checked = [k for k in driver.CHECKED if k != "nonfinite_epochs"]
    for i, seed in enumerate(seeds):
        if i:
            driver.load_seed(s, cell, seed)
        rec = driver.window(s, 0.0, False, 0)
        want = driver.reference_readings(cell, seed, device)
        g = RT.gaps(rec["readings"], want, detail=True)
        out.append(emit("program", seed, {k: g[k] for k in checked}, **_detail(g),
                        epoch_s=rec["epoch_s"], failed=rec["failed"]))
        if i < controls:
            ctl = CONTROL[cell.traffic["compute_dtype"]]
            g = RT.gaps(driver.reference_readings(cell, seed, device, ctl), want,
                        detail=True)
            out.append(emit("control", seed, {k: g[k] for k in checked},
                            precision=ctl, **_detail(g)))
        if i < faults:
            g = RT.gaps(driver.reference_readings(cell, seed, device,
                                                  half_batch=True), want, detail=True)
            out.append(emit("fault.half_batch", seed, {k: g[k] for k in checked},
                            **_detail(g)))
    driver.release(s)
    return out


def sample_readings(cell, driver, seeds, controls, faults, seconds, device) -> list:
    out = []
    for i, seed in enumerate(seeds):
        parts: dict = {}
        s = driver.setup(cell, seed, device, parts)
        rec = driver.window(s, cell, seed, seconds, False)
        s.clear()
        torch.cuda.empty_cache()
        kept = rec["kept"]
        got = driver.reference_gaps(cell, seed, kept, device)
        out.append(emit("program", seed, {k: got[k] for k in driver.CHECKED},
                        bits_differing=got["bits_differing"], bits=got["bits"],
                        calls=rec["calls"], setup=parts))
        if i < controls:
            ctl = CONTROL[cell.traffic["compute_dtype"]]
            got = driver.reference_gaps(cell, seed, kept, device, ctl, "reference")
            out.append(emit("control", seed, {k: got[k] for k in driver.CHECKED},
                            precision=ctl, bits_differing=got["bits_differing"]))
        if i < faults:
            rng = np.random.default_rng(seed)
            for k in kept:
                rows = k["rows"]
                r = np.arange(rows.shape[0])
                col = rng.integers(cell.config["input_dim"], size=rows.shape[0])
                rows[r, col >> 3] ^= (1 << (col & 7)).astype(np.uint8)
            got = driver.reference_gaps(cell, seed, kept, device)
            out.append(emit("fault.altered_bit", seed,
                            {k: got[k] for k in driver.CHECKED}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("calibrate needs a CUDA device")
        return 2
    harness.log(f"device: {torch.cuda.get_device_name(0)}; {harness.card_line()}")
    cell = harness.Cell(args.workload)
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.driver}.py")
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda", 0)
    t = time.perf_counter()
    if cell.driver == "train":
        lines = train_readings(cell, driver, seeds, args.controls, args.faults,
                               device)
    else:
        lines = sample_readings(cell, driver, seeds, args.controls, args.faults,
                                args.seconds, device)
    summary = {"kind": "summary", "cell": cell.name, "seconds": time.perf_counter() - t}
    for k in driver.CHECKED:
        for kind in sorted({ln["kind"] for ln in lines}):
            vals = [ln[k] for ln in lines if ln["kind"] == kind and k in ln]
            if not vals:
                continue
            summary[f"{kind}.{k}"] = max(vals) if kind == "program" else min(vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
