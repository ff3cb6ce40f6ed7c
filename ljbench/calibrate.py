"""The readings that each cell's limits (``limits/<cell>.json``) are set
from, on the card, in one process:

    python3 -m ljbench.calibrate --workload <name> --seeds 101 102 ... \\
        [--control-seeds 101 102 103] [--seconds 3]

For each seed it runs the cell as a benchmark run does (set-up, a window
of ``--seconds``, ``finalize``) and prints one JSON line with every number
the check compares. For each control seed it also puts the reference,
computed in bfloat16 (the precision below the configuration's float32), in
the port's place: it advances each checked cycle from the port's state at
its start, and its means are those of the same samples in bfloat16; the
line's ``control`` holds the same numbers for it. Not part of a benchmark
run.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ljbench import check, harness
from ljbench.reference import lj
from ljbench.spec import load_cell


def readings(workload: str, seed: int, seconds: float, control: bool) -> dict:
    cell = load_cell(workload, seed)
    device = torch.device("cuda")
    run = harness.setup(cell, device)
    win = harness.window(cell, run, seconds, seed, False, device)
    inputs = harness.check_inputs(cell, run, win)
    del run, win
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"workload": workload, "seed": seed, "samples": inputs["series"].shape[-1],
           "flags_set": inputs["flags_set"], "mean_temp": inputs["mean_temp"],
           "numbers": check.readings(inputs["cycles"], inputs["means"], inputs["series"],
                                     inputs["flags"], inputs["samples_gap"], cell.cfg)}
    out["check_s"] = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        cycles = [check.control_cycle(c, cell.cfg) for c in inputs["cycles"]]
        means = lj.means(inputs["series"].to(torch.bfloat16))
        out["control"] = check.readings(cycles, means, inputs["series"], 0, 0, cell.cfg)
        out["control_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("calibrate runs on a CUDA card")
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, seed in args.control_seeds)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
