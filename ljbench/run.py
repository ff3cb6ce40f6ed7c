"""Run one cell of the ljmd_tpu_torch benchmark once, on the machine it is
started on, from the root of a checkout:

    python3 -m ljbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

It prints a few lines on standard error (the card, the engine, the kernel
launch and host-read counters, the cycle count, and as the last lines each
number the correctness check compares beside its limit), then one JSON
object as the last line of standard output: ``correct``, ``attempted``
(samples taken in the window, a replica's each), ``failed`` (those not
finite), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. It exits non-zero without a result where there is no CUDA card
or fewer than the cell asks for, and where a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "ljmd_tpu")


def process_age() -> float:
    """Seconds since this process started (``/proc``: the start tick against
    the uptime, 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def result_line(cell, out: dict, trace: bool, setup_s: float, device: dict) -> dict:
    from ljbench import check
    from ljbench.spec import reader

    ctx = dict(out, cell=cell, setup_s=setup_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = out["numbers"]
    ok, _ = check.verdict(numbers, cell.limits)
    line = {"correct": ok and out["failed_samples"] == 0,
            "attempted": out["cycles"] * cell.replicas, "failed": out["failed_samples"],
            "metrics": metrics, "device": device}
    if trace and out["traced"] is not None:
        line["breakdown"] = {"device_ops": out["traced"]["top_ops"],
                             "idle_gaps": out["traced"]["idle_gaps"]}
    line["checks"] = {k: {"value": numbers[k], "limit": cell.limits[k]} for k in check.NAMES}
    return line


def main(argv=None) -> int:
    age0, t_ref = process_age(), time.perf_counter()
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from ljbench.harness import run_cell
    from ljbench.spec import load_cell

    t_imported = time.perf_counter()
    cell = load_cell(args.workload, args.seed)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    trace = bool(args.trace)
    out = run_cell(cell, args.seconds, args.seed, trace)
    setup_s = age0 + (out["window_t0"] - t_ref)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out["peak_bytes"]}
    if trace and out["traced"] is not None:
        device["busy_s"] = out["traced"]["busy_s"]
        device["window_s"] = out["traced"]["wall_s"]
    line = result_line(cell, out, trace, setup_s, device)
    log(f"card: {card_line()}")
    log(f"cell {cell.name}: N={cell.cfg.n} R={cell.replicas} interval={cell.cfg.output_interval} "
        f"{cell.cfg.dtype}, engine {out['backend']}, set-up {setup_s:.3f} s "
        f"(to main {age0:.3f} s, imports {t_imported - t_ref:.3f} s, "
        f"initialize to the warm cycle {out['setup_in_process_s']:.3f} s)")
    log(f"window: {out['cycles']} cycles, {out['steps']} steps, {out['wall_s']:.4f} s; "
        f"checked {out['checked_cycles']} cycles")
    if out["traced"] is not None:
        t = out["traced"]
        log(f"profiled stretch: the window's first {t['cycles']} cycles ({t['steps']} steps), "
            f"{t['wall_s']:.4f} s, {t['device_ops']} device operations, busy {t['busy_s']:.4f} s, "
            f"{t.get('pairs', 0.0):.1f} pairs inside rc (mean of its ends, all replicas)")
    log(f"validity flags set at the end (replicas): {json.dumps(out['flags_set'])}; "
        f"mean temperature of the samples {out['mean_temp']:.6f}")
    log(f"launches in the window: {json.dumps(out['launches'])}")
    log(f"host reads in the window: {json.dumps(out['host_reads'])}")
    found = forbidden_modules(list(sys.modules))
    if found:
        log(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
        return 3
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
