"""100 x the least time of the profiled stretch's needed work / device
busy time in it.

The work is what the physics needs, whatever implements the step: each
pair inside rc (counted once, by the reference, as the mean of the counts
at the stretch's first and last states) costs 30 operations a step (13 for
the displacement, minimum image and r^2; 17 for the force terms and both
sums), 10 more on a sampled step (the observables), and each particle-step
24 for the Verlet update. The state's bytes are counted once. The least
time is the larger of operations over the peak rate of the dtype and bytes
over the HBM rate (``peaks.json``).
"""

import json
from pathlib import Path

PAIR_OPS, SAMPLED_PAIR_OPS, PARTICLE_STEP_OPS = 30, 10, 24
STATE_ARRAYS = 4  # r, ru, v, a, each read and written once


def read(ctx):
    t = ctx["traced"]
    if t is None or t["busy_s"] <= 0.0 or "pairs" not in t:
        return None
    cfg, reps = ctx["cell"].cfg, ctx["cell"].replicas
    peaks = json.loads((Path(__file__).resolve().parent.parent / "peaks.json").read_text())
    ops = (t["steps"] * (t["pairs"] * PAIR_OPS + reps * cfg.n * PARTICLE_STEP_OPS)
           + t["cycles"] * t["pairs"] * SAMPLED_PAIR_OPS)
    item = 8 if cfg.dtype == "float64" else 4
    nbytes = 2 * STATE_ARRAYS * 3 * reps * cfg.n * item
    least = max(ops / peaks[cfg.dtype], nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / t["busy_s"]
