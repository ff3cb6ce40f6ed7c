"""Where an ensemble's energy drift comes from: the per-replica |dE/E| of an
ensemble config (default BASELINE config 4, ``examples/ensemble64.json``:
64 replicas of N=256, float32, dt=0.005) run as configured, in float64, in
compensated float32, and in float64 at half the dt over the same time (twice
the steps, warmup and sampling interval), each from its own
``initialize_replicas`` with the config's replica generators.

|dE/E| = |E_last - E_first| / |E_first| over each replica's sampled etot
(chip_smoke's drift). If the precision or the integrator set it, float64
and the halved dt would shrink it; if they leave it where it is, the model
does (the truncated potential's energy steps as pairs cross the cutoff).

Usage: python -m ljmd_tpu_torch.experiments.ensemble_drift [--config FILE]
           [--replicas R] [--total-steps T] [--device cuda|cpu]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ljmd_tpu_torch.config import load_config
from ljmd_tpu_torch.experiments._common import device_line, parser
from ljmd_tpu_torch.models.forces import resolve_device
from ljmd_tpu_torch.models.simulation import (
    initialize_replicas,
    replica_generators,
    run_production,
)

CONFIG = Path(__file__).resolve().parents[2] / "examples" / "ensemble64.json"


def variants(cfg) -> dict:
    """The configs compared: as given, float64, compensated float32, and
    float64 at dt / 2 over the same time."""
    return {
        "as configured": cfg,
        "float64": cfg.replace(dtype="float64"),
        "float32 compensated": cfg.replace(dtype="float32", compensated_sum=True),
        "float64 dt/2": cfg.replace(dtype="float64", dt=0.5 * cfg.dt,
                                    total_steps=2 * cfg.total_steps,
                                    warmup_steps=2 * cfg.warmup_steps,
                                    output_interval=2 * cfg.output_interval),
    }


def drifts(cfg, replicas: int, device) -> np.ndarray:
    """Each replica's |dE/E| over its sampled etot."""
    states = initialize_replicas(cfg, replica_generators(cfg.seed, replicas), device=device)
    etot = run_production(cfg, states, device=device).series[:, 2].double().cpu().numpy()
    return np.abs(etot[:, -1] - etot[:, 0]) / np.abs(etot[:, 0])


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--config", default=str(CONFIG))
    p.add_argument("--replicas", type=int, help="default: the config's n_runs")
    p.add_argument("--total-steps", type=int, help="cut the production (warmup kept)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.total_steps:
        cfg = cfg.replace(total_steps=args.total_steps)
    replicas = args.replicas or cfg.n_runs
    print(device_line(device))
    print(f"N={cfg.n} R={replicas} dt={cfg.dt} total={cfg.total_steps} {cfg.dtype}")
    out = {}
    for name, vcfg in variants(cfg).items():
        d = drifts(vcfg, replicas, device)
        out[name] = {"max": float(d.max()), "median": float(np.median(d)),
                     "p90": float(np.quantile(d, 0.9)), "over_1e-3": int((d > 1e-3).sum())}
        print(f"{name:20s} |dE/E| max {d.max():.4e} median {np.median(d):.4e} p90 "
              f"{np.quantile(d, 0.9):.4e}, {int((d > 1e-3).sum())} of {replicas} over 1e-3")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
    sys.exit(0)
