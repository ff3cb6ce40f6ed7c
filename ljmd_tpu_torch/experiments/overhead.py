"""Fixed overheads of two hot kernels on the card (the port's
``scripts/exp_overhead.py``).

Part A (zsort geometry, N=4000): time the flag-gated dense chunk
(``ops/fused.py::fused_dense_chunk_flags``, kernel 8) with all-zero, real
and all-3 flags at (128, 512) tiles, 125 chunks of 8 steps from the melted
fluid, to split per-tile-visit overhead from pair math. The JAX script reads
the flags from the zsort carry, which no longer holds them; here they are
computed from the carry's sorted rows with the window rc + 0.7, as
``scripts/exp_zfloor.py`` does.

Part B (config 5's grid, N=62500, capacity 384): time the half-shell pencil
sweep alone (kernel 13, chained through a 1e-30 feedback) against the
cell-pair engine's ``step_fast``, to split kernel from engine overhead.

Usage: python -m ljmd_tpu_torch.experiments.overhead [--part a|b|ab] [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import torch

from ljmd_tpu_torch.experiments._common import (
    best_of,
    device_line,
    lattice_state,
    melted_zsort,
    parser,
)
from ljmd_tpu_torch.models.engine import _cellpair_engine
from ljmd_tpu_torch.models.forces import resolve_device
from ljmd_tpu_torch.ops.cell_list import make_pencil_grid
from ljmd_tpu_torch.ops.fused import fused_dense_chunk_flags
from ljmd_tpu_torch.ops.pencil_sweep import build_half_shell_tables, pencil_sweep_hs
from ljmd_tpu_torch.ops.window_lists import compute_tile_flags

# The JAX script's sizes (the tests shrink them).
NUM_CELLS = 10      # part A: N = 4000
MELT_STEPS = 512
CHUNK_STEPS = 8
N_CHUNKS = 125      # 1000 steps
TILE_I, TILE_J = 128, 512
PENCIL_CELLS = 25   # part B: N = 62500
WARM_STEPS = 300
PENCIL_CAPACITY = 384
PENCIL_STEPS = 200
REPS = 3


def chunk_chain(cfg, r, v, a, flags, n_chunks, k, tile_i, tile_j):
    """``n_chunks`` flag-gated chunks of ``k`` steps, chained (no wrap)."""
    for _ in range(n_chunks):
        r, v, a = fused_dense_chunk_flags(r, v, a, flags, cfg.n, cfg.box_length,
                                          cfg.rc_square, cfg.dt, k, tile_i=tile_i,
                                          tile_j=tile_j)
    return r, v, a


def part_a(device) -> dict:
    device = resolve_device(device)
    cfg, _, c = melted_zsort(device, NUM_CELLS, MELT_STEPS)
    n, n_pad = cfg.n, c.r.shape[1]
    n_tiles = (n_pad // TILE_I) * (n_pad // TILE_J)
    real = compute_tile_flags(c.r, n, TILE_I, TILE_J, cfg.box_length, cfg.rc + 0.7)
    n_active = int((real > 0).sum())
    print(f"N={n} n_pad={n_pad} tiles={n_tiles} active={n_active}", flush=True)

    def run(flags):
        go = lambda: chunk_chain(cfg, c.r, c.v, c.a, flags, N_CHUNKS, CHUNK_STEPS,  # noqa: E731
                                 TILE_I, TILE_J)
        go()
        return best_of(go, device, REPS) / (CHUNK_STEPS * N_CHUNKS)

    t_zero = run(torch.zeros_like(real))
    t_real = run(real)
    t_ones = run(torch.full_like(real, 3))
    print(f"zsort fused chunk us/step:  zero={t_zero*1e6:.2f}  "
          f"real={t_real*1e6:.2f}  ones={t_ones*1e6:.2f}", flush=True)
    full_cand = n_pad * n_pad / 2
    rate = full_cand / (t_ones - t_zero) if t_ones > t_zero else float("nan")
    print(f"pair-math rate (ones-zero): {rate/1e9:.1f} Gcand/s; "
          f"per-tile-visit overhead ~ {t_zero*1e6/n_tiles*1000:.1f} ns "
          f"(incl integrator)", flush=True)
    return {"n": n, "n_pad": n_pad, "tiles": n_tiles, "active": n_active,
            "us_per_step": {"zero": 1e6 * t_zero, "real": 1e6 * t_real, "ones": 1e6 * t_ones},
            "gcand_per_s": rate / 1e9, "ns_per_tile_zero": 1e9 * t_zero / n_tiles}


def part_b(device) -> dict:
    device = resolve_device(device)
    cfg, state = lattice_state(PENCIL_CELLS, device, dt=0.005, dtype="float32",
                               neighbor_skin=0.4)
    eng0 = _cellpair_engine(cfg, device)
    c0, _ = eng0.init(state)
    for _ in range(WARM_STEPS):
        c0, _ = eng0.step_fast(c0)
    state = eng0.get_state(c0)
    print("warmup done", flush=True)

    cfg_t = cfg.replace(neighbor_capacity=PENCIL_CAPACITY)
    eng = _cellpair_engine(cfg_t, device, half_shell=True)
    carry, _ = eng.init(state)
    grid = make_pencil_grid(cfg_t.n, cfg_t.box_length, cfg_t.rc + 0.4, cfg_t.density,
                            PENCIL_CAPACITY)
    tbl, shf = (torch.as_tensor(t, device=device) for t in build_half_shell_tables(grid))
    print(f"grid m={grid.m_xy} cap={grid.capacity} pencils={grid.n_pencils}", flush=True)

    def run_step():
        cc = carry
        for _ in range(PENCIL_STEPS):
            cc, _ = eng.step_fast(cc)
        return cc

    run_step()
    t_step = best_of(run_step, device, REPS) / PENCIL_STEPS
    print(f"engine step_fast: {t_step*1e6:9.1f} us/step", flush=True)

    def run_sweep():
        p = carry.r
        for _ in range(PENCIL_STEPS):
            out = pencil_sweep_hs(p, tbl, carry.counts, shf, grid, cfg_t.rc_square, False)
            p = p + 1e-30 * out
        return p

    run_sweep()
    t_sweep = best_of(run_sweep, device, REPS) / PENCIL_STEPS
    print(f"hs sweep alone:   {t_sweep*1e6:9.1f} us/call "
          f"(engine overhead ~ {(t_step - t_sweep)*1e6:.1f} us/step)", flush=True)
    cap = grid.capacity
    n_sub = cap // 128
    cand = grid.n_pencils * (sum(128 * (cap - 128 * si) for si in range(n_sub))
                             + n_sub * 4 * 128 * cap)
    print(f"candidates/step = {cand/1e6:.1f}M -> sweep rate "
          f"{cand/t_sweep/1e9:.1f} Gcand/s", flush=True)
    return {"n": cfg.n, "m_xy": grid.m_xy, "capacity": cap, "pencils": grid.n_pencils,
            "step_fast_us": 1e6 * t_step, "sweep_us": 1e6 * t_sweep,
            "candidates": cand, "gcand_per_s": cand / t_sweep / 1e9}


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--part", default="ab", help="a, b or ab")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    out = {}
    if "a" in args.part:
        out["a"] = part_a(device)
    if "b" in args.part:
        out["b"] = part_b(device)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
