"""Card times of the fused chunk kernels and the pencil sweeps of one
checkout, for comparing two checkouts on one card within one machine call:

    python ljmd_tpu_torch/experiments/chunk_timing.py [--root DIR] [--label NAME] [--sweep]

imports ``ljmd_tpu_torch`` from ``--root`` (default: the checkout holding
this file), builds its kernels there, and prints one JSON line: the card
(``nvidia-smi`` name and power limit), then per case the ms of one call by
CUDA events (the least of three means over a run of calls, after a
warm-up). It uses only
entry points that every version of the port since its cell-pair slice has,
so an older checkout unpacked beside this one is timed by the same code:
run it as old / new / new / old.

Cases (float32 unless named): kernels 3 / 4 (``fused_dense_chunk`` /
``_ext``, 99 steps) on perturbed FCC lattices at N=500 (L=10, rc=4.9) and
N=4000 (L=16.796, rc=2.5), float32 and float64; kernel 8
(``fused_dense_chunk_flags``, 8 steps) at N=4000 with the fluid's (128,
512) tile flags; at BASELINE config 5's geometry (``examples/
n62500_large.json``, a jittered FCC lattice, 14x14 pencils) at capacities
512 and 384: kernels 15 and 16 (the fused pencil chunks, 8 steps, float32
and float64), kernel 13 (the half-shell sweep), kernel 11 (the full
9-neighbour sweep) and kernel 12 (the z-banded sweep; its window is 384 at
both capacities, so at 384 every window-B stage lies inside window A), with
observables (the z-band also without them at 512, and in float64); the
rows engine's ``run_fast(8)`` at config 5 (ms a step, float32 and
float64); the cell-pair engine's ``run_fast(8)`` with the width
lists at capacity 512 and a rebin before the chunk (the ``always``
trigger), with the device operations (kernels, copies, fills) of one such
call (torch.profiler); and ``initialize`` of config 5 cut to 500 warmup
steps on the cell-pair engine (the lattice capacity 512: width-listed
chunks), seconds on the host clock.

``--sweep`` (a checkout whose ``ops/fused.py`` has ``dense_plan``) also times
the dense chunk at every block shape S (threads a particle) it takes: N=500
and N=4000 as above (99 steps), and the rows engine's carry at config 5 (8
steps, float32 and float64), each beside its plan (items, blocks, warps an
SM).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def _ms(torch, fn, reps: int, warmup: int = 2, rounds: int = 3) -> float:
    """ms of one ``fn()``: the least over ``rounds`` of the mean of ``reps``
    calls (CUDA events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _fcc_rows(torch, num_cells, box, seed, dtype, dev):
    """(n, r, v, a): a perturbed FCC lattice as (8, n_pad) rows with uniform
    velocities and consistent accelerations (rc given by the caller)."""
    import numpy as np

    from ljmd_tpu_torch.models.lattice import fcc_lattice

    rng = np.random.default_rng(seed)
    r = fcc_lattice(num_cells, box, dtype=torch.float64).numpy()
    n = r.shape[0]
    r = np.mod(r + rng.normal(scale=0.04 * box / num_cells, size=r.shape), box)
    v = rng.uniform(-0.5, 0.5, size=r.shape)
    n_pad = -(-n // 128) * 128

    def rows(x):
        out = torch.zeros((8, n_pad), dtype=dtype, device=dev)
        out[0:3, :n] = torch.as_tensor(x.T, dtype=dtype, device=dev)
        return out

    return n, rows(r), rows(v)


def dense_cases(torch, dev) -> dict:
    from ljmd_tpu_torch.ops import fused, pair_sweep, window_lists

    out = {}
    for label, k, box, rc, dt in (("N=500", 5, 10.0, 4.9, 1e-4),
                                  ("N=4000", 10, 16.795961913825, 2.5, 0.005)):
        rc2 = rc * rc
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            n, r, v = _fcc_rows(torch, k, box, 1234 + k, dtype, dev)
            a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc2)
            zero = torch.zeros_like(r)
            out[f"fused_dense_chunk {label} {dname}"] = _ms(
                torch, lambda: fused.fused_dense_chunk(r, v, a, n, box, rc2, dt, 99), 10)
            out[f"fused_dense_chunk_ext {label} {dname}"] = _ms(
                torch, lambda: fused.fused_dense_chunk_ext(r, zero, v, zero, a, n, box, rc2, dt,
                                                           99), 10)
            if label == "N=4000":
                flags = window_lists.compute_tile_flags(r, n, 128, 512, box, rc + 0.7)
                out[f"fused_dense_chunk_flags {label} {dname} fluid flags"] = _ms(
                    torch, lambda: fused.fused_dense_chunk_flags(r, v, a, flags, n, box, rc2,
                                                                 dt, 8), 20)
    return out


def slice_sweep(torch, dev, root: Path) -> dict:
    """ms of the dense chunk at each S the kernel takes, with the plan."""
    import numpy as np

    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import fused, pair_sweep
    from ljmd_tpu_torch.state import MDState

    shapes = []
    for label, k, box, rc, dt in (("N=500", 5, 10.0, 4.9, 1e-4),
                                  ("N=4000", 10, 16.795961913825, 2.5, 0.005)):
        for dname, ext in (("float32", False), ("float32", True), ("float64", False)):
            n, r, v = _fcc_rows(torch, k, box, 1234 + k, getattr(torch, dname), dev)
            a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc * rc)
            shapes.append((f"{label} {dname}{' extended' if ext else ''}", ext, n, r, v, a, box,
                           rc * rc, dt, 99, 10))
    cfg = load_config(str(root / "examples" / "n62500_large.json"))
    rng = np.random.default_rng(5)
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64)
    r = torch.remainder(r + torch.as_tensor(rng.normal(0, 0.05, r.shape)), cfg.box_length)
    v = torch.as_tensor(rng.normal(0, 0.8, r.shape))
    for dname in ("float32", "float64"):
        state = MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)).to(device=dev,
                                                                  dtype=getattr(torch, dname))
        c = pe.make_engine(cfg.replace(dtype=dname), "rows", dev).init(state)[0]
        shapes.append((f"N={cfg.n} {dname}", False, cfg.n, c.r, c.v, c.a, cfg.box_length,
                       cfg.rc_square, cfg.dt, 8, 2))
    out = {}
    for label, ext, n, r, v, a, box, rc2, dt, steps, reps in shapes:
        zero = torch.zeros_like(r) if ext else None
        res = {}
        for s in (4, 8, 16, 32, 64, 128, 256):
            if n > 10000 and s > 16:
                break  # streamed: a work item of fewer than 16 particles restreams the plane
            plan = fused.dense_plan(r, ext, slices=s)
            ms = _ms(torch, lambda: fused._launch("fused_dense_chunk", ext, r, zero, v, zero, a,
                                                  n, box, rc2, dt, steps, slices=s), reps)
            res[s] = {"ms": ms, **{k: plan[k] for k in ("items", "blocks", "blocks_per_sm",
                                                        "warps_per_sm", "resident")}}
        out[f"{label} ({steps} steps)"] = {"chosen": fused.dense_plan(r, ext)["slices"],
                                           "by_slices": res}
    return out


def pencil_cases(torch, dev, root: Path) -> dict:
    import numpy as np

    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.models.simulation import initialize
    from ljmd_tpu_torch.ops import cell_list, fused_pencil, pencil_sweep
    from ljmd_tpu_torch.state import MDState
    from ljmd_tpu_torch.utils.profiling import device_breakdown

    cfg = load_config(str(root / "examples" / "n62500_large.json"))
    L, rc2, dt = cfg.box_length, cfg.rc_square, cfg.dt
    rng = np.random.default_rng(5)
    r = fcc_lattice(cfg.num_cells, L, dtype=torch.float64)
    r = torch.remainder(r + torch.as_tensor(rng.normal(0, 0.05, r.shape)), L)
    v = torch.as_tensor(rng.normal(0, 0.8, r.shape))
    state = MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)).to(device=dev)
    r_list = cfg.rc + cfg.neighbor_skin
    out = {}
    for cap in (512, 384):
        grid = cell_list.make_pencil_grid(cfg.n, L, r_list, cfg.density, cap)
        P = grid.n_pencils
        tbl, shf = (torch.as_tensor(t, device=dev)
                    for t in pencil_sweep.build_half_shell_tables(grid))
        ftbl = torch.as_tensor(pencil_sweep.build_tile_table(grid), device=dev)
        fshf = torch.as_tensor(pencil_sweep.build_shift_table(grid), device=dev)
        for dname in ("float32", "float64"):
            dtype = getattr(torch, dname)
            eng = pe._cellpair_engine(cfg.replace(neighbor_capacity=cap, dtype=dname), dev,
                                      compensated=False, width_lists=True)
            c, _ = eng.init(state.to(dtype=dtype))
            lists = (c.wl_self, c.wl_self_cnt, c.wl_nbr_i, c.wl_nbr_j, c.wl_nbr_off)
            tag = f"N={cfg.n} cap={cap} {dname}"
            out[f"fused_pencil_chunk {tag}"] = _ms(torch, lambda: fused_pencil.fused_pencil_chunk(
                c.r, c.v, c.a, tbl, shf, P, cap, L, rc2, dt, 8), 5)
            out[f"fused_pencil_width_chunk {tag}"] = _ms(
                torch, lambda: fused_pencil.fused_pencil_width_chunk(
                    c.r, c.v, c.a, *lists, P, cap, L, rc2, dt, 8), 5)
            # The z-band (its window is the capacity at 384: every B stage
            # lies inside A), with and without observables.
            window = cell_list.default_z_window(grid, cfg.n, r_list)
            wins = cell_list.compute_z_windows(c.r, c.r[3], c.counts, grid, window, r_list)[:3]
            for want_obs in ((True, False) if (cap, dname) == (512, "float32") else (True,)):
                out[f"pencil_sweep_zband {tag}{'' if want_obs else ' no obs'}"] = _ms(
                    torch, lambda: pencil_sweep.pencil_sweep_zband(
                        c.r, ftbl, c.counts, *wins, grid, rc2, window, want_obs), 20)
            if dname == "float64":
                continue
            out[f"pencil_sweep_hs {tag}"] = _ms(torch, lambda: pencil_sweep.pencil_sweep_hs(
                c.r, tbl, c.counts, shf, grid, rc2, True), 20)
            out[f"pencil_sweep_full {tag}"] = _ms(torch, lambda: pencil_sweep.pencil_sweep(
                c.r, ftbl, c.counts, fshf, grid, rc2, True), 20)
            if cap == 512:
                # rebin + chunk of the width-listed engine, and its device ops
                run = lambda: eng.run_fast(c, 8)  # noqa: E731
                out[f"cellpair width run_fast(8) {tag}"] = _ms(torch, run, 5)
                prof = device_breakdown(run, top=1 << 30)["device_ms_by_name"]
                out[f"cellpair width run_fast(8) {tag} device ops"] = sum(
                    x["count"] for x in prof.values())
    for dname in ("float32", "float64"):
        rows = pe.make_engine(cfg.replace(dtype=dname), "rows", dev)
        c = rows.init(state.to(dtype=getattr(torch, dname)))[0]
        out[f"rows run_fast(8) N={cfg.n} {dname} ms a step"] = _ms(
            torch, lambda: rows.run_fast(c, 8), 2, warmup=1) / 8
    # The config-5 cut's initialization (its 500 warmup steps on the
    # cell-pair engine at the lattice capacity 512: width-listed chunks), s.
    cut = cfg.replace(total_steps=2_000, warmup_steps=500)
    initialize(cut, backend="cellpair", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    initialize(cut, backend="cellpair", device=dev)
    torch.cuda.synchronize()
    out[f"cellpair initialize N={cfg.n} warmup 500 s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(here), help="checkout whose ljmd_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true", help="also time every dense block shape")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("chunk_timing: needs a CUDA card", file=sys.stderr)
        return 1
    import ljmd_tpu_torch
    from ljmd_tpu_torch.ops import _cuda

    if Path(ljmd_tpu_torch.__file__).resolve().parents[1] != root:
        print(f"chunk_timing: imported {ljmd_tpu_torch.__file__}, not {root}", file=sys.stderr)
        return 1
    _cuda.library()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    times = dense_cases(torch, dev)
    times.update(pencil_cases(torch, dev, root))
    report = {"label": args.label, "root": str(root), "nvidia_smi": smi, "ms": times}
    if args.sweep:
        report["slice_sweep"] = slice_sweep(torch, dev, root)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
