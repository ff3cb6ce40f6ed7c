"""Card times of the fused chunk kernels, the pencil sweeps and the rect
sweeps of one checkout, for comparing two checkouts on one card within one
machine call:

    python ljmd_tpu_torch/experiments/chunk_timing.py [--root DIR] [--label NAME] [--sweep]
        [--dump FILE [--inputs FILE]] [--experiments]
    python ljmd_tpu_torch/experiments/chunk_timing.py --compare FILE_A FILE_B

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
9-neighbour sweep, float32 and float64, observables on and off) and kernel
12 (the z-banded sweep; its window is 384 at both capacities, so at 384
every window-B stage lies inside window A), with observables (the z-band
also without them at 512, and in float64); the
rows engine's ``run_fast(8)`` at config 5 (ms a step, float32 and
float64); the cell-pair engine's ``run_fast(8)`` with the width
lists at capacity 512 and a rebin before the chunk (the ``always``
trigger), with the device operations (kernels, copies, fills) of one such
call (torch.profiler); and ``initialize`` of config 5 cut to 500 warmup
steps on the cell-pair engine (the lattice capacity 512: width-listed
chunks), seconds on the host clock.

The multi-device path's hops (``rect_inputs``), float32 and float64,
observables on and off, on a perturbed FCC lattice in its own order (a
rank's rows a slab, as in production) and shuffled: kernel 7
(``pair_sweep_rect_newton``) at the half ring's N=4000 d=4 full hop (1000 x
1000) and both sides of its gated half hop, and both sides of the N=500 d=2
half hop (250 rows); kernel 6 (``pair_sweep_rect``) at the ring's N=4000
hops and self offsets over 4 and 2 ranks (1000 x 1000, 2000 x 2000). The
dense sweeps (``sweep_inputs``): kernel 2 (``pair_sweep_tri``) at the half
ring's self blocks (1000 rows of N=4000 over 4 ranks, 250 of N=500 over 2;
lattice order and shuffled, float32 and float64) and over the whole of
N=4000, N=864 (``examples/n864_liquid.json``'s box) and N=500, float32 and
float64; kernel 5 (``pair_sweep``) at N=4000 and N=500, float32 and
float64. A hop's kernel takes less time than the host's call, so all these
are timed on the card alone, as replays of a CUDA graph of 50 calls
(``_graph_ms``), and as back-to-back calls ("calls"), observables on and
off (the older checkouts' "pair_sweep_tri N=4000 float32", back to back with
observables, is now that case's "calls").

Kernel 10 (``fused_dense_chunk_list``, 16 steps: the zsort engine's inner
chunk) runs on the z-sorted fluid of the N=4000 and N=864 configs
(``examples/n4000_production.json``, ``n864_liquid.json``: a jittered FCC
lattice in ascending-z column order with the engine's lists), in its plain,
obs_last and extended modes, float32 and float64. Kernel 9
(``build_window_lists``) packs those lists from the fluid's flags, timed on
the card alone (a CUDA graph of 50 whole calls) and back to back
("calls"). The half-shell sweep
(kernels 13 / 14) runs at both capacities with and without observables,
float32 and float64, and on the strip of rank 0 of a 2-rank split of config
5 at capacity 384 (``n_pencils_i``: 98 i pencils + a 14-pencil halo).

``--sweep`` (a checkout whose ``ops/fused.py`` has ``dense_plan``) also times
the dense chunk at every block shape S (threads a particle) it takes: N=500
and N=4000 as above (99 steps), and the rows engine's carry at config 5 (8
steps, float32 and float64), each beside its plan (items, blocks, warps an
SM); where the checkout has ``fused_list.list_plan``, kernel 10 at every S
it takes (float32 and float64, N=4000 and N=864).

``--experiments`` times only kernels 17 and 18 (``experiment_cases``): each
of the nine probes at ITERS=200 on the card alone (graph replay) and back to
back, and each layout body at 32 and 128 visits, 512 and 128 columns, 2
steps a call: its kernel's device time from torch.profiler (``_kernel_ms``:
an older wrapper copies the visit counts from the host, which a CUDA graph
cannot capture) and the call back to back, with the slope per visit-step
between the two visit counts.

``--dump FILE`` saves the outputs of kernel 10 (every case above, 16 steps),
of kernel 9 (its lists with ``zero_fill``),
of the half-shell and the full 9-neighbour sweeps (both capacities and
precisions, observables on and off) and of kernels 2, 5, 6 and 7 (every
case above, observables on and off) with ``torch.save``, the sweeps' slot rows read from (or, the first time,
written to) ``--inputs FILE``, so that both checkouts sweep the same slots;
``--compare A B`` prints, per case, whether the outputs are equal bit for
bit (``torch.equal``; for the pencil sweeps with the elements and rows that
differ, and those on valid slots) and max |A - B| / max(1, max |B|).
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


def _graph_ms(torch, fn, reps: int, rounds: int = 3) -> float:
    """ms of one ``fn()`` on the card alone: ``reps`` calls captured in one
    CUDA graph, the least over ``rounds`` replays of the mean (CUDA events).
    The host's cost of a call (checks, allocation, the launch), which
    ``_ms`` includes wherever it exceeds the kernel's time, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _kernel_ms(torch, calls, reps: int, name_part: str) -> list[float]:
    """Device ms of one launch of each call's kernel (kernel names holding
    ``name_part``), from one torch.profiler session that runs calls[0]
    ``reps`` times, then calls[1], ...: the kernel alone, without the
    wrapper's own small launches, for wrappers a CUDA graph cannot capture
    (an older one copies its counts from the host). A session that lost
    launches (a process's first can) is run again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    for c in calls:
        c()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for c in calls:
                for _ in range(reps):
                    c()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if name_part in e.name
                      and e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if len(evs) == reps * len(calls):
            return [sum(e.time_range.elapsed_us() for e in evs[k * reps:(k + 1) * reps])
                    / reps / 1e3 for k in range(len(calls))]
    raise RuntimeError(f"the profiler saw {len(evs)} launches of {name_part}, "
                       f"not {reps * len(calls)}, three times")


# Kernels 17 and 18 (--experiments): the probes at ITERS, the bodies at 32 and
# 128 visits, each at 512 and 128 columns, LAYOUT_STEPS steps a call.
LAYOUT_BODIES = ("k1", "k2b", "k2", "k3", "k4", "k4z", "k5a", "k5b", "k5c", "k6")
LAYOUT_STEPS = 2


def experiment_cases(torch, dev) -> dict:
    """Kernel 17's nine probes (``probe``: on the card alone by graph replay,
    and back to back) and kernel 18's bodies (``layout_body``: the kernel's
    device time by ``_kernel_ms``, and the call back to back) through the
    wrappers every checkout since PR 6 shares, with each body's slope per
    visit-step between 32 and 128 visits."""
    from ljmd_tpu_torch.experiments import layout as ly
    from ljmd_tpu_torch.experiments import mosaic_support as ms

    out = {}
    for name, _ in ms.PROBES:
        inputs = ms.probe_inputs(name, dev)
        out[f"probe {name} card"] = _graph_ms(torch, lambda: ms.probe(name, *inputs), 20)
        out[f"probe {name} calls"] = _ms(torch, lambda: ms.probe(name, *inputs), 20)
    r8, rT = ly.make_state(0, ly.N_PAD, dev)
    ti, tj = ly.visit_lists(128, 7, ly.N_PAD)
    for name in LAYOUT_BODIES:
        for tj_w in (512, 128):
            lists = [torch.tensor(x, dtype=torch.int32, device=dev)
                     for x in ly.variant_lists(name, tj_w, ti, tj, ly.N_PAD)]
            calls = [lambda v=v: ly.layout_body(name, r8, rT, *lists, v, tj_w, LAYOUT_STEPS)
                     for v in (32, 128)]
            kern = dict(zip((32, 128), _kernel_ms(torch, calls, 10, "layout_kernel")))
            for v, call in zip((32, 128), calls):
                out[f"layout {name}-{tj_w} v={v} kernel"] = kern[v]
                out[f"layout {name}-{tj_w} v={v} calls"] = _ms(torch, call, 10)
            out[f"layout {name}-{tj_w} ns per visit-step"] = \
                1e6 * (kern[128] - kern[32]) / (96 * LAYOUT_STEPS)
    return out


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


def rect_inputs(torch, dev):
    """(kernel, label, args) of the rect sweeps' cases at the multi-device
    path's shapes, on perturbed FCC lattices (L=16.796, rc=2.5 at N=4000;
    L=10, rc=4.9 at N=500) cut into the ranks' row blocks, float32 and
    float64, in lattice order (a rank's rows are contiguous particle
    indices, as in production: slabs) and shuffled; the rect-Newton sweep
    (kernel 7) at the half ring's hops: N=4000 over 4 ranks the full hop
    (1000 x 1000) and both sides of the gated half hop, N=500 over 2 both
    sides of its half hop (250 rows); the rect sweep (kernel 6) at the
    ring's N=4000 hops and self offsets over 4 and 2 ranks (1000 x 1000,
    2000 x 2000). Args exclude the observables flag."""
    import numpy as np

    cases = []
    for label, k, box, rc in (("N=4000", 10, 16.795961913825, 2.5), ("N=500", 5, 10.0, 4.9)):
        for dname in ("float32", "float64"):
            n, lattice, _ = _fcc_rows(torch, k, box, 1234 + k, getattr(torch, dname), dev)
            shuffled = lattice.clone()
            shuffled[:, :n] = shuffled[:, torch.as_tensor(np.random.default_rng(k).permutation(n),
                                                         device=dev)]
            for order, src in (("lattice", lattice), ("shuffled", shuffled)):
                def blk(s, ni):
                    out = torch.zeros((8, -(-ni // 128) * 128), dtype=src.dtype, device=dev)
                    out[:, :ni] = src[:, s * ni:(s + 1) * ni]
                    return out

                tag = f"{order} {dname}"
                if label == "N=4000":
                    ni, h = n // 4, n // 8
                    for name, si, sj, i_lo, j_hi in (("d=4 hop", 1, 0, 0, ni),
                                                     ("d=4 half_low", 0, 2, h, ni),
                                                     ("d=4 half_high", 2, 0, 0, h)):
                        cases.append(("pair_sweep_rect_newton", f"{label} {name} {tag}",
                                      (blk(si, ni), blk(sj, ni), ni, ni, si * ni, sj * ni, box,
                                       rc * rc, i_lo, j_hi)))
                    for d in (4, 2):
                        ni = n // d
                        cases.append(("pair_sweep_rect", f"{label} d={d} hop {tag}",
                                      (blk(1, ni), blk(0, ni), ni, ni, ni, 0, box, rc * rc)))
                        cases.append(("pair_sweep_rect", f"{label} d={d} self {tag}",
                                      (blk(1, ni), blk(1, ni), ni, ni, ni, ni, box, rc * rc)))
                else:
                    ni, h = n // 2, n // 4
                    for name, si, sj, i_lo, j_hi in (("d=2 half_low", 0, 1, h, ni),
                                                     ("d=2 half_high", 1, 0, 0, h)):
                        cases.append(("pair_sweep_rect_newton", f"{label} {name} {tag}",
                                      (blk(si, ni), blk(sj, ni), ni, ni, si * ni, sj * ni, box,
                                       rc * rc, i_lo, j_hi)))
    return cases


def sweep_inputs(torch, dev):
    """(kernel, label, args) of the dense sweeps' cases (module docstring),
    args without the observables flag: kernel 2 at the half ring's self
    blocks (a rank's rows, as ``rect_inputs`` cuts them) and over whole
    boxes, kernel 5 over whole boxes."""
    import numpy as np

    cases = []
    for label, k, box, rc in (("N=4000", 10, 16.795961913825, 2.5), ("N=500", 5, 10.0, 4.9),
                              ("N=864", 6, 10.077577148295, 0.248075501007 * 10.077577148295)):
        for dname in ("float32", "float64"):
            n, lattice, _ = _fcc_rows(torch, k, box, 1234 + k, getattr(torch, dname), dev)
            cases.append(("pair_sweep_tri", f"{label} {dname}", (lattice, n, box, rc * rc)))
            if label != "N=864":
                cases.append(("pair_sweep", f"{label} {dname}", (lattice, n, box, rc * rc)))
                shuffled = lattice.clone()
                shuffled[:, :n] = shuffled[:, torch.as_tensor(
                    np.random.default_rng(k).permutation(n), device=dev)]
                ni = n // (4 if label == "N=4000" else 2)
                for order, src in (("lattice", lattice), ("shuffled", shuffled)):
                    blk = torch.zeros((8, -(-ni // 128) * 128), dtype=src.dtype, device=dev)
                    blk[:, :ni] = src[:, ni:2 * ni]
                    cases.append(("pair_sweep_tri", f"{label} self block {ni} {order} {dname}",
                                  (blk, ni, box, rc * rc)))
    return cases


def rect_cases(torch, dev) -> dict:
    """ms of kernels 7 and 6 (``rect_inputs``) and 2 and 5
    (``sweep_inputs``), observables on and off, on the card alone
    (``_graph_ms``: a hop's kernel takes less time than the host's call) and
    as back-to-back calls (``_ms``, "calls")."""
    from ljmd_tpu_torch.ops import pair_sweep

    out = {}
    for kernel, label, args in rect_inputs(torch, dev) + sweep_inputs(torch, dev):
        fn = getattr(pair_sweep, kernel)
        for want_obs in (True, False):
            key = f"{kernel} {label}{'' if want_obs else ' no obs'}"
            out[key] = _graph_ms(torch, lambda: fn(*args, want_observables=want_obs), 50)
            out[f"{key} calls"] = _ms(torch, lambda: fn(*args, want_observables=want_obs), 50)
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
            # The half-shell sweep on the grid, and on rank 0's strip of a
            # 2-rank split (at 384, the sharded engine's census capacity).
            sargs, p_loc = strip_args(torch, c, grid, rc2)
            for want_obs in (True, False):
                o = "" if want_obs else " no obs"
                out[f"pencil_sweep_hs {tag}{o}"] = _ms(
                    torch, lambda: pencil_sweep.pencil_sweep_hs(
                        c.r, tbl, c.counts, shf, grid, rc2, want_obs), 20)
                if cap == 384:
                    out[f"pencil_sweep_hs strip {p_loc}+{grid.m_xy} {tag}{o}"] = _ms(
                        torch, lambda: pencil_sweep.pencil_sweep_hs(
                            *sargs, want_obs, n_pencils_i=p_loc), 20)
            for want_obs in (True, False):
                out[f"pencil_sweep_full {tag}{'' if want_obs else ' no obs'}"] = _ms(
                    torch, lambda: pencil_sweep.pencil_sweep(c.r, ftbl, c.counts, fshf, grid, rc2,
                                                             want_obs), 20)
            if dname == "float64":
                continue
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


def _sorted_fluid(torch, cfg, n_pad, seed, dtype, dev):
    """A jittered FCC lattice of ``cfg`` in ascending-z column order as
    (8, n_pad) rows, with velocities and consistent accelerations (as
    chip_smoke.py's ``sorted_fluid``)."""
    import numpy as np

    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops.pair_sweep import pair_forces_plain

    rng = np.random.default_rng(seed)
    L = cfg.box_length
    r = fcc_lattice(cfg.num_cells, L, dtype=torch.float64).numpy()
    n = r.shape[0]
    r = np.mod(r + rng.normal(scale=0.04 * L / cfg.num_cells, size=r.shape), L)
    order = np.argsort(r[:, 2])
    v = rng.uniform(-0.5, 0.5, size=r.shape)
    v -= v.mean(axis=0)

    def rows(x):
        out = torch.zeros((8, n_pad), dtype=dtype, device=dev)
        out[0:3, :n] = torch.as_tensor(x[order].T, dtype=dtype, device=dev)
        return out

    r8 = rows(r)
    return n, r8, rows(v), 24.0 * pair_forces_plain(r8, n, L, cfg.rc_square)


LIST_MODES = ("plain", "obs_last", "extended")


def list_inputs(torch, dev, root: Path):
    """(label, dtype name, args, kwargs by mode, tile_j, pack args) of every
    kernel-10 case: the zsort engine's lists of the sorted fluid, 16 steps;
    pack args are kernel 9's (flags, n, n_pad, tile_i, tile_j) for them."""
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import zsort_geometry
    from ljmd_tpu_torch.ops import window_lists

    cases = []
    for label, name in (("N=4000", "n4000_production.json"), ("N=864", "n864_liquid.json")):
        cfg = load_config(str(root / "examples" / name))
        geo = zsort_geometry(cfg, inner_chunk=16)
        L, n_pad, tj = cfg.box_length, geo.n_pad, geo.tile_j
        for dname in ("float32", "float64"):
            n, r, v, a = _sorted_fluid(torch, cfg, n_pad, 4321 + cfg.num_cells,
                                       getattr(torch, dname), dev)
            flags = window_lists.compute_tile_flags(r, n, 128, 128, L, geo.window,
                                                    cross_margin=0.6 * geo.sort_skin)
            tiles, tcounts = window_lists.build_window_lists(flags, n, n_pad, 128, tj)
            zero = torch.zeros_like(r)
            kw = {"plain": {}, "obs_last": {"obs_last": True},
                  "extended": {"r_lo": zero, "vc": zero}}
            cases.append((label, dname, (r, v, a, tiles, tcounts, n, L, cfg.rc_square, cfg.dt,
                                         16), kw, tj, (flags, n, n_pad, 128, tj)))
    return cases


def list_cases(torch, dev, root: Path, sweep: bool = False) -> dict:
    from ljmd_tpu_torch.ops import fused_list, window_lists

    out = {}
    for label, dname, args, kw, tj, pack in list_inputs(torch, dev, root):
        # Kernel 9 on the card alone (a graph of 50 whole calls) and back to
        # back (the host's call).
        key = f"build_window_lists {label} {dname}"
        out[key] = _graph_ms(torch, lambda: window_lists.build_window_lists(*pack), 50)
        out[f"{key} calls"] = _ms(torch, lambda: window_lists.build_window_lists(*pack), 50)
        for mode in LIST_MODES:
            out[f"fused_dense_chunk_list {label} {dname} {mode}"] = _ms(
                torch, lambda: fused_list.fused_dense_chunk_list(*args, tile_j=tj, **kw[mode]), 10)
        if sweep and hasattr(fused_list, "list_plan"):
            r = args[0]
            res = {}
            for s in (4, 8, 16, 32, 64):
                plan = fused_list.list_plan(r, slices=s)
                ms = _ms(torch, lambda: fused_list._launch(*args, 128, tj, None, None, False,
                                                           slices=s), 10)
                res[f"S={s}"] = {"ms": ms, **{k: plan[k] for k in (
                    "items", "blocks", "blocks_per_sm", "warps_per_sm", "resident")}}
            out[f"fused_dense_chunk_list {label} {dname} plain by S"] = res
    return out


def strip_args(torch, c, grid, rc_square, d: int = 2, rank: int = 0):
    """The half-shell sweep's arguments for ``rank``'s strip of a d-rank
    split of the cell-pair carry ``c`` plus its halo, and the strip's i
    pencils."""
    from ljmd_tpu_torch.parallel import spatial_pencil as sp

    m, cap = grid.m_xy, grid.capacity
    m_xl = m // d
    p_loc = m_xl * m
    w = p_loc * cap
    nxt = (rank + 1) % d
    dev = c.r.device
    r_aug = torch.cat([c.r[:, rank * w:(rank + 1) * w], c.r[:, nxt * w:nxt * w + m * cap]], 1)
    counts = sp.augmented_counts(c.counts, m, d)[rank]
    tbl = torch.as_tensor(sp._local_half_shell_table(m, m_xl), device=dev)
    shf = torch.as_tensor(sp._device_shift_tables(m, m_xl, d)[rank], device=dev)
    return (r_aug.contiguous(), tbl, counts.contiguous(), shf, grid, rc_square), p_loc


def dump_outputs(torch, dev, root: Path, path: str, inputs_path: str = "") -> int:
    """Save kernel 10's and the half-shell sweep's outputs (see the module
    docstring). The sweep's slot rows come from the cell-pair engine's
    binning, whose rank order within a pencil may differ between runs: with
    ``inputs_path`` they are read from that file where it exists, else made
    and written there, so that two checkouts sweep the same slots."""
    import types

    import numpy as np

    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import cell_list, fused_list, pair_sweep, pencil_sweep, window_lists
    from ljmd_tpu_torch.state import MDState

    out = {}
    cfg = load_config(str(root / "examples" / "n62500_large.json"))
    rng = np.random.default_rng(5)
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64)
    r = torch.remainder(r + torch.as_tensor(rng.normal(0, 0.05, r.shape)), cfg.box_length)
    v = torch.as_tensor(rng.normal(0, 0.8, r.shape))
    state = MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)).to(device=dev)
    saved = torch.load(inputs_path) if inputs_path and Path(inputs_path).exists() else {}
    made = {}
    for cap in (512, 384):
        grid = cell_list.make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                          cfg.density, cap)
        tbl, shf = (torch.as_tensor(t, device=dev)
                    for t in pencil_sweep.build_half_shell_tables(grid))
        ftbl = torch.as_tensor(pencil_sweep.build_tile_table(grid), device=dev)
        fshf = torch.as_tensor(pencil_sweep.build_shift_table(grid), device=dev)
        for dname in ("float32", "float64"):
            key = f"cap={cap} {dname}"
            if key in saved:
                c = types.SimpleNamespace(r=saved[key]["r"].to(dev),
                                          counts=saved[key]["counts"].to(dev))
            else:
                eng = pe._cellpair_engine(cfg.replace(neighbor_capacity=cap, dtype=dname), dev,
                                          compensated=False, width_lists=True)
                c = eng.init(state.to(dtype=getattr(torch, dname)))[0]
                made[key] = {"r": c.r.cpu(), "counts": c.counts.cpu()}
            sargs, p_loc = strip_args(torch, c, grid, cfg.rc_square)
            for obs in (True, False):
                out[f"hs {key} obs={obs}"] = [pencil_sweep.pencil_sweep_hs(
                    c.r, tbl, c.counts, shf, grid, cfg.rc_square, obs).cpu(), c.r[3].cpu()]
                out[f"full {key} obs={obs}"] = [pencil_sweep.pencil_sweep(
                    c.r, ftbl, c.counts, fshf, grid, cfg.rc_square, obs).cpu(), c.r[3].cpu()]
                out[f"hs strip {key} obs={obs}"] = [pencil_sweep.pencil_sweep_hs(
                    *sargs, obs, n_pencils_i=p_loc).cpu(), sargs[0][3].cpu()]
    if inputs_path and made:
        torch.save(made, inputs_path)
    torch.save(out, path)
    for label, dname, args, kw, tj, pack in list_inputs(torch, dev, root):
        for mode in LIST_MODES:
            res = fused_list.fused_dense_chunk_list(*args, tile_j=tj, **kw[mode])
            out[f"list {label} {dname} {mode}"] = [t.cpu() for t in res]
        res = window_lists.build_window_lists(*pack, zero_fill=True)
        out[f"build_window_lists {label} {dname}"] = [t.cpu() for t in res]
    for kernel, label, args in rect_inputs(torch, dev) + sweep_inputs(torch, dev):
        for obs in (True, False):
            res = getattr(pair_sweep, kernel)(*args, want_observables=obs)
            res = res if isinstance(res, tuple) else (res,)
            out[f"{kernel} {label} obs={obs}"] = [t.cpu() for t in res]
    torch.save(out, path)
    print(f"chunk_timing: saved {len(out)} cases to {path}")
    return 0


def compare_dumps(path_a: str, path_b: str) -> int:
    import torch

    a, b = torch.load(path_a), torch.load(path_b)
    report = {}
    for key in sorted(set(a) & set(b)):
        if key.startswith(("hs", "full")):
            x, y = a[key][0], b[key][0]
            diff = x != y
            valid = a[key][1] > 0.5
            report[key] = {"bit_identical": bool(torch.equal(x, y)),
                           "inputs_equal": bool(torch.equal(a[key][1], b[key][1])),
                           "differing": int(diff.sum()),
                           "differing_valid": int((diff & valid[None]).sum()),
                           "rows": sorted({int(r) for r in torch.nonzero(diff)[:, 0]}),
                           "rel_err": float((x.double() - y.double()).abs().max())
                           / max(1.0, float(y.double().abs().max()))}
        else:
            worst = 0.0
            for x, y in zip(a[key], b[key]):
                x64, y64 = x.double(), y.double()
                worst = max(worst, float((x64 - y64).abs().max())
                            / max(1.0, float(y64.abs().max())))
            report[key] = {"bit_identical": all(bool(torch.equal(x, y))
                                                for x, y in zip(a[key], b[key])),
                           "rel_err": worst}
    print(json.dumps({"compare": [path_a, path_b], "cases": report}))
    return 0


def main(argv=None) -> int:
    here = Path(__file__).resolve().parents[2]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(here), help="checkout whose ljmd_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true", help="also time every dense block shape")
    ap.add_argument("--dump", default="", help="save the list chunk's and sweep's outputs here")
    ap.add_argument("--inputs", default="", help="with --dump: the sweep's slot rows (read "
                                                 "where the file exists, else written)")
    ap.add_argument("--experiments", action="store_true",
                    help="time only kernels 17 and 18 (experiment_cases)")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"),
                    help="compare two --dump files and exit")
    args = ap.parse_args(argv)
    if args.compare:
        return compare_dumps(*args.compare)
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
    if args.dump:
        return dump_outputs(torch, dev, root, args.dump, args.inputs)
    if args.experiments:
        print(json.dumps({"label": args.label, "root": str(root), "nvidia_smi": smi,
                          "ms": experiment_cases(torch, dev)}))
        return 0
    times = dense_cases(torch, dev)
    times.update(list_cases(torch, dev, root, args.sweep))
    times.update(pencil_cases(torch, dev, root))
    times.update(rect_cases(torch, dev))
    report = {"label": args.label, "root": str(root), "nvidia_smi": smi, "ms": times}
    if args.sweep:
        report["slice_sweep"] = slice_sweep(torch, dev, root)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
