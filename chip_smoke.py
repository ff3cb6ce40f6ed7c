#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``ljmd_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py

It fails (non-zero exit, no result line) without a CUDA device or outside a
checkout. Phases, each fatal on failure:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: compile the kernels of ``ljmd_tpu_torch/csrc`` with nvcc (one
   process per source, in parallel);
3. each kernel against its plain PyTorch twin on the card, with the times of
   both (CUDA events) and the least time the card could take for the same
   work (``bound_ms``):
   a. the rows path's kernels on seeded perturbed-FCC inputs at N=500 (the
      reference default's box) and N=4000 (``examples/n4000_production.json``),
      float32 and float64;
   b. the zsort path's kernels at the zsort engine's own geometry for
      ``examples/n4000_production.json`` (n_pad 4096) and
      ``examples/n864_liquid.json`` (n_pad 896): the visit-list pack on the
      flags of a z-sorted fluid and on random flags (lists compared exactly),
      the fused list chunk in its plain, ``obs_last`` and extended modes,
      float32 and float64;
   c. the cell-pair path's kernels at BASELINE config 5's geometry
      (``examples/n62500_large.json``, 14x14 pencils) on the post-production
      fluid of phase 4c, at capacity 512 (the lattice's) and 384 (the
      post-warmup census), float32 and
      float64: the half-shell sweep with and without observables, the fused
      pencil chunk and the width-listed chunk, each plain and extended;
4. the main path, each run with the launch counts set to 0 just before and
   read just after:
   a. rows (``--backend rows``): the CLI on the reference default cut to
      20,000 steps (float64), the same path in process in float32 (the
      compensated ``_ext`` kernel), and N=4000 cut to 5,000 steps;
   b. zsort (``--backend auto``, which picks it on the card): the CLI on
      N=4000 cut to 5,000 steps, N=864 cut the same way, and N=4000 with
      ``compensated_sum`` (the extended list chunk); N=864 also runs on rows
      for the rate comparison;
   c. cellpair (``--backend auto``, which picks it on the card): the CLI on
      config 5 cut to 2,000 steps (warmup 500: the width-listed chunk at the
      lattice capacity 512; production: the static chunk at the census
      capacity 384), the same in process with production at capacity 512
      (the width-listed chunk) and with ``compensated_sum`` (the extended
      chunks and the predictive rebin trigger);
   every run must launch its kernels and no other engine's, write every
   artifact, give finite means and thermo, keep ``zsort_invalid`` /
   ``pencil_overflow`` False and conserve energy within a stated bound;
5. the three cell-pair chunk paths (fused static, fused width, unfused) from
   three N=62500 states, 100 steps each, at capacities 512 and the census:
   states within PATHS_TOL in float64 and float32 (and the unfused path at
   its default chunk of 12, timed, its overflow flag recorded); a planted
   fault (fused static over tables that miss two neighbour-pencil pairs)
   must exceed both limits;
6. the rows question: whether the rows engine runs N=62500 at all;
7. zsort and cellpair against rows on the card: one float64 N=4000 state,
   32 fused steps (resorts / rebins between chunks): within 1e-10;
8. the rows path on the card and on the CPU from one state (N=256, 200
   steps, float64): the sampled series must agree to 1e-8.

The lines before the last hold the particle-steps/s of the engines beside
the card's name and power limit, one JSON object with the kernels' launches,
errors, times and bounds, and the ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Energy conservation bounds on |E_last - E_first| / |E_first| over the
# sampled etot series. Each was set from a CPU run of the same cut config
# (see PERF.md, "Cells"): about 10x the drift measured there.
DRIFT_BOUND = {
    "reference_default_f64": 1e-3,
    "reference_default_f32": 1e-3,
    "n4000_f32": 1e-3,
    "n4000_f32_zsort": 1e-3,
    "n864_f32_zsort": 1e-3,
    "n864_f32": 1e-3,
    "n4000_f32_compensated_zsort": 1e-3,
    "n62500_f32_cellpair": 1e-3,
    "n62500_f32_cap512_cellpair": 1e-3,
    "n62500_f32_compensated_cellpair": 1e-3,
}

# Kernel vs plain twin, max |kernel - twin| / max(1, max |twin|) per output
# array. float64: summation order is the only difference (the per-pair
# arithmetic is bit-identical), so 1e-10 is far above the ~1e-15 it moves.
# float32: sums of up to N=4000 terms in another order differ by up to
# ~N * eps32 = 2.4e-4 of the largest term in the worst case (~sqrt(N) *
# eps32 = 4e-6 typically); 1e-4 keeps margin over the typical case while a
# single wrong pair term (>= 1e-2 of the row scale) would fail.
KERNEL_TOL = {"float64": 1e-10, "float32": 1e-4}
SERIES_RTOL = 1e-8
VS_ROWS_TOL = 1e-10

DEVICE = "cuda"
# Phase 3 shapes: (label, num_cells, box, rc) of the reference default's box
# and of the N=4000 production config's box.
SHAPES = [
    ("N=500", 5, 10.0, 4.9),
    ("N=4000", 10, 16.795961913825, 0.148845300604 * 16.795961913825),
]
CHUNK_STEPS = 99  # run_fast(interval - 1) at output_interval = 100
LIST_CHUNK_STEPS = 16  # the zsort engine's inner chunk at both zsort configs
# Phase 3b shapes: (label, example config) at the zsort engine's geometry.
ZSORT_SHAPES = [("N=4000", "n4000_production.json"), ("N=864", "n864_liquid.json")]
# Phase 4 cuts of the example configs, and phase 6's.
REF_CUT = {"total_steps": 20_000}
N4000_CUT = {"total_steps": 5_000, "warmup_steps": 1_000}
N864_CUT = {"total_steps": 5_000, "warmup_steps": 1_000}
CARD_VS_CPU_CUT = {"dtype": "float64", "total_steps": 200, "warmup_steps": 0}
VS_ROWS_STEPS = 32
ZSORT_KERNELS = ("build_window_lists", "fused_dense_chunk_list")
# The cell-pair slice: BASELINE config 5 (N=62500) cut to 2,000 steps with a
# 500-step warmup (interval 100 kept); the kernel checks at the lattice
# capacity 512 (where the JAX rule turns the width lists on) and at the
# post-warmup census 384; fused checks over PENCIL_CHECK_STEPS, timed over the
# engine's fused inner chunk.
N62500_CUT = {"total_steps": 2_000, "warmup_steps": 500}
PENCIL_CAPS = (512, 384)
PENCIL_CHECK_STEPS = 4
PENCIL_CHUNK_STEPS = 8
PENCIL_KERNELS = ("pencil_sweep_hs", "fused_pencil_chunk", "fused_pencil_width_chunk")
# The three chunk paths from one state, 100 steps: they round the drift and
# sum each slot's forces in other orders. float64: that rounding (~1e-16)
# grown by the fluid's chaos stays far under 1e-9, while one missed pair
# near the cutoff (|F| ~ 0.016) moves v by ~8e-3, ~2e-3 of max |v|. float32:
# a 1-ulp position difference at L=42 (3.8e-6) moves the acceleration of a
# close contact by ~1e-4 of max |a|, and chaos grows it ~10x over the
# stretch, as far as the missed pair's own ~2e-3; so float32 cannot see one
# missed pair and float64 is that check. The float32 limit, 5e-3, is 4.3x
# the worst sound reading of phase 5 (1.15e-3 unfused, 6.8e-4 from a second
# state, 2.5e-4 width; on the H100) and guards against gross faults: phase
# 5 plants one (the tables miss two neighbour-pencil pairs: the particles
# on those faces overlap) and requires both limits to reject it.
PATHS_STEPS = 100
PATHS_TOL = {"float64": 1e-9, "float32": 5e-3}

# Least time of a kernel's work (bound_ms): the larger of its bytes (each
# input read once, each output written once) over the HBM rate and its
# operations over the peak rate of their type outside the tensor cores
# (NVIDIA H100 SXM data sheet: 67 TFLOP/s float32, 34 TFLOP/s float64,
# 3.35 TB/s). Operations are counted from this run's data: per candidate pair
# of the kernel's pair set (valid particles only, pair once) the
# displacement, the minimum-image round and r^2 (13); per pair inside the
# cutoff the LJ force terms and both sides' sums (17, a divide counted as
# one) and the observables (10 more); per particle and step the two
# half-kicks and the drift (24).
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12
FLOPS_CANDIDATE, FLOPS_FORCE, FLOPS_OBS, FLOPS_SLOT_STEP = 13, 17, 10, 24


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------- phase 1
def phase_environment(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return {"nvidia_smi": smi}


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    from ljmd_tpu_torch.ops import _cuda

    t0 = time.time()
    lib_path = _cuda.build(verbose=True)
    _cuda.library()
    log(f"build: {lib_path} ready in {time.time() - t0:.1f}s")


# ---------------------------------------------------------------- phase 3
def perturbed_fcc(num_cells, box_length, seed, torch, dtype, device):
    """Seeded perturbed FCC lattice as (8, n_pad) rows, velocities and
    consistent accelerations (plain twin, float64)."""
    import numpy as np

    from ljmd_tpu_torch.models.engine import ROW_PAD
    from ljmd_tpu_torch.models.lattice import fcc_lattice

    rng = np.random.default_rng(seed)
    r = fcc_lattice(num_cells, box_length, dtype=torch.float64).numpy()
    n = r.shape[0]
    r = np.mod(r + rng.normal(scale=0.04 * box_length / num_cells, size=r.shape), box_length)
    v = rng.uniform(-0.5, 0.5, size=r.shape)
    v -= v.mean(axis=0)
    n_pad = -(-n // ROW_PAD) * ROW_PAD

    def rows(x):
        out = torch.zeros((8, n_pad), dtype=dtype, device=device)
        out[0:3, :n] = torch.as_tensor(x.T, dtype=dtype, device=device)
        return out

    return n, rows(r), rows(v)


def rel_err(k, p) -> tuple[float, float]:
    """(max |k - p|, that over max(1, max |p|)), in float64."""
    k64, p64 = k.double(), p.double()
    err = float((k64 - p64).abs().max())
    return err, err / max(1.0, float(p64.abs().max()))


def cuda_time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(dname: str, flops: float, nbytes: float) -> dict:
    """bound_ms / bound_by of work of ``flops`` operations and ``nbytes``
    bytes in ``dname`` (the constants above)."""
    t_ops = flops / PEAK_FLOPS[dname]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": float(flops), "bytes": float(nbytes)}


def pairs_within(torch, xyz, box_length: float, rc_square: float) -> int:
    """Pairs (i < j) of the (n, 3) positions closer than the cutoff under
    the minimum image, counted on the card in float64 in row blocks."""
    x = xyz.double()
    n = x.shape[0]
    cols = torch.arange(n, device=x.device)
    total = 0
    for i0 in range(0, n, 512):
        d = x[i0:i0 + 512, None, :] - x[None, :, :]
        d -= box_length * torch.round(d / box_length)
        r2 = (d * d).sum(dim=-1)
        upper = cols[None, :] > cols[i0:i0 + 512, None]
        total += int(((r2 < rc_square) & upper).sum())
    return total


def chunk_flops(steps: int, candidates: int, cut_pairs: int, n: int) -> float:
    """Operations of ``steps`` observable-free Verlet steps."""
    return steps * (candidates * FLOPS_CANDIDATE + cut_pairs * FLOPS_FORCE + n * FLOPS_SLOT_STEP)


def sweep_flops(candidates: int, cut_pairs: int, want_obs: bool) -> float:
    return candidates * FLOPS_CANDIDATE + cut_pairs * (FLOPS_FORCE + (FLOPS_OBS if want_obs else 0))


def phase_kernels(torch) -> dict:
    from ljmd_tpu_torch.ops import fused, pair_sweep, pair_terms
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    chunk = CHUNK_STEPS
    log("tolerances (max |kernel - twin| / max(1, max |twin|)): float64 1e-10, the per-pair "
        "arithmetic is bit-identical and only the summation order differs; float32 1e-4, "
        "below the N * eps32 = 2.4e-4 worst case of a 4000-term sum in another order")
    cases = {"pair_sweep_tri": [], "fused_dense_chunk": [], "fused_dense_chunk_ext": []}
    pair_terms_report = []
    for label, k, box, rc in SHAPES:
        rc2 = rc * rc
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            tol = KERNEL_TOL[dname]
            n, r, v = perturbed_fcc(k, box, 1234 + k, torch, dtype, dev)
            a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc2)
            cand, cut = n * (n - 1) // 2, pairs_within(torch, r[0:3, :n].T, box, rc2)
            rows_bytes = 8 * r.shape[1] * r.element_size()  # one (8, n_pad) array
            torch.cuda.synchronize()

            # Kernel 1 (device function) through its element-wise kernel.
            r2 = torch.linspace(0.09, 1.1 * rc2, 1 << 16, dtype=dtype, device=dev)
            mask = r2 < rc2
            got = pair_terms.lj_pair_terms(r2, mask, True)
            want = pair_terms.lj_pair_terms_plain(r2, mask, True)
            fast = pair_terms.lj_pair_terms(r2, mask, False)[0]
            terms_err = max(rel_err(g, w)[1] for g, w in zip(got, want))
            require(bool(torch.equal(fast, got[0])),
                    f"lj_pair_terms {dname}: force-only coef differs from the observable path's")
            require(terms_err <= tol, f"lj_pair_terms {dname}: rel err {terms_err:.3e} > {tol}")
            n_el, size = r2.numel(), r2.element_size()
            pair_terms_report.append({
                **bound(dname, int(mask.sum()) * (FLOPS_FORCE + FLOPS_OBS),
                        n_el * (size + 1 + 4 * size)),
                "shape": label, "dtype": dname, "rel_err": terms_err,
                "max_abs_err": max(rel_err(g, w)[0] for g, w in zip(got, want)),
                "bit_identical": all(bool(torch.equal(g, w)) for g, w in zip(got, want)),
                "ms": cuda_time_ms(torch, lambda: pair_terms.lj_pair_terms(r2, mask, True), 50),
                "plain_ms": cuda_time_ms(torch, lambda: pair_terms.lj_pair_terms_plain(r2, mask, True), 20)})

            # Kernel 2: tri sweep, rows 0..5 per column.
            got = pair_sweep.pair_sweep_tri(r, n, box, rc2, True)
            want = pair_sweep.pair_sweep_tri_plain(r, n, box, rc2, True)
            errs = [rel_err(got[row], want[row]) for row in range(6)]
            require(bool((got[6:] == 0).all()) and bool((got[:, n:] == 0).all()),
                    f"pair_sweep_tri {label} {dname}: padding rows/columns not zero")
            worst = max(e[1] for e in errs)
            require(worst <= tol, f"pair_sweep_tri {label} {dname}: rel err {worst:.3e} > {tol}")
            ms = cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_tri(r, n, box, rc2, True), 50)
            plain_ms = cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_tri_plain(r, n, box, rc2, True), 5)
            cases["pair_sweep_tri"].append({
                **bound(dname, sweep_flops(cand, cut, True), 2 * rows_bytes),
                "shape": label, "dtype": dname, "max_abs_err": max(e[0] for e in errs),
                "rel_err": worst, "ms": ms, "plain_ms": plain_ms})

            # Kernel 3: fused chunk, 10 steps against the plain step loop.
            dt = 0.005 if label == "N=4000" else 1e-4
            got = fused.fused_dense_chunk(r, v, a, n, box, rc2, dt, 10)
            want = fused.fused_dense_chunk_plain(r, v, a, n, box, rc2, dt, 10)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            worst = max(e[1] for e in errs)
            require(worst <= tol, f"fused_dense_chunk {label} {dname}: rel err {worst:.3e} > {tol}")
            ms = cuda_time_ms(torch, lambda: fused.fused_dense_chunk(r, v, a, n, box, rc2, dt, chunk), 5)
            plain_ms = cuda_time_ms(torch, lambda: fused.fused_dense_chunk_plain(r, v, a, n, box, rc2, dt, chunk), 1, warmup=1)
            cases["fused_dense_chunk"].append({
                **bound(dname, chunk_flops(chunk, cand, cut, n), 6 * rows_bytes),
                "shape": label, "dtype": dname, "max_abs_err": max(e[0] for e in errs),
                "rel_err": worst, "ms": ms, "plain_ms": plain_ms})

            # Kernel 4: extended chunk (the path float32 configs take).
            if dname == "float32":
                zero = torch.zeros_like(r)
                got = fused.fused_dense_chunk_ext(r, zero, v, zero, a, n, box, rc2, dt, 10)
                want = fused.fused_dense_chunk_ext_plain(r, zero, v, zero, a, n, box, rc2, dt, 10)
                pairs = [(got[0].double() + got[1].double(), want[0].double() + want[1].double()),
                         (got[2].double() + got[3].double(), want[2].double() + want[3].double()),
                         (got[4], want[4])]
                errs = [rel_err(g, w) for g, w in pairs]
                worst = max(e[1] for e in errs)
                require(worst <= tol, f"fused_dense_chunk_ext {label}: rel err {worst:.3e} > {tol}")
                ms = cuda_time_ms(torch, lambda: fused.fused_dense_chunk_ext(
                    r, zero, v, zero, a, n, box, rc2, dt, chunk), 5)
                plain_ms = cuda_time_ms(torch, lambda: fused.fused_dense_chunk_ext_plain(
                    r, zero, v, zero, a, n, box, rc2, dt, chunk), 1, warmup=1)
                cases["fused_dense_chunk_ext"].append({
                    **bound(dname, chunk_flops(chunk, cand, cut, n), 10 * rows_bytes),
                    "shape": label, "dtype": dname, "max_abs_err": max(e[0] for e in errs),
                    "rel_err": worst, "ms": ms, "plain_ms": plain_ms})
    for name, cs in cases.items():
        per = "per call" if name == "pair_sweep_tri" else f"per {chunk}-step chunk"
        for c in cs:
            log(f"kernel {name} {c['shape']} {c['dtype']}: rel err {c['rel_err']:.3e} "
                f"(tol {KERNEL_TOL[c['dtype']]:.0e}), {c['ms']:.4f} ms vs plain "
                f"{c['plain_ms']:.4f} ms {per}")
    for c in pair_terms_report:
        log(f"kernel lj_pair_terms (device function, element-wise check) {c['shape']} box "
            f"{c['dtype']}: rel err {c['rel_err']:.3e}, bit-identical to twin: "
            f"{c['bit_identical']}, {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms per 65536 pairs")
    cases["lj_pair_terms"] = pair_terms_report
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


def sorted_fluid(cfg, n_pad, seed, torch, dtype, device):
    """Seeded perturbed FCC lattice of ``cfg`` in ascending-z column order,
    as (8, n_pad) rows, with velocities and consistent accelerations (the
    layout the zsort engine hands its kernels)."""
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
        out = torch.zeros((8, n_pad), dtype=dtype, device=device)
        out[0:3, :n] = torch.as_tensor(x[order].T, dtype=dtype, device=device)
        return out

    r8 = rows(r)
    return n, r8, rows(v), 24.0 * pair_forces_plain(r8, n, L, cfg.rc_square)


def _same_lists(got, want) -> bool:
    """Equal counts, and equal entries on every list's count prefix (the
    kernel leaves entries past the counts unwritten)."""
    (gt, gc), (wt, wc) = got, want
    if not bool((gc.cpu() == wc.cpu()).all()):
        return False
    gt, wt = gt.cpu(), wt.cpu()
    for c, k in enumerate(wc.tolist()):
        rows = ([2 * c, 2 * c + 1] + ([8] if c == 3 else [])) if c < 4 else \
            [9 + 2 * (c - 4), 10 + 2 * (c - 4)]
        if not bool((gt[rows, :k] == wt[rows, :k]).all()):
            return False
    return True


def phase_list_kernels(torch) -> dict:
    """Kernels 9 and 10 (the zsort path) against their twins, at the zsort
    engine's geometry for the N=4000 and N=864 configs."""
    import numpy as np

    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import zsort_geometry
    from ljmd_tpu_torch.ops import fused_list, window_lists
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    k = LIST_CHUNK_STEPS
    cases = {"build_window_lists": [], "fused_dense_chunk_list": []}
    for label, name in ZSORT_SHAPES:
        cfg = load_config(str(REPO / "examples" / name))
        geo = zsort_geometry(cfg, inner_chunk=k)
        L, n_pad, tj = cfg.box_length, geo.n_pad, geo.tile_j
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            tol = KERNEL_TOL[dname]
            n, r, v, a = sorted_fluid(cfg, n_pad, 4321 + cfg.num_cells, torch, dtype, dev)
            cut = pairs_within(torch, r[0:3, :n].T, L, cfg.rc_square)
            rows_bytes = 8 * n_pad * r.element_size()

            # Kernel 9: the pack, on the fluid's flags and on random flags
            # (every category and every tail width), lists compared exactly.
            flags = window_lists.compute_tile_flags(r, n, 128, 128, L, geo.window,
                                                    cross_margin=0.6 * geo.sort_skin)
            n_b = n_pad // 128
            rand = torch.as_tensor(np.random.default_rng(n_b).integers(0, 8, n_b * n_b)
                                   .astype(np.int32), device=dev)
            for fname, f in (("fluid", flags), ("random", rand)):
                got = window_lists.build_window_lists(f, n, n_pad, 128, tj)
                want = window_lists.build_window_lists_plain(f, n, n_pad, 128, tj)
                require(_same_lists(got, want),
                        f"build_window_lists {label} {dname} {fname} flags: lists differ from the twin")
            tiles, tcounts = window_lists.build_window_lists(flags, n, n_pad, 128, tj)
            ms = cuda_time_ms(torch, lambda: window_lists.build_window_lists(flags, n, n_pad, 128, tj), 50)
            plain_ms = cuda_time_ms(torch, lambda: window_lists.build_window_lists_plain(
                flags, n, n_pad, 128, tj), 3, warmup=1)
            # Integer work, one operation per flag, counted at the float32 rate.
            list_bytes = 4 * (flags.numel() + tiles.numel() + tcounts.numel())
            cases["build_window_lists"].append({
                **bound("float32", flags.numel(), list_bytes),
                "shape": label, "dtype": dname, "max_abs_err": 0.0, "rel_err": 0.0,
                "lists_equal": True, "tcounts": tcounts.tolist(), "ms": ms, "plain_ms": plain_ms})

            # Kernel 10: the fused list chunk, plain / obs_last / extended.
            args = (tiles, tcounts, n, L, cfg.rc_square, cfg.dt, k)
            errs = []
            for mode in ("plain", "obs_last", "extended"):
                kw = {"tile_j": tj}
                if mode == "obs_last":
                    kw["obs_last"] = True
                if mode == "extended":
                    kw.update(r_lo=torch.zeros_like(r), vc=torch.zeros_like(r))
                got = fused_list.fused_dense_chunk_list(r, v, a, *args, **kw)
                want = fused_list.fused_dense_chunk_list_plain(r, v, a, *args, **kw)
                if mode == "extended":
                    got = (got[0].double() + got[1].double(), got[2].double() + got[3].double(), got[4])
                    want = (want[0].double() + want[1].double(), want[2].double() + want[3].double(), want[4])
                e = [rel_err(g, w) for g, w in zip(got, want)]
                worst = max(x[1] for x in e)
                require(worst <= tol, f"fused_dense_chunk_list {label} {dname} {mode}: "
                                      f"rel err {worst:.3e} > {tol}")
                errs.append({"mode": mode, "max_abs_err": max(x[0] for x in e), "rel_err": worst})
            ms = cuda_time_ms(torch, lambda: fused_list.fused_dense_chunk_list(
                r, v, a, *args, tile_j=tj), 10)
            plain_ms = cuda_time_ms(torch, lambda: fused_list.fused_dense_chunk_list_plain(
                r, v, a, *args, tile_j=tj), 1, warmup=1)
            cover = fused_list.list_coverage(tiles, tcounts, n, n_pad, 128, tj)[0]
            cand = int(cover[:n, :n].sum())
            cases["fused_dense_chunk_list"].append({
                **bound(dname, chunk_flops(k, cand, cut, n), 6 * rows_bytes),
                "candidates": cand, "cut_pairs": cut,
                "shape": label, "dtype": dname, "max_abs_err": max(x["max_abs_err"] for x in errs),
                "rel_err": max(x["rel_err"] for x in errs), "modes": errs,
                "visits": tcounts.tolist(), "ms": ms, "plain_ms": plain_ms})
    for c in cases["build_window_lists"]:
        log(f"kernel build_window_lists {c['shape']} {c['dtype']}: lists equal to the twin's "
            f"(fluid and random flags), tcounts {c['tcounts']}, {c['ms']:.4f} ms vs plain "
            f"{c['plain_ms']:.4f} ms per call")
    for c in cases["fused_dense_chunk_list"]:
        modes = ", ".join(f"{m['mode']} {m['rel_err']:.3e}" for m in c["modes"])
        log(f"kernel fused_dense_chunk_list {c['shape']} {c['dtype']}: rel err {modes} "
            f"(tol {KERNEL_TOL[c['dtype']]:.0e}), {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms "
            f"per {k}-step chunk")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


def pencil_candidates(counts, tbl) -> int:
    """Pair-once candidates of the half-shell pair set among valid slots:
    each pencil with itself and with its 4 upper neighbours."""
    c = counts.long().cpu()
    return int((c * (c - 1) // 2).sum() + (c[:, None] * c[tbl.long().cpu().reshape(-1, 4)]).sum())


def phase_pencil_kernels(torch, cfg, state) -> dict:
    """Kernels 13+14, 15 and 16 (the cell-pair path) against their twins at
    config 5's geometry, from ``state`` (an N=62500 fluid), at each of
    PENCIL_CAPS, float32 and float64. Compared on the valid slots (empty
    slots hold sentinels); extended outputs as r + r_lo and v + vc."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops import cell_list, fused_pencil, pencil_sweep
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    L, rc2, dt = cfg.box_length, cfg.rc_square, cfg.dt
    k_check, k_time = PENCIL_CHECK_STEPS, PENCIL_CHUNK_STEPS
    cut = pairs_within(torch, state.r, L, rc2)
    n = cfg.n
    cases = {name: [] for name in PENCIL_KERNELS}
    log(f"pencil kernels: tolerances as above; a slot's force sums at most 9 x capacity "
        f"= 4608 terms; N={n}, {cut} pairs inside the cutoff")
    for cap in PENCIL_CAPS:
        grid = cell_list.make_pencil_grid(n, L, cfg.rc + cfg.neighbor_skin, cfg.density, cap)
        P, label = grid.n_pencils, f"N={n} cap={cap}"
        tbl, shf = (torch.as_tensor(t, device=dev)
                    for t in pencil_sweep.build_half_shell_tables(grid))
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            tol = KERNEL_TOL[dname]
            eng = pe._cellpair_engine(cfg.replace(neighbor_capacity=cap, dtype=dname), dev,
                                      compensated=False, width_lists=True)
            c, _ = eng.init(state.to(dtype=dtype))
            require(not bool(c.overflow), f"pencil kernels {label}: the fluid overflows")
            valid = c.r[3] > 0.5
            cand = pencil_candidates(c.counts, tbl)
            size = c.r.element_size()
            slots_bytes = 8 * grid.n_slots * size  # one (8, n_slots) array
            table_bytes = 4 * (tbl.numel() + shf.numel() + c.counts.numel())
            list_bytes = 4 * sum(t.numel() for t in (c.wl_self, c.wl_self_cnt, c.wl_nbr_i,
                                                     c.wl_nbr_j, c.wl_nbr_off))
            base = {"shape": label, "dtype": dname, "candidates": cand, "cut_pairs": cut,
                    "counts_max": int(c.counts.max())}

            # Kernels 13 + 14: the sweep, rows 0..5 on the valid slots.
            for want_obs in (True, False):
                args = (c.r, tbl, c.counts, shf, grid, rc2, want_obs)
                got = pencil_sweep.pencil_sweep_hs(*args)
                want = pencil_sweep.pencil_sweep_hs_plain(*args)
                require(bool((got[6:] == 0).all()) and bool((got[:, ~valid] == 0).all()),
                        f"pencil_sweep_hs {label} {dname}: rows 6-7 or empty slots not zero")
                errs = [rel_err(got[row, valid], want[row, valid]) for row in range(6)]
                worst = max(e[1] for e in errs)
                require(worst <= tol, f"pencil_sweep_hs {label} {dname} obs={want_obs}: "
                                      f"rel err {worst:.3e} > {tol}")
                cases["pencil_sweep_hs"].append({
                    **base, **bound(dname, sweep_flops(cand, cut, want_obs),
                                    2 * slots_bytes + table_bytes),
                    "observables": want_obs, "max_abs_err": max(e[0] for e in errs),
                    "rel_err": worst,
                    "ms": cuda_time_ms(torch, lambda: pencil_sweep.pencil_sweep_hs(*args), 20),
                    "plain_ms": cuda_time_ms(torch, lambda: pencil_sweep.pencil_sweep_hs_plain(
                        *args), 2, warmup=1)})

            # Kernels 15 and 16: the fused chunks, plain and extended.
            lists = (c.wl_self, c.wl_self_cnt, c.wl_nbr_i, c.wl_nbr_j, c.wl_nbr_off)
            for name, kernel, plain, tabs, extra in (
                    ("fused_pencil_chunk", fused_pencil.fused_pencil_chunk,
                     fused_pencil.fused_pencil_chunk_plain, (tbl, shf), table_bytes),
                    ("fused_pencil_width_chunk", fused_pencil.fused_pencil_width_chunk,
                     fused_pencil.fused_pencil_width_chunk_plain, lists, list_bytes)):
                errs = []
                for mode in ("plain", "extended"):
                    kw = ({"r_lo": torch.zeros_like(c.r), "vc": torch.zeros_like(c.r)}
                          if mode == "extended" else {})
                    args = (c.r, c.v, c.a, *tabs, P, cap, L, rc2, dt, k_check)
                    got, want = kernel(*args, **kw), plain(*args, **kw)
                    if mode == "extended":
                        got = (got[0].double() + got[1].double(),
                               got[2].double() + got[3].double(), got[4])
                        want = (want[0].double() + want[1].double(),
                                want[2].double() + want[3].double(), want[4])
                    require(bool(torch.equal(got[0][:, ~valid], c.r[:, ~valid].to(got[0].dtype))),
                            f"{name} {label} {dname} {mode}: a sentinel moved")
                    e = [rel_err(g[0:3, valid], w[0:3, valid]) for g, w in zip(got, want)]
                    worst = max(x[1] for x in e)
                    require(worst <= tol, f"{name} {label} {dname} {mode}: rel err "
                                          f"{worst:.3e} > {tol}")
                    errs.append({"mode": mode, "max_abs_err": max(x[0] for x in e),
                                 "rel_err": worst})
                targs = (c.r, c.v, c.a, *tabs, P, cap, L, rc2, dt, k_time)
                cases[name].append({
                    **base, **bound(dname, chunk_flops(k_time, cand, cut, n),
                                    6 * slots_bytes + extra),
                    "max_abs_err": max(x["max_abs_err"] for x in errs),
                    "rel_err": max(x["rel_err"] for x in errs), "modes": errs,
                    "ms": cuda_time_ms(torch, lambda: kernel(*targs), 10),
                    "plain_ms": cuda_time_ms(torch, lambda: plain(*targs), 1, warmup=1)})
    for name, cs in cases.items():
        per = "per call" if name == "pencil_sweep_hs" else f"per {k_time}-step chunk"
        for c in cs:
            what = (f"observables {c['observables']}" if name == "pencil_sweep_hs" else
                    ", ".join(f"{m['mode']} {m['rel_err']:.3e}" for m in c["modes"]))
            log(f"kernel {name} {c['shape']} {c['dtype']} (max count {c['counts_max']}): "
                f"{what}, rel err {c['rel_err']:.3e} (tol {KERNEL_TOL[c['dtype']]:.0e}), "
                f"{c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms {per}; bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {c['candidates']} candidates)")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


# ---------------------------------------------------------------- phase 4
def _drift(etot) -> float:
    import numpy as np

    e = np.asarray(etot, dtype=np.float64)
    return float(abs(e[-1] - e[0]) / abs(e[0]))


def _check_artifacts(out_dir: str, with_frames: bool) -> None:
    names = ["instantaneous_energies.dat", "md_final_results.txt", "means.dat", "summary.json"]
    names += [f"{p}_{o}.dat" for p in ("corr", "corrmean")
              for o in ("epot", "ekin", "etot", "temp", "press")]
    if with_frames:
        names.append("rva.dat")
    for f in names:
        p = os.path.join(out_dir, f)
        require(os.path.isfile(p) and os.path.getsize(p) > 0, f"artifact missing or empty: {p}")
    with open(os.path.join(out_dir, "summary.json")) as f:
        summary = json.load(f)
    vals = [m["mean"] for m in summary["means"].values()] + [m["std"] for m in summary["means"].values()]
    vals += list(summary["thermodynamic_coefficients"].values())
    require(all(math.isfinite(x) for x in vals), f"non-finite means/thermo in {out_dir}/summary.json")


def _check_launches(run: str, counts: dict, needed: tuple, forbidden: tuple = ()) -> None:
    log(f"{run}: kernel launches {json.dumps(counts)}")
    for k in needed:
        require(counts.get(k, 0) > 0, f"{run}: kernel {k} was not launched on the main path")
    for k in forbidden:
        require(counts.get(k, 0) == 0, f"{run}: kernel {k} launched on another engine's path")


MAIN_KERNELS = (("pair_sweep_tri", "fused_dense_chunk", "fused_dense_chunk_ext") + ZSORT_KERNELS
                + PENCIL_KERNELS)


def _cli_run(name: str, cfg, backend: str, tmp: str, needed: tuple, forbidden: tuple) -> dict:
    """One ``python -m ljmd_tpu_torch simulate`` run on the card; the counts
    are the CLI process's own (it starts at 0 and prints them at the end)."""
    import numpy as np

    cut = {k: getattr(cfg, k) for k in ("num_cells", "total_steps", "output_interval",
                                         "warmup_steps", "dt", "box_length", "rc_over_box",
                                         "target_total_energy", "dtype", "seed",
                                         "compensated_sum", "neighbor_skin",
                                         "neighbor_capacity")}
    cfg_path = os.path.join(tmp, f"{name}.json")
    with open(cfg_path, "w") as f:
        json.dump(cut, f)
    out_dir = os.path.join(tmp, name)
    cmd = [sys.executable, "-m", "ljmd_tpu_torch", "simulate", "--config", cfg_path,
           "--out-dir", out_dir, "--device", DEVICE, "--backend", backend]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=str(REPO), capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    for line in proc.stdout.strip().splitlines():
        log(f"  cli| {line}")
    require(proc.returncode == 0, f"{name}: CLI run failed ({proc.returncode}):\n{proc.stderr}")
    counts = diagnostics = rate = None
    for line in proc.stdout.splitlines():
        if line.startswith('{"kernel_launches"'):
            counts = json.loads(line)["kernel_launches"]
        elif line.startswith('{"diagnostics"'):
            diagnostics = json.loads(line)["diagnostics"]
        elif "particle-steps/s" in line:
            rate = float(line.split("(")[1].split(" particle-steps/s")[0])
    require(counts is not None and diagnostics is not None and rate is not None,
            f"{name}: CLI printed no kernel_launches / diagnostics / rate line")
    _check_launches(name, counts, needed, forbidden)
    require(not any(diagnostics.values()), f"{name}: diagnostic flag set: {diagnostics}")
    _check_artifacts(out_dir, with_frames=True)
    etot = np.loadtxt(os.path.join(out_dir, "instantaneous_energies.dat"))[:, 3]
    drift = _drift(etot)
    log(f"{name} (CLI, --backend {backend}): N={cfg.n} |dE/E| {drift:.3e} (bound "
        f"{DRIFT_BOUND[name]:.0e}), {len(etot)} samples, production {rate:.4e} particle-steps/s, "
        f"CLI wall {wall:.1f}s incl. startup, init and artifacts")
    require(drift < DRIFT_BOUND[name], f"{name}: energy drift over bound")
    return {"engine": backend, "n": cfg.n, "drift": drift, "wall_s": wall,
            "particle_steps_per_s": rate, "diagnostics": diagnostics, "launches": counts}


def _in_process_run(torch, name: str, cfg, backend: str, tmp: str, needed: tuple,
                    forbidden: tuple, prod_cfg=None) -> tuple[dict, object]:
    """initialize + run_production + artifacts in this process, the counts
    set to 0 just before and read just after. ``prod_cfg`` (default
    ``cfg``) is the production's config, e.g. with another capacity."""
    from ljmd_tpu_torch.io.artifacts import write_run_artifacts
    from ljmd_tpu_torch.models.engine import HOST_READS
    from ljmd_tpu_torch.models.simulation import initialize, run_production
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    prod_cfg = prod_cfg or cfg
    torch.cuda.synchronize()
    LAUNCHES.reset()
    HOST_READS.update(dict.fromkeys(HOST_READS, 0))
    t0 = time.time()
    state = initialize(cfg, backend=backend, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    res = run_production(prod_cfg, state, backend=backend, record_frames=True, device=dev)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = LAUNCHES.snapshot()
    host_reads = dict(HOST_READS)
    _check_launches(name, counts, needed, forbidden)
    diagnostics = {k: bool(v) for k, v in res.diagnostics.items()}
    require(not any(diagnostics.values()), f"{name}: diagnostic flag set: {diagnostics}")
    out_dir = os.path.join(tmp, name)
    write_run_artifacts(out_dir, prod_cfg, res, write_frames=True)
    _check_artifacts(out_dir, with_frames=True)
    require(bool(torch.isfinite(res.series).all()), f"{name}: non-finite series")
    drift = _drift(res.series[2].cpu())
    rate = cfg.n * cfg.total_steps / (t2 - t1)
    warm_rate = cfg.n * cfg.warmup_steps / (t1 - t0)
    log(f"{name} (--backend {backend}): N={cfg.n} |dE/E| {drift:.3e} (bound "
        f"{DRIFT_BOUND[name]:.0e}), production {t2 - t1:.3f}s = {rate:.4e} particle-steps/s, "
        f"initialize (warmup {cfg.warmup_steps}) {t1 - t0:.3f}s = {warm_rate:.4e} particle-steps/s"
        f"; host reads {json.dumps(host_reads)}")
    require(drift < DRIFT_BOUND[name], f"{name}: energy drift over bound")
    return ({"engine": backend, "n": cfg.n, "drift": drift, "production_s": t2 - t1,
             "particle_steps_per_s": rate, "init_s": t1 - t0, "diagnostics": diagnostics,
             "launches": counts, "host_reads": host_reads}, res.final_state)


def phase_main_path(torch, tmp: str) -> tuple[dict, object, object]:
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import auto_backend

    log("energy bounds |E_last - E_first| / |E_first|: 1e-3 per run, 12-16x the drift of "
        "CPU float64 runs of the same cut configs (6.3e-5 reference default, 8.3e-5 N=4000)")
    ref = load_config(str(REPO / "examples" / "reference_default.json")).replace(**REF_CUT)
    n4000 = load_config(str(REPO / "examples" / "n4000_production.json")).replace(**N4000_CUT)
    n864 = load_config(str(REPO / "examples" / "n864_liquid.json")).replace(**N864_CUT)
    for cfg, want in ((ref, "rows"), (n4000, "zsort"), (n864, "zsort")):
        got = auto_backend(cfg, True, cfg.output_interval)
        require(got == want, f"auto routes N={cfg.n} to {got}, expected {want}")
    log("auto on the card: reference default -> rows (L < 4 rc), N=4000 -> zsort, "
        "N=864 -> zsort (the JAX package's accelerator routing)")
    rows_k = ("pair_sweep_tri", "fused_dense_chunk")
    zsort_k = ZSORT_KERNELS
    no_dense = ("fused_dense_chunk", "fused_dense_chunk_ext") + PENCIL_KERNELS
    no_list = ZSORT_KERNELS + PENCIL_KERNELS
    runs = {}
    runs["reference_default_f64"] = _cli_run("reference_default_f64", ref, "rows", tmp, rows_k, no_list)
    runs["reference_default_f32"], _ = _in_process_run(
        torch, "reference_default_f32", ref.replace(dtype="float32"), "rows", tmp,
        ("pair_sweep_tri", "fused_dense_chunk_ext"), no_list)
    runs["n4000_f32"], _ = _in_process_run(torch, "n4000_f32", n4000, "rows", tmp, rows_k, no_list)
    runs["n4000_f32_zsort"] = _cli_run("n4000_f32_zsort", n4000, "auto", tmp, zsort_k, no_dense)
    runs["n864_f32_zsort"], _ = _in_process_run(torch, "n864_f32_zsort", n864, "auto", tmp,
                                                zsort_k, no_dense)
    runs["n864_f32"], _ = _in_process_run(torch, "n864_f32", n864, "rows", tmp, rows_k, no_list)
    comp = n4000.replace(compensated_sum=True)
    runs["n4000_f32_compensated_zsort"], final = _in_process_run(
        torch, "n4000_f32_compensated_zsort", comp, "auto", tmp, zsort_k, no_dense)
    return runs, comp, final


def phase_cellpair_path(torch, tmp: str) -> tuple[dict, object, object]:
    """The cell-pair slice end to end on config 5 cut (N62500_CUT): the CLI
    with ``--backend auto`` (production at the census capacity, 384: the
    static chunk), then in process with production at capacity 512 (the
    width-listed chunk), and compensated. Returns the runs, the cut config
    and the final states of the capacity-512 and the compensated runs."""
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import auto_backend

    cfg = load_config(str(REPO / "examples" / "n62500_large.json")).replace(**N62500_CUT)
    got = auto_backend(cfg, True, cfg.output_interval)
    require(got == "cellpair", f"auto routes N={cfg.n} to {got}, expected cellpair")
    log(f"auto on the card: N={cfg.n} (config 5) -> cellpair")
    others = ("pair_sweep_tri", "fused_dense_chunk", "fused_dense_chunk_ext") + ZSORT_KERNELS
    sweep_static = ("pencil_sweep_hs", "fused_pencil_chunk")
    sweep_width = ("pencil_sweep_hs", "fused_pencil_width_chunk")
    runs = {"n62500_f32_cellpair": _cli_run("n62500_f32_cellpair", cfg, "auto", tmp,
                                            sweep_static, others)}
    runs["n62500_f32_cap512_cellpair"], final = _in_process_run(
        torch, "n62500_f32_cap512_cellpair", cfg, "auto", tmp, sweep_width, others,
        prod_cfg=cfg.replace(neighbor_capacity=512))
    runs["n62500_f32_compensated_cellpair"], final_comp = _in_process_run(
        torch, "n62500_f32_compensated_cellpair", cfg.replace(compensated_sum=True), "auto",
        tmp, sweep_static, others)
    return runs, cfg, {"cap512_end": final, "compensated_end": final_comp}


# ---------------------------------------------------------------- phase 5
def _planted_tables(build):
    """``build_half_shell_tables`` with a planted fault: the first upper
    neighbours of pencil 0 and of the pencil half a box away trade places.
    Each column stays a bijection (every lower neighbour stays defined), the
    traded partners lie beyond the cutoff, so the two true neighbour-pencil
    pairs are missed and nothing else changes."""
    def planted(grid):
        tbl, shf = build(grid)
        tbl = tbl.copy()
        far = (grid.m_xy // 2) * grid.m_xy + grid.m_xy // 2
        tbl[0], tbl[4 * far] = tbl[4 * far], tbl[0]
        return tbl, shf
    return planted


def _state_diff(torch, s, ref, L) -> dict:
    d = s.r.double() - ref.r.double()
    d = d - L * torch.round(d / L)  # a particle on a face may wrap on either side
    errs = {"r": float(d.abs().max()) / max(1.0, float(ref.r.abs().max()))}
    for k in ("v", "a"):
        errs[k] = rel_err(getattr(s, k), getattr(ref, k))[1]
    # A run that blew up differs without bound (and max() over a NaN is
    # order-dependent).
    return {k: e if math.isfinite(e) else math.inf for k, e in errs.items()}


def phase_chunk_paths(torch, cfg, states: dict) -> dict:
    """The cell-pair engine's three chunk paths (fused static, fused width,
    unfused), PATHS_STEPS steps each from each of ``states`` (N=62500), in
    float32 and float64, at the lattice capacity 512 (where the width lists
    skip a block of most pencils) and at the state's census capacity; each
    timed on its second run (host clock after a synchronize). Each path must
    stay within PATHS_TOL of fused static in r (minimum image), v and a, and
    fused static over planted faulty tables (``_planted_tables``) must not.
    Returns {"<state>, cap=..., dtype": {path: ...}}."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops.cell_list import capacity_from_state
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    L = cfg.box_length
    # The unfused path at the fused chunks' 8 steps between rebins; at its
    # own default of 12 the fastest particles of this fluid may outrun the
    # coverage slack (0.25 in xy) between two rebins, which the engine flags
    # (as the JAX engine does): that run is timed and its flag recorded,
    # but it is not compared.
    paths = {"fused_static": {"width_lists": False}, "fused_width": {"width_lists": True},
             "unfused": {"use_fused": False, "inner_chunk": 8},
             "unfused_chunk12": {"use_fused": False}}
    out = {}
    for sname, state in states.items():
        census = capacity_from_state(L, cfg.rc + cfg.neighbor_skin, state.r)
        for cap in sorted({PENCIL_CAPS[0], census}, reverse=True):
            for dname in ("float32", "float64"):
                tol = PATHS_TOL[dname]
                run_cfg = cfg.replace(neighbor_capacity=cap, dtype=dname)
                start = state.to(dtype=getattr(torch, dname))
                ends, report = {}, {}
                for name, kw in paths.items():
                    eng = pe._cellpair_engine(run_cfg, dev, **kw)
                    walls = []
                    for _ in range(2):
                        c0, _ = eng.init(start)
                        torch.cuda.synchronize()
                        LAUNCHES.reset()
                        pe.HOST_READS.update(dict.fromkeys(pe.HOST_READS, 0))
                        t0 = time.time()
                        c = eng.run_fast(c0, PATHS_STEPS)
                        torch.cuda.synchronize()
                        walls.append(time.time() - t0)
                    flagged = bool(c.overflow)
                    require(name == "unfused_chunk12" or not flagged,
                            f"chunk paths {sname} cap {cap} {dname}: {name} set pencil_overflow")
                    ends[name] = eng.get_state(c)
                    report[name] = {"ms_per_step": 1e3 * walls[-1] / PATHS_STEPS,
                                    "pencil_overflow": flagged,
                                    "launches": {k: v for k, v in LAUNCHES.snapshot().items()
                                                 if v},
                                    "host_reads": dict(pe.HOST_READS)}
                ref = ends["fused_static"]
                for name in ("fused_width", "unfused"):
                    errs = _state_diff(torch, ends[name], ref, L)
                    report[name]["rel_diff_to_fused_static"] = errs
                    require(max(errs.values()) <= tol,
                            f"chunk paths {sname} cap {cap} {dname}: {name} differs from "
                            f"fused_static by {errs} > {tol}")
                build = pe.build_half_shell_tables
                pe.build_half_shell_tables = _planted_tables(build)
                try:
                    eng = pe._cellpair_engine(run_cfg, dev, width_lists=False)
                finally:
                    pe.build_half_shell_tables = build
                errs = _state_diff(torch, eng.get_state(eng.run_fast(eng.init(start)[0],
                                                                     PATHS_STEPS)), ref, L)
                report["planted_fault"] = {"rel_diff_to_fused_static": errs}
                require(max(errs.values()) > tol,
                        f"chunk paths {sname} cap {cap} {dname}: the planted fault stays within "
                        f"{tol} ({errs}): the check cannot see a missed neighbour pencil")
                LAUNCHES.reset()
                log(f"cellpair chunk paths ({sname}, N={cfg.n}, {dname}, capacity {cap}"
                    f"{' = census' if cap == census else ''}, {PATHS_STEPS} steps, "
                    f"tol {tol:.0e}): {json.dumps(report)}")
                out[f"{sname}, cap={cap}, {dname}"] = report
    return out


# ---------------------------------------------------------------- phase 6
def phase_rows_at_62500(torch, cfg, state) -> dict:
    """Whether the rows engine runs config 5 at all: its init (the tri
    sweep) and one fused chunk of PENCIL_CHUNK_STEPS, whose wrapper refuses
    a grid that cannot be co-resident."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    eng = pe.make_engine(cfg, "rows", dev)
    torch.cuda.synchronize()
    t0 = time.time()
    c, _ = eng.init(state)
    torch.cuda.synchronize()
    out = {"init_sweep_s": time.time() - t0}
    try:
        t0 = time.time()
        eng.run_fast(c, PENCIL_CHUNK_STEPS)
        torch.cuda.synchronize()
        out["fused_chunk"] = f"ran, {1e3 * (time.time() - t0) / PENCIL_CHUNK_STEPS:.3f} ms/step"
    except RuntimeError as err:
        out["fused_chunk"] = f"refused: {err}"
    LAUNCHES.reset()
    log(f"rows at N={cfg.n} float32: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- phase 7
def phase_engines_vs_rows(torch, cfg, state) -> dict:
    """One float64 state (the N=4000 compensated zsort run's final fluid),
    32 fused steps on each engine: rows in one dense chunk, zsort in two
    list chunks with a resort before each, cellpair in four pencil chunks
    with a rebin before each."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    cfg = cfg.replace(dtype="float64", compensated_sum=False)
    state = state.to(device=dev, dtype=torch.float64)
    rows = pe.make_engine(cfg, "rows", dev)
    s_rows = rows.get_state(rows.run_fast(rows.init(state)[0], VS_ROWS_STEPS))
    L = cfg.box_length
    out = {}
    for name in ("zsort", "cellpair"):
        eng = pe.make_engine(cfg, name, dev, state=state)
        c = eng.run_fast(eng.init(state)[0], VS_ROWS_STEPS)
        flags = {k: bool(v) for k, v in eng.diagnostics(c).items()}
        require(not any(flags.values()), f"{name} vs rows: {flags}")
        s = eng.get_state(c)
        d = s.r.double() - s_rows.r.double()
        d = d - L * torch.round(d / L)  # a particle on a face may wrap on either side
        worst = float(d.abs().max()) / max(1.0, float(s_rows.r.abs().max()))
        for k in ("ru", "v", "a"):
            worst = max(worst, rel_err(getattr(s, k), getattr(s_rows, k))[1])
        out[name] = worst
        log(f"{name} vs rows on the card (N={cfg.n}, float64, {VS_ROWS_STEPS} fused "
            f"steps, {'2 resorts' if name == 'zsort' else '4 rebins'}): max rel diff over "
            f"r, ru, v, a {worst:.3e} (tol {VS_ROWS_TOL:.0e})")
        require(worst <= VS_ROWS_TOL, f"{name} and rows disagree")
    LAUNCHES.reset()
    return out


# ---------------------------------------------------------------- phase 8
def phase_card_vs_cpu(torch) -> float:
    import numpy as np

    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.simulation import initialize, run_production

    cfg = load_config(str(REPO / "examples" / "n256_rho0.8.json"))
    cfg = cfg.replace(**CARD_VS_CPU_CUT)
    state = initialize(cfg.replace(warmup_steps=100), device="cpu")
    cpu = run_production(cfg, state, backend="rows", device="cpu")
    gpu = run_production(cfg, state.to(device=DEVICE), backend="rows", device=DEVICE)
    s_cpu = cpu.series.numpy()
    s_gpu = gpu.series.cpu().numpy()
    worst = 0.0
    for row in range(s_cpu.shape[0]):
        scale = float(np.abs(s_cpu[row]).max())
        worst = max(worst, float(np.abs(s_gpu[row] - s_cpu[row]).max()) / scale)
    log(f"card vs CPU (N={cfg.n}, {cfg.total_steps} steps, f64): series rel diff {worst:.3e} "
        f"(tol {SERIES_RTOL:.0e})")
    require(worst <= SERIES_RTOL, "card and CPU series disagree")
    return worst


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card",
              file=sys.stderr)
        return 1
    if not (REPO / "ljmd_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no ljmd_tpu_torch package beside {__file__}; run it from a checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    env = phase_environment(torch)
    phase_build()
    cases = phase_kernels(torch)
    cases.update(phase_list_kernels(torch))
    with tempfile.TemporaryDirectory(prefix="ljmd_chip_smoke_") as tmp:
        runs, final_cfg, final_state = phase_main_path(torch, tmp)
        cp_runs, cfg5, states5 = phase_cellpair_path(torch, tmp)
    runs.update(cp_runs)
    state5 = states5["cap512_end"]
    # A third stretch of the fluid: the capacity-512 run's end with the
    # velocities reversed (it retraces the stretch before it).
    states5["cap512_end_reversed"] = dataclasses.replace(state5, v=-state5.v)
    cases.update(phase_pencil_kernels(torch, cfg5, state5))
    paths = phase_chunk_paths(torch, cfg5, states5)
    rows_question = phase_rows_at_62500(torch, cfg5, state5)
    vs_rows = phase_engines_vs_rows(torch, final_cfg, final_state)
    series_err = phase_card_vs_cpu(torch)

    # Headline shape per kernel: where the main path runs it at full size;
    # every case is listed beside it.
    headline = {"lj_pair_terms": ("N=4000", "float32"),
                "pair_sweep_tri": ("N=4000", "float32"),
                "fused_dense_chunk": ("N=4000", "float32"),
                "fused_dense_chunk_ext": ("N=500", "float32"),
                "build_window_lists": ("N=4000", "float32"),
                "fused_dense_chunk_list": ("N=4000", "float32"),
                "pencil_sweep_hs": ("N=62500 cap=512", "float32"),
                "fused_pencil_chunk": ("N=62500 cap=384", "float32"),
                "fused_pencil_width_chunk": ("N=62500 cap=512", "float32")}
    meta = {
        "lj_pair_terms": ("ljmd_tpu_torch/csrc/lj_pair_terms.cuh", "ljmd_tpu/ops/pallas_common.py:17"),
        "pair_sweep_tri": ("ljmd_tpu_torch/csrc/pair_sweep_tri.cu", "ljmd_tpu/ops/pallas_lj.py:240"),
        "fused_dense_chunk": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:537"),
        "fused_dense_chunk_ext": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:465"),
        "build_window_lists": ("ljmd_tpu_torch/csrc/pack_window_lists.cu", "ljmd_tpu/ops/pallas_fused.py:803"),
        "fused_dense_chunk_list": ("ljmd_tpu_torch/csrc/fused_dense_chunk_list.cu", "ljmd_tpu/ops/pallas_fused.py:1383"),
        "pencil_sweep_hs": ("ljmd_tpu_torch/csrc/pencil_sweep_hs.cu", "ljmd_tpu/ops/pallas_pencil2.py:187"),
        "fused_pencil_chunk": ("ljmd_tpu_torch/csrc/fused_pencil_chunk.cu", "ljmd_tpu/ops/pallas_pencil_fused.py:277"),
        "fused_pencil_width_chunk": ("ljmd_tpu_torch/csrc/fused_pencil_chunk.cu", "ljmd_tpu/ops/pallas_pencil_fused.py:609"),
    }
    launches = dict.fromkeys(MAIN_KERNELS, 0)
    for run in runs.values():
        for k in launches:
            launches[k] += run["launches"].get(k, 0)
    # lj_pair_terms is a __device__ function with no launch of its own on the
    # main path: it runs inside every sweep and chunk launch, so its count is
    # theirs (its own element-wise kernel runs only in the comparison).
    launches["lj_pair_terms"] = sum(launches[k] for k in MAIN_KERNELS if k != "build_window_lists")
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was launched no time on the main path")
    kernels = []
    for name, (source, replaces) in meta.items():
        head = next(c for c in cases[name] if (c["shape"], c["dtype"]) == headline[name])
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # No single PyTorch call computes a cut-off LJ sweep, a fused
            # Verlet chunk or a greedy visit-list cover.
            "library_ms": None,
            "timed_at": f"{head['shape']} {head['dtype']}", "cases": cases[name],
        }
        if name == "lj_pair_terms":
            entry["launches_counted_as"] = "launches of the kernels that inline it"
        if name == "pencil_sweep_hs":
            entry["also_replaces"] = "ljmd_tpu/ops/pallas_pencil2.py:394"
        kernels.append(entry)
    log(f"main path runs: {json.dumps(runs)}")
    for n_label, rows_run, zsort_run in (("N=4000", "n4000_f32", "n4000_f32_zsort"),
                                         ("N=864", "n864_f32", "n864_f32_zsort")):
        r_rate = runs[rows_run]["particle_steps_per_s"]
        z_rate = runs[zsort_run]["particle_steps_per_s"]
        log(f"production {n_label} float32 on {env['nvidia_smi']}: zsort {z_rate:.4e} "
            f"particle-steps/s, rows {r_rate:.4e} (zsort / rows {z_rate / r_rate:.3f})")
    for name in cp_runs:
        log(f"production N=62500 on {env['nvidia_smi']}: {name} "
            f"{runs[name]['particle_steps_per_s']:.4e} particle-steps/s")
    log(f"card {env['nvidia_smi']}; zsort-vs-rows rel diff {vs_rows['zsort']:.3e}; "
        f"cellpair-vs-rows rel diff {vs_rows['cellpair']:.3e}; chunk paths "
        + ", ".join(f"{k} width {max(p['fused_width']['rel_diff_to_fused_static'].values()):.3e}"
                    f" unfused {max(p['unfused']['rel_diff_to_fused_static'].values()):.3e}"
                    f" planted {max(p['planted_fault']['rel_diff_to_fused_static'].values()):.3e}"
                    for k, p in paths.items())
        + f"; rows at N=62500: "
        f"{rows_question['fused_chunk']}; card-vs-CPU series rel diff {series_err:.3e}")
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
