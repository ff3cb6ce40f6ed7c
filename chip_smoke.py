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
      pencil chunk and the width-listed chunk, each plain and extended; the
      full 9-neighbour sweep with and without observables; at capacity 512
      the z-banded sweep (window 384), against its twin and against the full
      sweep;
   d. (in a.) the ordered N x N sweep at N=500 (n < n_pad) and N=4000, with
      and without observables, and the (N, 3) force API around it; the
      dense chunk (and in b. the list chunk) with its persistent grid capped
      at 4 tiles a block, bit-equal to the full grid;
   e. the flag-gated dense chunk (kernel 8) on the experiments' melted
      N=4000 fluid, float32 and float64, plain and extended: the fluid's
      flags at tile_j 512 ... 4096, and all-zero, all-3 (bit-equal to the
      unflagged chunk) and random 0/1 flags at 512;
   f. the nine layout probes (kernel 17) at N=4096, 200 iterations, beside
      200 calls of the library operation each stands for;
   g. the pair-tile layout bodies (kernel 18) over 128 visits at N_PAD=4096
      in the experiment's box and in a box of L = 8 (where the forces move
      r past float32's resolution), and the transpose glue;
4. the main path, each production with the launch counts set to 0 just
   before and read just after (a CLI run counts its whole process):
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
   d. the flagship step (``ljmd_tpu_torch.entry.entry()``, N=4000 float32,
      the force API through the ordered sweep) for its 2,000 steps; then from
      one float64 state 100 steps against the rows engine, within 1e-9;
   e. the rows engine with ``triangular=False`` (the ordered sweep on sampled
      steps) on the N=4000 cut, and in float64 against ``triangular=True``:
      the series within 1e-9;
   f. the neighbor engine (``--backend neighbor``, plain torch, no kernel) on
      the N=4000 cut: rate, drift, overflow flag, host reads;
   g. the cell-pair engine's full 9-neighbour and z-banded sweeps
      (``half_shell=False``, ``z_band=True``) on the config-5 cut at capacity
      512 with ``inner_chunk=8``, from phase 4c's end; then from one float64
      state 100 steps of each against the half-shell engine, within 1e-9;
   h. the experiment entry points (``python -m ljmd_tpu_torch.experiments.
      overhead | zfloor | mosaic_support | layout``), each ``main`` once at
      full size (kernels 8, 13, 17 and 18);
   every run must launch its kernels and no other engine's, keep
   ``zsort_invalid`` / ``pencil_overflow`` / ``neighbor_overflow`` False
   and conserve energy within a stated bound; the production runs write
   every artifact and give finite means and thermo;
5. the three cell-pair chunk paths (fused static, fused width, unfused) from
   three N=62500 states, 100 steps each, at capacities 512 and the census:
   states within PATHS_TOL in float64 and float32; the unfused path at its
   default chunk (sized from the fluid's top speed) must not set
   ``pencil_overflow``, at JAX's 12 it is timed and its flag recorded; a planted
   fault (fused static over tables that miss two neighbour-pencil pairs)
   must exceed both limits;
6. rows at config 5 (N=62500, the dense chunk's persistent grid): float64,
   8 fused steps against the unfused cell-pair engine within 1e-9, and its
   float32 ms per step;
7. zsort and cellpair against rows on the card: one float64 N=4000 state,
   32 fused steps (resorts / rebins between chunks): within 1e-10;
8. the rows path on the card and on the CPU from one state (N=256, 200
   steps, float64): the sampled series must agree to 1e-8;
9. the multi-device slice (``ljmd_tpu_torch/parallel``) on thread meshes of
   ranks on the one card:
   a. (in 3) the rect sweeps (kernels 6, 7) against their twins at every
      shape the runs below give them: the half ring's for N=4000 over 4
      ranks (1000 a rank), the ring's over 2 (2000 a rank) and the
      compensated half ring's for N=500 over 2 (250 a rank): the self
      offset, a full hop, both sides of the gated half hop (whose two
      halves must add up to the full hop), observables on and off, float32
      and float64; and (in 3c) the half-shell sweep's ``n_pencils_i`` on
      config 5's 2-rank strips (7x14 pencils plus a 14-pencil halo);
   b. ``run_production`` through the particle-sharded engine: half ring on
      4 ranks and ring on 2 on the N=4000 cut, the compensated engine on
      the reference default in float32 (N=500, dt=1e-4) on 2 ranks, and the
      sharded pencil engine on config 5 on 2 strips at its default chunk;
      launch checks, drift, artifacts, ``pencil_overflow``; then each from
      one float64 state against the single-card engine it splits (rows; the
      unfused cell-pair engine), within 1e-9 over 100 steps; each dense
      sharded run's drift beside the rows engine's over the same cut from
      the same state, for two seeds; then ``dryrun_multichip(4)``;
   c. the rates of both sharded engines at 1, 2 and 4 ranks (the sharded
      pencil at 1, 2 and 7: 14 pencil columns do not split over 4) beside
      the single-card engines', their flags clear; the time of one
      thread-mesh hand-off at 1, 2 and 4 ranks and of one small launch.

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
    "flagship_entry_f32": 1e-3,
    "n4000_f32_rows_ordered": 1e-3,
    "n4000_f32_neighbor": 1e-3,
    "n62500_f32_cap512_full9": 1e-3,
    "n62500_f32_cap512_zband": 1e-3,
    "n4000_f32_half_ring_d4": 1e-3,
    "n4000_f32_ring_d2": 1e-3,
    "reference_default_f32_compensated_half_ring_d2": 1e-3,
    "n62500_f32_sharded_pencil_d2": 1e-3,
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
# Kernel 8's checks: zfloor's tile_j sweep, steps compared, steps timed.
FLAG_TILES = (512, 1024, 2048, 4096)
FLAG_CHECK_STEPS = 4
FLAG_CHUNK_STEPS = 8
# Kernel 18's checks: every body (k1 and k2 also at 128 columns), steps.
LAYOUT_ITEMS = ("k1-512", "k2b-512", "k2-512", "k3-512", "k4-512", "k4z-512", "k5a-512",
                "k5b-512", "k5c-512", "k6-512", "k1-128", "k2b-128", "k2-128")
LAYOUT_CHECK_STEPS = 2
LAYOUT_DISP_TOL = 5e-3
EXPERIMENT_KERNELS = ("fused_dense_chunk_flags", "mosaic_probes", "layout_bodies")
# Phase 6: rows on config 5 against the unfused cell-pair engine.
ROWS62500_STEPS = 8
# The dense and list chunks' persistent grid capped for the bit check: each
# block takes this many 32-particle tiles.
TILES_PER_BLOCK = 4
ZSORT_KERNELS = ("build_window_lists", "fused_dense_chunk_list")
# The flagship step's run (entry()'s own total_steps) and the float64 checks
# of PR 4's paths against the engines they duplicate.
FLAGSHIP_STEPS = 2_000
CROSS_STEPS = 100
CROSS_TOL = 1e-9
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
# The full sweeps' runs: config 5 at capacity 512 (the z-band's window 384 is
# live there; at 384 it would equal the capacity and fall back to the half
# shell), unfused chunks of 8 (the JAX default of 12 outruns the coverage
# slack at config 5, ROADMAP §3).
FULL_SWEEP_CAP = 512
FULL_SWEEP_CHUNK = 8
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
# The multi-device slice: the rect kernels at every shape the main path's
# sharded runs give them (RECT_SHAPES: shape label, SHAPES entry, ranks, the
# rect kernel's hops, the rect-Newton kernel's hops): the half ring on 4
# ranks at N=4000 (1000 a rank: a full hop and the gated half hop), the
# ring on 2 (2000 a rank), the compensated half ring on 2 at N=500 (250 a
# rank: the gated half hop alone); the strip sweep on STRIP_D strips of
# config 5; production cuts (intervals kept), from warmups by the
# single-card engines; the rates over RATE_STEPS fast steps (the sharded
# pencil over RATE_PENCIL_STEPS).
RECT_SHAPES = (
    ("N=4000 d=4", 1, 4, ("self", "hop"), ("self", "hop", "half")),
    ("N=4000 d=2", 1, 2, ("self", "hop"), ()),
    ("N=500 d=2", 0, 2, (), ("half",)),
)
STRIP_D = 2
RECT_KERNELS = ("pair_sweep_rect", "pair_sweep_rect_newton")
MULTI_N4000_CUT = {"total_steps": 2_000, "warmup_steps": 1_000}
MULTI_REF_CUT = {"total_steps": 2_000, "warmup_steps": 500, "dtype": "float32"}
MULTI_N62500_CUT = {"total_steps": 1_000, "warmup_steps": 500}
RATE_STEPS = 200
RATE_PENCIL_STEPS = 100
# Each sharded production's energy drift beside the drift of the
# single-card engine it splits, over the same cut from the same state, for
# the cut's seed and DRIFT_SEEDS - 1 more (each its own warmup): a drift the
# single-card engine shares belongs to the cut, not to the decomposition.
DRIFT_SEEDS = 2
# The limit on a sharded drift, as a multiple of the single-card engine's on
# that seed. float32 at dt = 0.005 (N=4000): the trajectories part within
# the cut, and the drifts of four engines on it spread from 0.10x to 1.56x
# the rows engine's over two seeds (on an H100 80GB HBM3 at 700 W); 3x flags
# a systematic loss, such as reactions summed in a lower precision.
# Compensated float32 at dt = 1e-4 (N=500): the trajectories stay together
# over the cut and the sharded drift matched rows' to 4e-4 of itself; 1.01x
# flags any loss.
DRIFT_VS_SINGLE = {"float32": 3.0, "compensated": 1.01}
# Thread-mesh hand-offs, timed as HANDOFF_REPS psums of one number on the
# card at each rank count of the rates, beside the host's time for one small
# launch: the host's share of a sharded step on this call's host.
HANDOFF_REPS = 500

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
    cases = {"pair_sweep_tri": [], "pair_sweep": [], "fused_dense_chunk": [],
             "fused_dense_chunk_ext": []}
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

            # Kernel 5: the ordered sweep, rows 0..5 per column, with and
            # without observables; the same pair work as kernel 2 (bound).
            for want_obs in (True, False):
                got = pair_sweep.pair_sweep(r, n, box, rc2, want_obs)
                want = pair_sweep.pair_sweep_plain(r, n, box, rc2, want_obs)
                errs = [rel_err(got[row], want[row]) for row in range(6)]
                require(bool((got[6:] == 0).all()) and bool((got[:, n:] == 0).all()),
                        f"pair_sweep {label} {dname}: padding rows/columns not zero")
                worst = max(e[1] for e in errs)
                require(worst <= tol, f"pair_sweep {label} {dname} obs={want_obs}: rel err "
                                      f"{worst:.3e} > {tol}")
                case = {**bound(dname, sweep_flops(cand, cut, want_obs), 2 * rows_bytes),
                        "shape": label, "dtype": dname, "observables": want_obs,
                        "n_pad": r.shape[1], "max_abs_err": max(e[0] for e in errs),
                        "rel_err": worst,
                        "ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep(
                            r, n, box, rc2, want_obs), 50),
                        "plain_ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_plain(
                            r, n, box, rc2, want_obs), 5)}
                if want_obs:
                    # The (N, 3) force API around it: transposes, padding and
                    # the float64 totals, timed on the same positions.
                    xyz = r[0:3, :n].T.contiguous()
                    case["force_api_ms"] = cuda_time_ms(torch, lambda: pair_sweep.lj_force_energy_pallas(
                        xyz, box, rc2, False), 50)
                cases["pair_sweep"].append(case)

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

            # The persistent grid capped at TILES_PER_BLOCK tiles a block
            # against the full grid, bit for bit.
            cap_blocks = r.shape[1] // (32 * TILES_PER_BLOCK)
            capped = {}
            for extended in (False, True):
                zero = torch.zeros_like(r)
                ext = (zero, zero) if extended else (None, None)
                args = ("fused_dense_chunk", extended, r, ext[0], v, ext[1], a, n, box, rc2,
                        dt, 10)
                full = fused._launch(*args)
                cap = fused._launch(*args, grid_cap=cap_blocks)
                capped["ext" if extended else "plain"] = all(
                    g is None or bool(torch.equal(g, w)) for g, w in zip(cap, full))
            require(all(capped.values()), f"fused_dense_chunk {label} {dname}: the grid capped "
                                          f"at {cap_blocks} blocks differs from the full grid")
            cases["fused_dense_chunk"][-1]["capped_grid_bit_identical"] = capped

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
        per = "per call" if name.startswith("pair_sweep") else f"per {chunk}-step chunk"
        for c in cs:
            extra = (f", observables {c['observables']}" if "observables" in c else "") + (
                f", force API (N, 3) call {c['force_api_ms']:.4f} ms" if "force_api_ms" in c else
                "") + (f", grid capped at {TILES_PER_BLOCK} tiles a block bit-identical "
                       f"{c['capped_grid_bit_identical']}" if "capped_grid_bit_identical" in c
                       else "")
            log(f"kernel {name} {c['shape']} {c['dtype']}: rel err {c['rel_err']:.3e} "
                f"(tol {KERNEL_TOL[c['dtype']]:.0e}), {c['ms']:.4f} ms vs plain "
                f"{c['plain_ms']:.4f} ms {per}; bound {c['bound_ms']:.4f} ms{extra}")
    for c in pair_terms_report:
        log(f"kernel lj_pair_terms (device function, element-wise check) {c['shape']} box "
            f"{c['dtype']}: rel err {c['rel_err']:.3e}, bit-identical to twin: "
            f"{c['bit_identical']}, {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms per 65536 pairs")
    cases["lj_pair_terms"] = pair_terms_report
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


def block_pairs(torch, xi, xj, box_length: float, rc_square: float, gi0: int, gj0: int,
                i_lo: int = 0, j_hi: int | None = None) -> tuple[int, int]:
    """(candidates, pairs inside the cutoff) of the rows xi (ni, 3) against
    xj (nj, 3) over the active range [i_lo, ni) x [0, j_hi), gi != gj by
    global index; counted on the card in float64."""
    x, y = xi.double()[i_lo:], xj.double()[:j_hi]
    d = x[:, None, :] - y[None, :, :]
    d -= box_length * torch.round(d / box_length)
    r2 = (d * d).sum(dim=-1)
    gi = gi0 + i_lo + torch.arange(x.shape[0], device=x.device)
    gj = gj0 + torch.arange(y.shape[0], device=x.device)
    other = gi[:, None] != gj[None, :]
    return int(other.sum()), int(((r2 < rc_square) & other).sum())


def phase_rect_kernels(torch) -> dict:
    """Kernels 6 and 7 (the particle-sharded path's hops) against their
    twins at each shape the main path gives them (RECT_SHAPES): the self
    offset (gi0 == gj0), a full hop, the two sides of the gated half hop
    (the low rank sweeps i rows >= ni/2 against block d/2, the high rank j
    rows < ni/2 against block 0; together the full block pair once),
    observables off and on, float32 and float64, on shuffled perturbed
    lattices."""
    import numpy as np

    from ljmd_tpu_torch.ops import pair_sweep
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    cases = {name: [] for name in RECT_KERNELS}
    for shape, which, d, rect_hops, newton_hops in RECT_SHAPES:
        label, k, box, rc = SHAPES[which]
        rc2 = rc * rc
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            tol = KERNEL_TOL[dname]
            n, r, _ = perturbed_fcc(k, box, 1234 + k, torch, dtype, dev)
            # Shuffled, so that every block pair has pairs inside the cutoff
            # (in lattice order blocks 0 and d/2 lie apart: the masks would go
            # untested).
            r[:, :n] = r[:, torch.as_tensor(np.random.default_rng(k).permutation(n), device=dev)]
            ni = n // d
            half = ni // 2

            def blk(s):
                out = torch.zeros((8, -(-ni // 128) * 128), dtype=dtype, device=dev)
                out[:, :ni] = r[:, s * ni:(s + 1) * ni]
                return out

            rows_bytes = 8 * blk(0).shape[1] * r.element_size()
            xyz = [blk(s)[0:3, :ni].T for s in range(d)]
            rect = {"self": (1, 1), "hop": (1, 0)}
            newton = {"self": ((1, 1, 0, ni),), "hop": ((1, 0, 0, ni),),
                      "half": ((0, d // 2, half, ni), (d // 2, 0, 0, half), (0, d // 2, 0, ni))}
            for want_obs in (False, True):
                for hop in rect_hops:
                    si, sj = rect[hop]
                    args = (blk(si), blk(sj), ni, ni, si * ni, sj * ni, box, rc2, want_obs)
                    got = pair_sweep.pair_sweep_rect(*args)
                    want = pair_sweep.pair_sweep_rect_plain(*args)
                    errs = [rel_err(got[row], want[row]) for row in range(6)]
                    worst = max(e[1] for e in errs)
                    tag = f"pair_sweep_rect {shape} {hop} {dname} obs={want_obs}"
                    require(bool((got[6:] == 0).all()) and bool((got[:, ni:] == 0).all()),
                            f"{tag}: padding rows/columns not zero")
                    require(worst <= tol, f"{tag}: rel err {worst:.3e} > {tol}")
                    cand, cut = block_pairs(torch, xyz[si], xyz[sj], box, rc2, si * ni, sj * ni)
                    cases["pair_sweep_rect"].append({
                        **bound(dname, sweep_flops(cand, cut, want_obs), 3 * rows_bytes),
                        "shape": f"{shape} {hop}", "dtype": dname,
                        "observables": want_obs, "candidates": cand, "cut_pairs": cut,
                        "max_abs_err": max(e[0] for e in errs), "rel_err": worst,
                        "ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_rect(*args), 50),
                        "plain_ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_rect_plain(
                            *args), 5)})
                for hop in newton_hops:
                    outs = []
                    for si, sj, i_lo, j_hi in newton[hop]:
                        args = (blk(si), blk(sj), ni, ni, si * ni, sj * ni, box, rc2, i_lo, j_hi,
                                want_obs)
                        got = pair_sweep.pair_sweep_rect_newton(*args)
                        want = pair_sweep.pair_sweep_rect_newton_plain(*args)
                        outs.append(got)
                        errs = [rel_err(g[row], w[row]) for g, w in zip(got, want)
                                for row in range(6)]
                        worst = max(e[1] for e in errs)
                        tag = (f"pair_sweep_rect_newton {shape} {hop} [{i_lo}, {ni}) x [0, "
                               f"{j_hi}) {dname} obs={want_obs}")
                        require(bool((got[1][3:] == 0).all()), f"{tag}: acc_j rows 3..7 not 0")
                        require(bool((got[0][6:] == 0).all()) and bool((got[0][:, ni:] == 0).all())
                                and bool((got[1][:, ni:] == 0).all()), f"{tag}: padding not zero")
                        require(worst <= tol, f"{tag}: rel err {worst:.3e} > {tol}")
                        if hop == "half" and (i_lo, j_hi) == (0, ni):
                            continue  # the reference for the two halves, below
                        side = "" if hop != "half" else ("_low" if i_lo else "_high")
                        cand, cut = block_pairs(torch, xyz[si], xyz[sj], box, rc2, si * ni,
                                                sj * ni, i_lo, j_hi)
                        cases["pair_sweep_rect_newton"].append({
                            **bound(dname, sweep_flops(cand, cut, want_obs), 4 * rows_bytes),
                            "shape": f"{shape} {hop}{side}", "dtype": dname,
                            "observables": want_obs, "i_lo": i_lo, "j_hi": j_hi,
                            "candidates": cand, "cut_pairs": cut,
                            "max_abs_err": max(e[0] for e in errs), "rel_err": worst,
                            "ms": cuda_time_ms(
                                torch, lambda: pair_sweep.pair_sweep_rect_newton(*args), 50),
                            "plain_ms": cuda_time_ms(
                                torch, lambda: pair_sweep.pair_sweep_rect_newton_plain(*args), 5)})
                    if hop != "half":
                        continue
                    # The gated half hop's two sides cover the block pair {0, d/2}
                    # once: the low rank's i side plus the high rank's reactions on
                    # block 0, and so on.
                    lo, hi, full = outs
                    pairs = ((lo[0][0:3] + hi[1][0:3], full[0][0:3]),
                             (lo[1][0:3] + hi[0][0:3], full[1][0:3]))
                    if want_obs:
                        pairs += ((lo[0][3:6].sum(1) + hi[0][3:6].sum(1), full[0][3:6].sum(1)),)
                    cover = max(rel_err(a, b)[1] for a, b in pairs)
                    require(cover <= tol, f"pair_sweep_rect_newton {shape} {dname} obs={want_obs}: "
                                          f"the two halves of the gated hop differ from the full "
                                          f"hop by {cover:.3e} > {tol}")
                    cases["pair_sweep_rect_newton"][-1]["halves_vs_full_rel_err"] = cover
    for name, cs in cases.items():
        for c in cs:
            log(f"kernel {name} {c['shape']} {c['dtype']} observables {c['observables']}: rel "
                f"err {c['rel_err']:.3e} (tol {KERNEL_TOL[c['dtype']]:.0e}), {c['ms']:.4f} ms "
                f"vs plain {c['plain_ms']:.4f} ms per call; bound {c['bound_ms']:.5f} ms "
                f"({c['bound_by']}, {c['candidates']} candidates, {c['cut_pairs']} inside rc)"
                + (f"; gated halves vs full hop {c['halves_vs_full_rel_err']:.3e}"
                   if "halves_vs_full_rel_err" in c else ""))
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
            largs = (r, v, a, tiles, tcounts, n, L, cfg.rc_square, cfg.dt, k, 128, tj, None,
                     None, False)
            capped = all(bool(torch.equal(g, w)) for g, w in zip(
                fused_list._launch(*largs, grid_cap=n_pad // (32 * TILES_PER_BLOCK)),
                fused_list._launch(*largs)))
            require(capped, f"fused_dense_chunk_list {label} {dname}: the grid capped at "
                            f"{TILES_PER_BLOCK} tiles a block differs from the full grid")
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
                "visits": tcounts.tolist(), "capped_grid_bit_identical": capped, "ms": ms,
                "plain_ms": plain_ms})
    for c in cases["build_window_lists"]:
        log(f"kernel build_window_lists {c['shape']} {c['dtype']}: lists equal to the twin's "
            f"(fluid and random flags), tcounts {c['tcounts']}, {c['ms']:.4f} ms vs plain "
            f"{c['plain_ms']:.4f} ms per call")
    for c in cases["fused_dense_chunk_list"]:
        modes = ", ".join(f"{m['mode']} {m['rel_err']:.3e}" for m in c["modes"])
        log(f"kernel fused_dense_chunk_list {c['shape']} {c['dtype']}: rel err {modes} "
            f"(tol {KERNEL_TOL[c['dtype']]:.0e}), {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms "
            f"per {k}-step chunk; grid capped at {TILES_PER_BLOCK} tiles a block bit-identical "
            f"{c['capped_grid_bit_identical']}")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


def pencil_candidates(counts, tbl) -> int:
    """Pair-once candidates of the half-shell pair set among valid slots:
    each pencil with itself and with its 4 upper neighbours."""
    c = counts.long().cpu()
    return int((c * (c - 1) // 2).sum() + (c[:, None] * c[tbl.long().cpu().reshape(-1, 4)]).sum())


def zband_candidates(torch, valid, nbr_tbl, wins, cap: int, window: int) -> int:
    """Pair-once candidates of the z-banded sweep's pair set among valid
    slots: for each 128-slot slice and neighbour, the slice's valid slots
    times the valid slots of window A and of window B outside A; each pair
    is in the set from both of its slots, each slot once with itself."""
    P = nbr_tbl.numel() // 9
    T = valid.numel() // 128
    v = valid.double()
    vcum = torch.cat([torch.zeros((P, 1), dtype=torch.float64, device=v.device),
                      v.reshape(P, cap).cumsum(1)], dim=1)
    j = nbr_tbl.long().reshape(P, 9)[torch.arange(T, device=v.device) // (cap // 128)]
    sa, sb, ub = (w.long().reshape(T, 9) for w in wins)

    def count(lo, hi):  # valid slots of ranks [lo, hi) of each (slice, neighbour) pencil
        return vcum[j, hi.clamp(0, cap)] - vcum[j, lo.clamp(0, cap)]

    overlap = torch.where(torch.minimum(sa, sb) + window > torch.maximum(sa, sb),
                          count(torch.maximum(sa, sb), torch.minimum(sa, sb) + window), 0.0)
    b = torch.where(ub > 0, count(sb, sb + window) - overlap, 0.0)
    per_slice = (count(sa, sa + window) + b).sum(dim=1) * v.reshape(T, 128).sum(dim=1)
    return int(round((float(per_slice.sum()) - float(v.sum())) / 2))


def strip_inputs(torch, c, grid, rank: int, rc_square: float):
    """The strip sweep's inputs for ``rank`` of a STRIP_D-rank split of the
    cell-pair carry ``c``: ((rows of the strip plus halo, strip table,
    strip-plus-halo counts, the rank's shifts, grid, rc^2), p_loc, pair-once
    candidates among valid slots, pairs inside the cutoff). The pairs are
    counted over the sweep's own visits (``table_visits``), on the card."""
    from ljmd_tpu_torch.ops import pencil_sweep
    from ljmd_tpu_torch.parallel import spatial_pencil as sp

    m, cap = grid.m_xy, grid.capacity
    m_xl = m // STRIP_D
    p_loc = m_xl * m
    w = p_loc * cap
    nxt = (rank + 1) % STRIP_D
    dev = c.r.device
    r_aug = torch.cat([c.r[:, rank * w:(rank + 1) * w], c.r[:, nxt * w:nxt * w + m * cap]], 1)
    counts = sp.augmented_counts(c.counts, m, STRIP_D)[rank]
    tbl = torch.as_tensor(sp._local_half_shell_table(m, m_xl), device=dev)
    shf = torch.as_tensor(sp._device_shift_tables(m, m_xl, STRIP_D)[rank], device=dev)
    cnt = counts.long().cpu()
    cand = int((cnt[:p_loc] * (cnt[:p_loc] - 1) // 2).sum()
               + (cnt[:p_loc, None] * cnt[tbl.long().cpu().reshape(-1, 4)]).sum())
    x = r_aug.double()
    valid = x[3] > 0.5
    L = grid.box_length
    cut = 0
    for ista, jsta, shx, shy, width, tri in pencil_sweep.table_visits(
            p_loc, cap, tbl.cpu(), shf.cpu(), cnt):
        ar_i, ar_j = torch.arange(128, device=dev), torch.arange(width, device=dev)
        for b0 in range(0, len(ista), 256):
            ii = torch.as_tensor(ista[b0:b0 + 256], device=dev)[:, None] + ar_i
            jj = torch.as_tensor(jsta[b0:b0 + 256], device=dev)[:, None] + ar_j
            off = [torch.as_tensor(sh[b0:b0 + 256], device=dev).double()[:, None] * L
                   for sh in (shx, shy)]
            dx = x[0][ii][:, :, None] - (x[0][jj] + off[0])[:, None, :]
            dy = x[1][ii][:, :, None] - (x[1][jj] + off[1])[:, None, :]
            dz = x[2][ii][:, :, None] - x[2][jj][:, None, :]
            dz -= L * torch.round(dz / L)
            inside = (dx * dx + dy * dy + dz * dz < rc_square) & valid[ii][:, :, None] \
                & valid[jj][:, None, :]
            if tri:
                inside &= (ar_j[None, :] > ar_i[:, None])[None]
            cut += int(inside.sum())
    return (r_aug, tbl, counts, shf, grid, rc_square), p_loc, cand, cut


def phase_pencil_kernels(torch, cfg, state) -> dict:
    """Kernels 13+14, 15, 16 and 11 (the cell-pair path) against their twins
    at config 5's geometry, from ``state`` (an N=62500 fluid), at each of
    PENCIL_CAPS, float32 and float64, and kernel 12 at FULL_SWEEP_CAP
    against its twin and kernel 11. Compared on the valid slots (empty slots
    hold sentinels; the full sweeps must leave them exactly 0); extended
    outputs as r + r_lo and v + vc."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops import cell_list, fused_pencil, pencil_sweep
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    L, rc2, dt = cfg.box_length, cfg.rc_square, cfg.dt
    k_check, k_time = PENCIL_CHECK_STEPS, PENCIL_CHUNK_STEPS
    cut = pairs_within(torch, state.r, L, rc2)
    n = cfg.n
    cases = {name: [] for name in PENCIL_KERNELS + FULL_KERNELS}
    r_list = cfg.rc + cfg.neighbor_skin
    log(f"pencil kernels: tolerances as above; a slot's force sums at most 9 x capacity "
        f"= 4608 terms; N={n}, {cut} pairs inside the cutoff")
    for cap in PENCIL_CAPS:
        grid = cell_list.make_pencil_grid(n, L, cfg.rc + cfg.neighbor_skin, cfg.density, cap)
        P, label = grid.n_pencils, f"N={n} cap={cap}"
        tbl, shf = (torch.as_tensor(t, device=dev)
                    for t in pencil_sweep.build_half_shell_tables(grid))
        ftbl = torch.as_tensor(pencil_sweep.build_tile_table(grid), device=dev)
        fshf = torch.as_tensor(pencil_sweep.build_shift_table(grid), device=dev)
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

            # Kernel 14's n_pencils_i: each rank's strip of a STRIP_D-rank
            # split plus its halo (the next strip's first x-column).
            for rank in range(STRIP_D):
                args, p_loc, s_cand, s_cut = strip_inputs(torch, c, grid, rank, rc2)
                valid_aug = args[0][3] > 0.5
                for want_obs in (True, False):
                    got = pencil_sweep.pencil_sweep_hs(*args, want_obs, n_pencils_i=p_loc)
                    want = pencil_sweep.pencil_sweep_hs_plain(*args, want_obs, n_pencils_i=p_loc)
                    require(bool((got[6:] == 0).all()) and bool((got[:, ~valid_aug] == 0).all()),
                            f"pencil_sweep_hs strip {label} {dname}: rows 6-7 or empty slots "
                            "not zero")
                    require(bool((got[3:, p_loc * cap:] == 0).all()),
                            f"pencil_sweep_hs strip {label} {dname}: observables on the halo")
                    errs = [rel_err(got[row, valid_aug], want[row, valid_aug]) for row in range(6)]
                    worst = max(e[1] for e in errs)
                    require(worst <= tol, f"pencil_sweep_hs strip {rank} {label} {dname} "
                                          f"obs={want_obs}: rel err {worst:.3e} > {tol}")
                    if rank:
                        continue  # rank 0's strip is timed (the same work as rank 1's)
                    aug_bytes = 2 * 8 * args[0].shape[1] * size + 4 * sum(
                        t.numel() for t in args[1:4])
                    cases["pencil_sweep_hs"].append({
                        **base, **bound(dname, sweep_flops(s_cand, s_cut, want_obs), aug_bytes),
                        "shape": f"{label} strip {p_loc}+{grid.m_xy}", "candidates": s_cand,
                        "cut_pairs": s_cut, "n_pencils_i": p_loc, "observables": want_obs,
                        "max_abs_err": max(e[0] for e in errs), "rel_err": worst,
                        "ms": cuda_time_ms(torch, lambda: pencil_sweep.pencil_sweep_hs(
                            *args, want_obs, n_pencils_i=p_loc), 20),
                        "plain_ms": cuda_time_ms(torch, lambda: pencil_sweep.pencil_sweep_hs_plain(
                            *args, want_obs, n_pencils_i=p_loc), 2, warmup=1)})

            # Kernel 11: the full 9-neighbour sweep on the same slots; the
            # same pair set as the half shell, pair once.
            full_table_bytes = 4 * (ftbl.numel() + fshf.numel() + c.counts.numel())
            full = {}
            for want_obs in (True, False):
                args = (c.r, ftbl, c.counts, fshf, grid, rc2, want_obs)
                got = full[want_obs] = pencil_sweep.pencil_sweep(*args)
                want = pencil_sweep.pencil_sweep_plain(*args)
                require(bool((got[6:] == 0).all()) and bool((got[:, ~valid] == 0).all()),
                        f"pencil_sweep_full {label} {dname}: rows 6-7 or empty slots not zero")
                errs = [rel_err(got[row, valid], want[row, valid]) for row in range(6)]
                worst = max(e[1] for e in errs)
                require(worst <= tol, f"pencil_sweep_full {label} {dname} obs={want_obs}: "
                                      f"rel err {worst:.3e} > {tol}")
                cases["pencil_sweep_full"].append({
                    **base, **bound(dname, sweep_flops(cand, cut, want_obs),
                                    2 * slots_bytes + full_table_bytes),
                    "observables": want_obs, "max_abs_err": max(e[0] for e in errs),
                    "rel_err": worst,
                    "ms": cuda_time_ms(torch, lambda: pencil_sweep.pencil_sweep(*args), 20),
                    "plain_ms": cuda_time_ms(torch, lambda: pencil_sweep.pencil_sweep_plain(
                        *args), 2, warmup=1)})

            # Kernel 12: the z-banded sweep where its window is narrower than
            # the pencil, on the same slots (z-sorted ranks: bin_to_slots).
            if cap == FULL_SWEEP_CAP:
                window = cell_list.default_z_window(grid, n, r_list)
                require(window < cap, f"z-band {label}: window {window} covers the pencil")
                wins = cell_list.compute_z_windows(c.r, c.r[3], c.counts, grid, window, r_list)
                require(not bool(wins[3]), f"z-band {label} {dname}: window overflow")
                wins = wins[:3]
                zcand = zband_candidates(torch, valid, ftbl, wins, cap, window)
                zband_bytes = 4 * (ftbl.numel() + c.counts.numel() + 3 * wins[0].numel())
                for want_obs in (True, False):
                    args = (c.r, ftbl, c.counts, *wins, grid, rc2, window, want_obs)
                    got = pencil_sweep.pencil_sweep_zband(*args)
                    want = pencil_sweep.pencil_sweep_zband_plain(*args)
                    require(bool((got[6:] == 0).all()) and bool((got[:, ~valid] == 0).all()),
                            f"pencil_sweep_zband {label} {dname}: rows 6-7 or empty slots not zero")
                    errs = [rel_err(got[row, valid], want[row, valid]) for row in range(6)]
                    vs_full = max(rel_err(got[row, valid], full[want_obs][row, valid])[1]
                                  for row in range(6))
                    worst = max(e[1] for e in errs)
                    require(worst <= tol, f"pencil_sweep_zband {label} {dname} obs={want_obs}: "
                                          f"rel err {worst:.3e} > {tol}")
                    require(vs_full <= tol, f"pencil_sweep_zband {label} {dname} obs={want_obs}: "
                                            f"differs from the full sweep by {vs_full:.3e} > {tol}")
                    cases["pencil_sweep_zband"].append({
                        **base, **bound(dname, sweep_flops(zcand, cut, want_obs),
                                        2 * slots_bytes + zband_bytes),
                        "candidates": zcand, "window": window, "observables": want_obs,
                        "use_b": int(wins[2].sum()), "max_abs_err": max(e[0] for e in errs),
                        "rel_err": worst, "rel_err_vs_full": vs_full,
                        "ms": cuda_time_ms(torch, lambda: pencil_sweep.pencil_sweep_zband(*args),
                                           20),
                        "plain_ms": cuda_time_ms(
                            torch, lambda: pencil_sweep.pencil_sweep_zband_plain(*args), 2,
                            warmup=1)})

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
        sweep = "observables" in cs[0]
        per = "per call" if sweep else f"per {k_time}-step chunk"
        for c in cs:
            what = (f"observables {c['observables']}" if sweep else
                    ", ".join(f"{m['mode']} {m['rel_err']:.3e}" for m in c["modes"]))
            if "rel_err_vs_full" in c:
                what += (f", window {c['window']} ({c['use_b']} window-B visits), vs the full "
                         f"sweep {c['rel_err_vs_full']:.3e}")
            log(f"kernel {name} {c['shape']} {c['dtype']} (max count {c['counts_max']}): "
                f"{what}, rel err {c['rel_err']:.3e} (tol {KERNEL_TOL[c['dtype']]:.0e}), "
                f"{c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms {per}; bound "
                f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {c['candidates']} candidates)")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


# ---------------------------------------------------------------- phase 3e
def gated_cut_pairs(torch, r, n: int, box_length: float, rc_square: float, upper) -> int:
    """Pairs (i < j) of ``upper`` (an (n, n) bool matrix) inside the cutoff
    under the minimum image, counted on the card in float64 in row blocks."""
    x = r[0:3, :n].T.double()
    total = 0
    for i0 in range(0, n, 512):
        d = x[i0:i0 + 512, None, :] - x[None, :, :]
        d -= box_length * torch.round(d / box_length)
        total += int((((d * d).sum(dim=-1) < rc_square) & upper[i0:i0 + 512]).sum())
    return total


def block_chunk_share(torch, flags, n: int, n_pad: int, tile_i: int, tile_j: int):
    """(chunks the busiest block runs, the mean over blocks, chunks a block
    has) of kernel 8 under ``flags``: a 32-row block runs a 128-column chunk
    when its forward tile (j > i) or its backward tile (j < i) is active."""
    f = (flags.reshape(n_pad // tile_i, n_pad // tile_j) > 0).cpu()
    i0 = torch.arange(0, n_pad, 32)[:, None]
    j0 = torch.arange(0, n, 128)[None, :]
    fwd = (j0 + 127 > i0) & f[i0 // tile_i, j0 // tile_j]
    bwd = (j0 < i0 + 31) & f[j0 // tile_i, i0 // tile_j]
    run = (fwd | bwd).sum(dim=1)
    return int(run.max()), float(run.double().mean()), j0.numel()


def phase_flags_kernel(torch) -> dict:
    """Kernel 8 (``fused_dense_chunk_flags``) against its plain version on
    the experiments' own state (``experiments/_common.py::melted_zsort``:
    N=4000, float32 melted 512 steps by the zsort engine), in float32 and
    float64, plain and extended: with the fluid's flags (window rc + 0.7) at
    each tile_j of zfloor's sweep, and at tile_j 512 with all-zero, all-3
    and random 0/1 flags; all-3 flags bit-equal to the unflagged chunk."""
    import numpy as np

    from ljmd_tpu_torch.experiments._common import melted_zsort
    from ljmd_tpu_torch.ops import fused, window_lists
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    cfg, _, c = melted_zsort(dev)
    n, L, rc2, dt = cfg.n, cfg.box_length, cfg.rc_square, cfg.dt
    n_pad = c.r.shape[1]
    cases = []
    for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        tol = KERNEL_TOL[dname]
        r, v, a = (t.to(dtype) for t in (c.r, c.v, c.a))
        zero = torch.zeros_like(r)
        rows_bytes = 8 * n_pad * r.element_size()
        for tj in FLAG_TILES:
            real = window_lists.compute_tile_flags(r, n, 128, tj, L, cfg.rc + 0.7)
            patterns = {"real": real}
            if tj == FLAG_TILES[0]:
                rand = np.random.default_rng(tj).integers(0, 2, real.numel()).astype(np.int32)
                patterns.update(zero=torch.zeros_like(real), all3=torch.full_like(real, 3),
                                random=torch.as_tensor(rand, device=dev))
            for pname, flags in patterns.items():
                errs = []
                for mode in ("plain", "extended"):
                    kw = {"r_lo": zero, "vc": zero} if mode == "extended" else {}
                    args = (r, v, a, flags, n, L, rc2, dt, FLAG_CHECK_STEPS)
                    got = fused.fused_dense_chunk_flags(*args, tile_j=tj, **kw)
                    want = fused.fused_dense_chunk_flags_plain(*args, tile_j=tj, **kw)
                    if pname == "all3":
                        ref = (fused.fused_dense_chunk_ext(r, zero, v, zero, a, n, L, rc2, dt,
                                                           FLAG_CHECK_STEPS) if kw else
                               fused.fused_dense_chunk(r, v, a, n, L, rc2, dt, FLAG_CHECK_STEPS))
                        require(all(bool(torch.equal(g, w)) for g, w in zip(got, ref)),
                                f"fused_dense_chunk_flags {dname} {mode}: all-3 flags differ "
                                "from the unflagged chunk")
                    if kw:
                        got = (got[0].double() + got[1].double(),
                               got[2].double() + got[3].double(), got[4])
                        want = (want[0].double() + want[1].double(),
                                want[2].double() + want[3].double(), want[4])
                    e = [rel_err(g, w) for g, w in zip(got, want)]
                    worst = max(x[1] for x in e)
                    require(worst <= tol, f"fused_dense_chunk_flags tile_j={tj} {pname} {dname} "
                                          f"{mode}: rel err {worst:.3e} > {tol}")
                    errs.append({"mode": mode, "max_abs_err": max(x[0] for x in e),
                                 "rel_err": worst})
                upper = torch.triu(fused.tile_gate(flags, n, n_pad, 128, tj), 1)
                cand = int(upper.sum())
                cut = gated_cut_pairs(torch, r, n, L, rc2, upper)
                targs = (r, v, a, flags, n, L, rc2, dt, FLAG_CHUNK_STEPS)
                busiest, mean, per_block = block_chunk_share(torch, flags, n, n_pad, 128, tj)
                case = {**bound(dname, chunk_flops(FLAG_CHUNK_STEPS, cand, cut, n),
                                6 * rows_bytes + 4 * flags.numel()),
                        "shape": f"N={n} tile_j={tj} {pname}", "dtype": dname,
                        "block_chunks": {"busiest": busiest, "mean": mean, "of": per_block},
                        "active": int((flags > 0).sum()), "tiles": flags.numel(),
                        "candidates": cand, "cut_pairs": cut, "modes": errs,
                        "max_abs_err": max(x["max_abs_err"] for x in errs),
                        "rel_err": max(x["rel_err"] for x in errs),
                        "ms": cuda_time_ms(torch, lambda: fused.fused_dense_chunk_flags(
                            *targs, tile_j=tj), 10)}
                if pname == "real":
                    case["plain_ms"] = cuda_time_ms(
                        torch, lambda: fused.fused_dense_chunk_flags_plain(*targs, tile_j=tj), 1,
                        warmup=1)
                cases.append(case)
    for c in cases:
        modes = ", ".join(f"{m['mode']} {m['rel_err']:.3e}" for m in c["modes"])
        plain = f" vs plain {c['plain_ms']:.4f} ms" if "plain_ms" in c else ""
        bc = c["block_chunks"]
        log(f"kernel fused_dense_chunk_flags {c['shape']} {c['dtype']} ({c['active']}/"
            f"{c['tiles']} tiles active; the busiest block runs {bc['busiest']} of {bc['of']} "
            f"column chunks, the mean {bc['mean']:.1f}): rel err {modes} "
            f"(tol {KERNEL_TOL[c['dtype']]:.0e}), "
            f"{c['ms']:.4f} ms{plain} per {FLAG_CHUNK_STEPS}-step chunk; bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {c['candidates']} candidates)")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return {"fused_dense_chunk_flags": cases}


def probe_library(name: str, *inputs, iters: int):
    """ITERS calls of the library operation probe ``name`` stands for
    (``library_ms``; the port never calls these)."""
    import torch

    from ljmd_tpu_torch.experiments.mosaic_support import WINDOWS

    x = inputs[-1]
    offs = inputs[0].tolist() if len(inputs) == 2 else None
    out = torch.zeros((8, 512) if name.startswith("lane") else (256, 128), dtype=x.dtype,
                      device=x.device)
    res = None
    for i in range(iters):
        if name in ("t8n", "t128"):
            res = x.t().contiguous()
        elif name in WINDOWS:
            kind, scale = WINDOWS[name]
            o = offs[i] * scale
            if kind == "lane":
                out[0] += x[0, o:o + 512]
            else:
                out += x[o:o + 256]
            res = out
        elif name == "roll":
            res = torch.roll(x, offs[i], 1)
        else:
            res = torch.sum(x, dim=1)
    return res


def phase_probe_kernels(torch) -> dict:
    """Kernel 17: each of the nine probes at N=4096, ITERS=200 against its
    plain loop, timed beside it and beside ITERS calls of the library
    operation it stands for (``probe_library``)."""
    from ljmd_tpu_torch.experiments import mosaic_support as ms
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    tol = KERNEL_TOL["float32"]
    cases = []
    for name, label in ms.PROBES:
        inputs = ms.probe_inputs(name, dev)
        got, want = ms.probe(name, *inputs), ms.probe_plain(name, *inputs)
        err, rel = rel_err(got, want)
        require(rel <= tol, f"probe {name}: rel err {rel:.3e} > {tol}")
        x = inputs[-1]
        # Operations per iteration: an add per output element (transposes,
        # windows, roll), a multiply and an add per input element (row sums).
        per_iter = (2 * x.numel() if name.startswith("rowsum") else
                    512 if name.startswith("lane") else got.numel())
        nbytes = 4 * (x.numel() + got.numel() + (ms.ITERS if len(inputs) == 2 else 0))
        cases.append({**bound("float32", ms.ITERS * per_iter, nbytes), "shape": name,
                      "label": label, "dtype": "float32", "max_abs_err": err, "rel_err": rel,
                      "ms": cuda_time_ms(torch, lambda: ms.probe(name, *inputs), 20),
                      "plain_ms": cuda_time_ms(torch, lambda: ms.probe_plain(name, *inputs), 2,
                                               warmup=1),
                      "library_ms": cuda_time_ms(torch, lambda: probe_library(
                          name, *inputs, iters=ms.ITERS), 2, warmup=1)})
    for c in cases:
        log(f"kernel mosaic_probes {c['label']}: rel err {c['rel_err']:.3e} (tol {tol:.0e}), "
            f"{c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms vs library {c['library_ms']:.4f} "
            f"ms per {ms.ITERS} iterations; bound {c['bound_ms']:.5f} ms ({c['bound_by']})")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return {"mosaic_probes": cases}


def layout_cut_pairs(torch, r8, rT, name: str, ti, tj, v: int, tj_w: int, box: float,
                     rc2: float) -> int:
    """Pairs inside the cutoff over the body's v visits at the start state
    (its positions move by ~1e-6 a step), counted on the card."""
    total = 0
    for t in range(v):
        i_lo = int(ti[t]) * 128
        xi = r8[0:3, i_lo:i_lo + 128].T.double()
        if name == "k2":
            xj = rT[8 * int(tj[t]):8 * int(tj[t]) + tj_w, 0:3].double()
        else:
            xj = r8[0:3, int(tj[t]) * tj_w:(int(tj[t]) + 1) * tj_w].T.double()
        d = xi[:, None, :] - xj[None, :, :]
        d -= box * torch.round(d / box)
        total += int(((d * d).sum(dim=-1) < rc2).sum())
    return total


def phase_layout_kernels(torch) -> dict:
    """Kernel 18: each body at N_PAD=4096 over the experiment's 128 visits,
    LAYOUT_CHECK_STEPS steps, against its plain version, in the
    experiment's box and in a box of lattice spacing 0.5 (L = 8, where the
    forces, which reach r only through f * 1e-9, move it past float32's
    resolution); the transpose glue at both shapes."""
    from ljmd_tpu_torch.experiments import layout as ly
    from ljmd_tpu_torch.experiments import mosaic_support as ms
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    tol = KERNEL_TOL["float32"]
    steps, v = LAYOUT_CHECK_STEPS, ly.V_HI
    ti, tj = ly.visit_lists(v, 7, ly.N_PAD)
    dense_box = 0.5 * math.ceil(ly.N_PAD ** (1.0 / 3.0) - 1e-9)  # lattice spacing 0.5
    cases = []
    for box in (ly.L, dense_box):
        r8, rT = ly.make_state(0, ly.N_PAD, dev, box=box)
        for item in LAYOUT_ITEMS:
            name, w = item.rsplit("-", 1)
            tj_w = int(w)
            lv = ly.variant_lists(name, tj_w, ti, tj, ly.N_PAD)
            lists = [torch.tensor(x, dtype=torch.int32, device=dev) for x in lv]
            args = (name, r8, rT, *lists, v, tj_w, steps)
            got = ly.layout_body(*args, box=box)
            want = ly.layout_body_plain(*args, box=box)
            err, rel = rel_err(got, want)
            moved = float((want[1] - r8[1]).abs().max())
            require(rel <= tol, f"layout_body {item} L={box}: rel err {rel:.3e} > {tol}")
            case = {"shape": f"{item} v={v} L={box}", "dtype": "float32", "max_abs_err": err,
                    "rel_err": rel, "row1_moved": moved}
            if box == ly.L:
                cut = layout_cut_pairs(torch, r8, rT, name, *lv, v, tj_w, box, ly.RC2)
                nbytes = 4 * (2 * r8.numel() + rT.numel() + 2 * v)
                case.update(bound("float32", steps * (v * 128 * tj_w * FLOPS_CANDIDATE
                                                      + cut * FLOPS_FORCE), nbytes))
                case.update(cut_pairs=cut,
                            ms=cuda_time_ms(torch, lambda: ly.layout_body(*args, box=box), 10),
                            plain_ms=cuda_time_ms(torch, lambda: ly.layout_body_plain(
                                *args, box=box), 1, warmup=1))
            else:
                # The displacement itself within LAYOUT_DISP_TOL: float32
                # rounds r (~5e-7 at L = 8) far below it.
                disp = float((got - want).abs().max()) / moved
                case["disp_rel_err"] = disp
                require(moved > 1e-4, f"layout_body {item} L={box}: the forces did not move r")
                require(disp <= LAYOUT_DISP_TOL, f"layout_body {item} L={box}: displacement "
                                                 f"rel err {disp:.3e} > {LAYOUT_DISP_TOL}")
            cases.append(case)
    for shape in ((8, ly.N_PAD), (ly.N_PAD, 8)):
        x = torch.ones(shape, dtype=torch.float32, device=dev)
        got, want = ms.transpose_scaled(x, ly.ITERS_LO), ms.transpose_scaled_plain(x, ly.ITERS_LO)
        err, rel = rel_err(got, want)
        require(rel <= tol, f"transpose_scaled {shape}: rel err {rel:.3e} > {tol}")
        cases.append({**bound("float32", ly.ITERS_LO * x.numel(), 8 * x.numel()),
                      "shape": f"transpose {shape} x {ly.ITERS_LO}", "dtype": "float32",
                      "max_abs_err": err, "rel_err": rel,
                      "ms": cuda_time_ms(torch, lambda: ms.transpose_scaled(x, ly.ITERS_LO), 10),
                      "plain_ms": cuda_time_ms(torch, lambda: ms.transpose_scaled_plain(
                          x, ly.ITERS_LO), 1, warmup=1)})
    for c in cases:
        timing = (f", {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms; bound "
                  f"{c['bound_ms']:.5f} ms ({c['bound_by']})" if "ms" in c else
                  f", row 1 moved {c['row1_moved']:.3e}, displacement rel err "
                  f"{c['disp_rel_err']:.3e} (tol {LAYOUT_DISP_TOL:.0e})")
        log(f"kernel layout_bodies {c['shape']}: rel err {c['rel_err']:.3e} (tol {tol:.0e})"
            f"{timing}")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return {"layout_bodies": cases}


def phase_experiments(torch) -> dict:
    """The experiment entry points (``ljmd_tpu_torch.experiments``), each
    ``main`` once at its full size, the counts set to 0 just before and
    read just after; each must launch its kernels."""
    from ljmd_tpu_torch.experiments import layout, mosaic_support, overhead, zfloor
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    runs = {}
    for name, mod, argv, need in (
            ("exp_overhead", overhead, [], ("fused_dense_chunk_flags", "pencil_sweep_hs")),
            ("exp_zfloor", zfloor, [], ("fused_dense_chunk_flags",)),
            ("exp_mosaic_support", mosaic_support, [], ("mosaic_probes",)),
            ("exp_layout", layout, list(LAYOUT_ITEMS) + ["trans", "dot"], ("layout_bodies",))):
        log(f"{name}: python -m ljmd_tpu_torch.experiments.{name[4:]} {' '.join(argv)}")
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.time()
        out = mod.main(["--device", DEVICE, *argv])
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = LAUNCHES.snapshot()
        _check_launches(name, counts, need)
        runs[name] = {"wall_s": wall, "launches": counts, "result": out}
    LAUNCHES.reset()
    return runs


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


FULL_KERNELS = ("pencil_sweep_full", "pencil_sweep_zband")
MAIN_KERNELS = (("pair_sweep_tri", "pair_sweep", "fused_dense_chunk", "fused_dense_chunk_ext")
                + ZSORT_KERNELS + PENCIL_KERNELS + FULL_KERNELS + RECT_KERNELS
                + EXPERIMENT_KERNELS)


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
    host_reads = {}
    for line in proc.stdout.splitlines():
        if line.startswith('{"kernel_launches"'):
            counts = json.loads(line)["kernel_launches"]
        elif line.startswith('{"host_reads"'):
            host_reads = json.loads(line)["host_reads"]
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
        f"CLI wall {wall:.1f}s incl. startup, init and artifacts; host reads (init and "
        f"production) {json.dumps(host_reads)}")
    require(drift < DRIFT_BOUND[name], f"{name}: energy drift over bound")
    return {"engine": backend, "n": cfg.n, "drift": drift, "wall_s": wall,
            "particle_steps_per_s": rate, "diagnostics": diagnostics, "launches": counts,
            "host_reads": host_reads}


def _production_run(torch, name: str, cfg, state, tmp: str, needed: tuple, forbidden: tuple,
                    engine=None, backend: str = "auto") -> tuple[dict, object]:
    """run_production from ``state`` in this process through ``engine`` (or
    ``backend``), the counts set to 0 just before and read just after (the
    state's warmup is not part of the run), the artifacts written and
    checked."""
    from ljmd_tpu_torch.io.artifacts import write_run_artifacts
    from ljmd_tpu_torch.models.engine import HOST_READS
    from ljmd_tpu_torch.models.simulation import run_production
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    torch.cuda.synchronize()
    LAUNCHES.reset()
    HOST_READS.update(dict.fromkeys(HOST_READS, 0))
    t0 = time.time()
    res = run_production(cfg, state, backend=backend, engine=engine, record_frames=True,
                         device=DEVICE)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = LAUNCHES.snapshot()
    host_reads = dict(HOST_READS)
    _check_launches(name, counts, needed, forbidden)
    diagnostics = {k: bool(v) for k, v in res.diagnostics.items()}
    require(not any(diagnostics.values()), f"{name}: diagnostic flag set: {diagnostics}")
    out_dir = os.path.join(tmp, name)
    write_run_artifacts(out_dir, cfg, res, write_frames=True)
    _check_artifacts(out_dir, with_frames=True)
    require(bool(torch.isfinite(res.series).all()), f"{name}: non-finite series")
    drift = _drift(res.series[2].cpu())
    rate = cfg.n * cfg.total_steps / wall
    log(f"{name}: N={cfg.n} |dE/E| {drift:.3e} (bound {DRIFT_BOUND[name]:.0e}), production "
        f"{wall:.3f}s = {rate:.4e} particle-steps/s, {1e3 * wall / cfg.total_steps:.4f} ms/step; "
        f"host reads {json.dumps(host_reads)}; diagnostics {json.dumps(diagnostics)}")
    require(drift < DRIFT_BOUND[name], f"{name}: energy drift over bound")
    return ({"n": cfg.n, "drift": drift, "production_s": wall, "particle_steps_per_s": rate,
             "diagnostics": diagnostics, "launches": counts, "host_reads": host_reads},
            res.final_state)


def _in_process_run(torch, name: str, cfg, backend: str, tmp: str, needed: tuple,
                    forbidden: tuple, prod_cfg=None) -> tuple[dict, object]:
    """initialize (timed apart) and ``_production_run`` through ``backend``
    in this process. ``prod_cfg`` (default ``cfg``) is the production's
    config, e.g. with another capacity."""
    from ljmd_tpu_torch.models.simulation import initialize

    torch.cuda.synchronize()
    t0 = time.time()
    state = initialize(cfg, backend=backend, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    log(f"{name}: initialize (--backend {backend}, warmup {cfg.warmup_steps}) {init_s:.3f}s = "
        f"{cfg.n * cfg.warmup_steps / init_s:.4e} particle-steps/s")
    run, final = _production_run(torch, name, prod_cfg or cfg, state, tmp, needed, forbidden,
                                 backend=backend)
    return {**run, "engine": backend, "init_s": init_s}, final


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


def _cross_diff(torch, s, ref, L) -> float:
    """Worst of r (minimum image), ru, v, a relative to max(1, max |ref|)."""
    errs = _state_diff(torch, s, ref, L)
    errs["ru"] = rel_err(s.ru, ref.ru)[1]
    return max(errs.values())


def phase_flagship(torch) -> tuple[dict, float]:
    """The flagship step (``entry()``) on the card for FLAGSHIP_STEPS steps,
    timed on the host clock after a synchronize; then CROSS_STEPS steps of
    the same ``fn`` fed float64 tensors against the rows engine's per-step
    sweep, from one float64 state."""
    from ljmd_tpu_torch.entry import entry, flagship_cfg
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops._cuda import LAUNCHES
    from ljmd_tpu_torch.state import MDState

    name = "flagship_entry_f32"
    cfg = flagship_cfg()
    fn, args = entry(DEVICE)
    fn(*args)  # one untimed step
    torch.cuda.synchronize()
    LAUNCHES.reset()
    t0 = time.time()
    st, etot = args, []
    for _ in range(FLAGSHIP_STEPS):
        out = fn(*st)
        st = out[:4]
        etot.append(out[4] + out[5])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = LAUNCHES.snapshot()
    _check_launches(name, counts, ("pair_sweep",), tuple(k for k in MAIN_KERNELS
                                                         if k != "pair_sweep"))
    require(counts["pair_sweep"] == FLAGSHIP_STEPS, f"{name}: one sweep a step expected")
    e = torch.stack(etot).double().cpu()
    require(bool(torch.isfinite(e).all()), f"{name}: non-finite energies")
    drift = _drift(e)
    rate = cfg.n * FLAGSHIP_STEPS / wall
    log(f"{name} (entry(), make_force_fn auto -> the ordered-sweep kernel): N={cfg.n} "
        f"{FLAGSHIP_STEPS} steps {wall:.3f}s = {1e3 * wall / FLAGSHIP_STEPS:.4f} ms/step = "
        f"{rate:.4e} particle-steps/s, |dE/E| {drift:.3e} (bound {DRIFT_BOUND[name]:.0e})")
    require(drift < DRIFT_BOUND[name], f"{name}: energy drift over bound")

    rows = pe.make_engine(cfg.replace(dtype="float64"), "rows", DEVICE)
    s = MDState(*(t.double() for t in st))
    c, _ = rows.init(s)
    s = rows.get_state(c)
    st = (s.r, s.ru, s.v, s.a)
    for _ in range(CROSS_STEPS):
        st = fn(*st)[:4]
        c, _ = rows.step(c)
    cross = _cross_diff(torch, MDState(*st), rows.get_state(c), cfg.box_length)
    LAUNCHES.reset()
    log(f"flagship step vs rows (float64, {CROSS_STEPS} steps from one state): max rel diff "
        f"over r, ru, v, a {cross:.3e} (tol {CROSS_TOL:.0e})")
    require(cross <= CROSS_TOL, "the flagship step and the rows engine disagree")
    return ({"n": cfg.n, "steps": FLAGSHIP_STEPS, "wall_s": wall,
             "ms_per_step": 1e3 * wall / FLAGSHIP_STEPS, "particle_steps_per_s": rate,
             "drift": drift, "launches": counts}, cross)


def phase_rows_ordered(torch, tmp: str) -> tuple[dict, float]:
    """The rows engine with ``triangular=False`` on the N=4000 cut (warmup
    by the default rows engine, untimed), then in float64 from one state
    against ``triangular=True``: the sampled series within CROSS_TOL."""
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.models.simulation import initialize, run_production

    cfg = load_config(str(REPO / "examples" / "n4000_production.json")).replace(**N4000_CUT)
    state = initialize(cfg, backend="rows", device=DEVICE)
    name = "n4000_f32_rows_ordered"
    run, _ = _production_run(torch, name, cfg, state, tmp, ("pair_sweep", "fused_dense_chunk"),
                             tuple(k for k in MAIN_KERNELS
                                   if k not in ("pair_sweep", "fused_dense_chunk")),
                             engine=pe._rows_engine(cfg, DEVICE, triangular=False))
    cfg64 = cfg.replace(dtype="float64")
    s64 = state.to(dtype=torch.float64)
    series = [run_production(cfg64, s64, engine=pe._rows_engine(cfg64, DEVICE, triangular=tri),
                             device=DEVICE).series for tri in (False, True)]
    scale = series[1].abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    cross = float(((series[0] - series[1]).abs() / scale).max())
    log(f"rows triangular=False vs True (N={cfg.n}, float64, {cfg.total_steps} steps from one "
        f"state): series rel diff {cross:.3e} (tol {CROSS_TOL:.0e})")
    require(cross <= CROSS_TOL, "rows triangular=False and True disagree")
    return run, cross


def phase_full_sweeps(torch, cfg5, state, tmp: str) -> tuple[dict, dict]:
    """The cell-pair engine with the full 9-neighbour and the z-banded sweep
    (unfused, FULL_SWEEP_CHUNK steps between rebins) on the config-5 cut at
    FULL_SWEEP_CAP from ``state`` (phase 4c's end), then from one float64
    state CROSS_STEPS steps of each against the half-shell engine (fused
    static chunks)."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    cfg = cfg5.replace(neighbor_capacity=FULL_SWEEP_CAP)
    modes = {"full9": ({"half_shell": False}, "pencil_sweep_full"),
             "zband": ({"z_band": True}, "pencil_sweep_zband")}
    runs, ends = {}, {}
    for mode, (kw, kernel) in modes.items():
        eng = pe._cellpair_engine(cfg, DEVICE, inner_chunk=FULL_SWEEP_CHUNK, **kw)
        require(eng.run_fast.__name__ == "run_fast_unfused", f"{mode}: not the unfused path")
        runs[f"n62500_f32_cap512_{mode}"], ends[mode] = _production_run(
            torch, f"n62500_f32_cap512_{mode}", cfg, state, tmp, (kernel,),
            tuple(k for k in MAIN_KERNELS if k != kernel), engine=eng)
    cfg64 = cfg.replace(dtype="float64")
    s64 = ends["full9"].to(dtype=torch.float64)
    ref_eng = pe._cellpair_engine(cfg64, DEVICE, width_lists=False)
    ref = ref_eng.get_state(ref_eng.run_fast(ref_eng.init(s64)[0], CROSS_STEPS))
    cross = {}
    for mode, (kw, _) in modes.items():
        eng = pe._cellpair_engine(cfg64, DEVICE, inner_chunk=FULL_SWEEP_CHUNK, **kw)
        c = eng.run_fast(eng.init(s64)[0], CROSS_STEPS)
        require(not bool(c.overflow), f"{mode} float64: pencil_overflow set")
        cross[mode] = _cross_diff(torch, eng.get_state(c), ref, cfg.box_length)
        log(f"cellpair {mode} vs half shell (N={cfg.n}, capacity {FULL_SWEEP_CAP}, float64, "
            f"{CROSS_STEPS} steps from one state): max rel diff over r, ru, v, a "
            f"{cross[mode]:.3e} (tol {CROSS_TOL:.0e})")
        require(cross[mode] <= CROSS_TOL, f"cellpair {mode} and the half shell disagree")
    LAUNCHES.reset()
    return runs, cross


def phase_multidevice(torch, tmp: str) -> tuple[dict, dict, dict, dict]:
    """The particle-sharded engines through ``run_production`` on thread
    meshes on the card (module docstring, 9b). Returns (runs, float64 cross
    diffs, drifts beside the single-card engines', {config: (cfg,
    post-warmup state)} for the rates)."""
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.entry import dryrun_multichip
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.models.simulation import initialize, run_production
    from ljmd_tpu_torch.ops._cuda import LAUNCHES
    from ljmd_tpu_torch.ops.cell_list import capacity_from_state
    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.parallel.spatial import make_spatial_engine
    from ljmd_tpu_torch.parallel.spatial_pencil import (
        default_inner_chunk,
        make_sharded_pencil_engine,
    )

    def others(*need):
        return tuple(k for k in MAIN_KERNELS if k not in need)

    def cross_check(name, cfg, state, make, ref_engine):
        """CROSS_STEPS fast steps in float64 from one state: the sharded
        engine against the single-card one, within CROSS_TOL. The two sum
        each particle's forces in another order (the hops, the halo's
        reactions) and nothing else differs, so ~1e-16 a step grown by the
        fluid's chaos stays near 1e-13 over 100 steps, while one pair lost
        or doubled at a block or strip edge moves a velocity by ~1e-3."""
        cfg64 = cfg.replace(dtype="float64")
        s64 = state.to(dtype=torch.float64)
        eng, ref = make(cfg64), ref_engine(cfg64)
        c = eng.run_fast(eng.init(s64)[0], CROSS_STEPS)
        flags = {k: bool(v) for k, v in eng.diagnostics(c).items()}
        require(not any(flags.values()), f"{name} float64: {flags}")
        want = ref.get_state(ref.run_fast(ref.init(s64)[0], CROSS_STEPS))
        diff = _cross_diff(torch, eng.get_state(c), want, cfg.box_length)
        log(f"{name} vs the single-card engine (N={cfg.n}, float64, {CROSS_STEPS} steps from "
            f"one state): max rel diff over r, ru, v, a {diff:.3e} (tol {CROSS_TOL:.0e})")
        require(diff <= CROSS_TOL, f"{name} and the single-card engine disagree")
        return diff

    def drift_of(cfg, state, engine):
        res = run_production(cfg, state, engine=engine, device=DEVICE)
        flags = {k: bool(v) for k, v in res.diagnostics.items()}
        require(not any(flags.values()), f"drift run: diagnostic flag set: {flags}")
        return _drift(res.series[2].cpu())

    def drift_beside(name, cfg, state, make, single, limit):
        """The sharded drift (the production's, then from each further
        seed's own warmup) beside the single-card engine's on the same cut
        and state; at most ``limit`` times the latter."""
        out = []
        for k in range(DRIFT_SEEDS):
            c = cfg.replace(seed=cfg.seed + k)
            st = state if k == 0 else initialize(c, backend="rows", device=DEVICE)
            sharded = runs[name]["drift"] if k == 0 else drift_of(c, st, make(c))
            out.append({"seed": c.seed, "sharded": sharded, "single": drift_of(c, st, single(c))})
        log(f"{name}: |dE/E| over the same {cfg.total_steps}-step cut from the same state, "
            "sharded vs single card: " + ", ".join(
                f"seed {x['seed']} {x['sharded']:.3e} vs {x['single']:.3e}" for x in out)
            + f" (limit {limit}x)")
        for x in out:
            require(x["sharded"] <= limit * x["single"],
                    f"{name}: seed {x['seed']} drifts {x['sharded']:.3e}, over {limit}x the "
                    f"single-card engine's {x['single']:.3e} on the same cut")
        return out

    runs, cross, drifts, states = {}, {}, {}, {}
    n4000 = load_config(str(REPO / "examples" / "n4000_production.json")).replace(
        **MULTI_N4000_CUT)
    state = initialize(n4000, backend="rows", device=DEVICE)
    states["n4000"] = (n4000, state)
    for comm, d, need in (("half_ring", 4, ("pair_sweep_tri", "pair_sweep_rect_newton")),
                          ("ring", 2, ("pair_sweep_rect",))):
        name = f"n4000_f32_{comm}_d{d}"
        mesh = make_mesh(particle=d, device=DEVICE)
        try:
            runs[name], _ = _production_run(torch, name, n4000, state, tmp, need, others(*need),
                                            engine=make_spatial_engine(n4000, mesh, comm=comm))
            cross[name] = cross_check(name, n4000, state,
                                      lambda c: make_spatial_engine(c, mesh, comm=comm),
                                      lambda c: pe._rows_engine(c, DEVICE))
            drifts[name] = drift_beside(name, n4000, state,
                                        lambda c: make_spatial_engine(c, mesh, comm=comm),
                                        lambda c: pe._rows_engine(c, DEVICE),
                                        DRIFT_VS_SINGLE["float32"])
        finally:
            mesh.close()

    ref = load_config(str(REPO / "examples" / "reference_default.json")).replace(**MULTI_REF_CUT)
    state = initialize(ref, backend="rows", device=DEVICE)
    name = "reference_default_f32_compensated_half_ring_d2"
    mesh = make_mesh(particle=2, device=DEVICE)
    try:
        eng = make_spatial_engine(ref, mesh)
        carry, _ = eng.init(state)
        require(all(isinstance(x, tuple) and len(x) == 3 for x in carry),
                f"{name}: the float32 dt=1e-4 carry holds no compensation terms")
        runs[name], _ = _production_run(torch, name, ref, state, tmp,
                                        ("pair_sweep_tri", "pair_sweep_rect_newton"),
                                        others("pair_sweep_tri", "pair_sweep_rect_newton"),
                                        engine=eng)
        drifts[name] = drift_beside(name, ref, state, lambda c: make_spatial_engine(c, mesh),
                                    lambda c: pe._rows_engine(c, DEVICE),
                                    DRIFT_VS_SINGLE["compensated"])
    finally:
        mesh.close()

    cfg5 = load_config(str(REPO / "examples" / "n62500_large.json")).replace(**MULTI_N62500_CUT)
    state = initialize(cfg5, backend="auto", device=DEVICE)
    cfg5 = cfg5.replace(neighbor_capacity=capacity_from_state(
        cfg5.box_length, cfg5.rc + cfg5.neighbor_skin, state.r))
    states["n62500"] = (cfg5, state)
    name = f"n62500_f32_sharded_pencil_d{STRIP_D}"
    top = float(torch.sqrt((state.v.double() ** 2).sum(dim=1)).max())
    mesh = make_mesh(particle=STRIP_D, device=DEVICE)
    try:
        runs[name], _ = _production_run(
            torch, name, cfg5, state, tmp, ("pencil_sweep_hs",), others("pencil_sweep_hs"),
            engine=make_sharded_pencil_engine(cfg5, mesh))
        cross[name] = cross_check(
            name, cfg5, state, lambda c: make_sharded_pencil_engine(c, mesh),
            lambda c: pe._cellpair_engine(c, DEVICE, use_fused=False, inner_chunk=8))
    finally:
        mesh.close()
    log(f"{name}: capacity {cfg5.neighbor_capacity} (the post-warmup census), "
        f"{cfg5.n} particles on {STRIP_D} strips of 7x14 pencils; the engine's default chunk "
        f"from the production's first state {default_inner_chunk(cfg5, top)} steps between "
        f"rebins (top speed {top:.4f}; set anew at each run_fast)")

    LAUNCHES.reset()
    t0 = time.time()
    dryrun_multichip(4)
    log(f"dryrun_multichip(4) on the card: {time.time() - t0:.2f}s")
    LAUNCHES.reset()
    return runs, cross, drifts, states


def phase_multidevice_rates(torch, states: dict) -> dict:
    """Fast-step rates (host clock after a synchronize) of the sharded
    engines on thread meshes of 1, 2 and 4 ranks on the one card, beside the
    single-card engines from the same state: what the decomposition costs on
    one card, not scaling (the ranks share the card and one stream). Each
    run's diagnostic flags must stay clear. Then the host's share: one
    thread-mesh hand-off (a psum of one number) at each rank count, and one
    small launch."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops._cuda import LAUNCHES
    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.parallel.spatial import make_spatial_engine
    from ljmd_tpu_torch.parallel.spatial_pencil import make_sharded_pencil_engine

    def rate(name, cfg, eng, state, steps):
        c = eng.run_fast(eng.init(state)[0], 8)
        torch.cuda.synchronize()
        t0 = time.time()
        c = eng.run_fast(c, steps)
        torch.cuda.synchronize()
        out = cfg.n * steps / (time.time() - t0)
        flags = {k: bool(v) for k, v in eng.diagnostics(c).items()}
        require(not any(flags.values()), f"rate run {name}: diagnostic flag set: {flags}")
        return out

    out = {}
    cfg, state = states["n4000"]
    out["n4000 rows (1 card)"] = rate("rows", cfg, pe._rows_engine(cfg, DEVICE), state,
                                      RATE_STEPS)
    for d in (1, 2, 4):
        mesh = make_mesh(particle=d, device=DEVICE)
        try:
            key = f"n4000 half_ring d={d}"
            out[key] = rate(key, cfg, make_spatial_engine(cfg, mesh), state, RATE_STEPS)
        finally:
            mesh.close()
    cfg, state = states["n62500"]
    out["n62500 cellpair (1 card)"] = rate("cellpair", cfg, pe._cellpair_engine(cfg, DEVICE),
                                           state, RATE_PENCIL_STEPS)
    for d in (1, 2, 7):
        mesh = make_mesh(particle=d, device=DEVICE)
        try:
            key = f"n62500 sharded_pencil d={d}"
            out[key] = rate(key, cfg, make_sharded_pencil_engine(cfg, mesh), state,
                            RATE_PENCIL_STEPS)
        finally:
            mesh.close()
    LAUNCHES.reset()
    for k, v in out.items():
        log(f"multi-device rate {k}: {v:.4e} particle-steps/s (float32, fast steps)")

    def handoffs(comm, x):
        for _ in range(HANDOFF_REPS):
            x = comm.psum(x)
        return x

    x = torch.zeros((), device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(HANDOFF_REPS):
        x = x + 1.0
    torch.cuda.synchronize()
    host = {"launch_ms": 1e3 * (time.time() - t0) / HANDOFF_REPS}
    for d in (1, 2, 4):
        mesh = make_mesh(particle=d, device=DEVICE)
        try:
            mesh.run(handoffs, [x] * d)
            torch.cuda.synchronize()
            t0 = time.time()
            mesh.run(handoffs, [x] * d)
            torch.cuda.synchronize()
            host[f"psum_ms d={d}"] = 1e3 * (time.time() - t0) / HANDOFF_REPS
        finally:
            mesh.close()
    log("host share on this call's host: one small launch "
        f"{host['launch_ms']:.4f} ms; one thread-mesh psum (every rank's turn) "
        + ", ".join(f"{k.split()[1]} {v:.4f} ms" for k, v in host.items() if k != "launch_ms"))
    out["host"] = host
    return out


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
    # The unfused path at the fused chunks' 8 steps between rebins, at its
    # default (sized from the fluid's top speed: it must not flag) and at
    # JAX's fixed 12, where the fastest particles of this fluid may outrun
    # the coverage slack (0.25 in xy) between two rebins, which the engine
    # flags (as the JAX engine does): that run is timed and its flag
    # recorded, but it is not compared.
    paths = {"fused_static": {"width_lists": False}, "fused_width": {"width_lists": True},
             "unfused": {"use_fused": False, "inner_chunk": 8},
             "unfused_default": {"use_fused": False},
             "unfused_chunk12": {"use_fused": False, "inner_chunk": 12}}
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
    """The rows engine on config 5 (N=62500: the dense chunk's persistent
    grid, 1956 tiles over the blocks the card holds): from ``state`` in
    float64, ROWS62500_STEPS fused steps against the unfused cell-pair
    engine at the same chunk, within CROSS_TOL (summation order only); then
    its float32 ms per step over ROWS62500_STEPS after one untimed chunk."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    k = ROWS62500_STEPS
    cfg64 = cfg.replace(dtype="float64")
    s64 = state.to(dtype=torch.float64)
    rows = pe.make_engine(cfg64, "rows", dev)
    c = rows.init(s64)[0]
    torch.cuda.synchronize()
    t0 = time.time()
    c = rows.run_fast(c, k)
    torch.cuda.synchronize()
    out = {"f64_ms_per_step": 1e3 * (time.time() - t0) / k}
    cp = pe._cellpair_engine(cfg64, dev, use_fused=False, inner_chunk=k)
    cc = cp.run_fast(cp.init(s64)[0], k)
    require(not bool(cc.overflow), "rows vs cellpair at N=62500: pencil_overflow set")
    out["f64_vs_cellpair"] = _cross_diff(torch, rows.get_state(c), cp.get_state(cc),
                                         cfg.box_length)
    require(out["f64_vs_cellpair"] <= CROSS_TOL,
            f"rows and the unfused cell-pair engine disagree at N={cfg.n}: "
            f"{out['f64_vs_cellpair']:.3e} > {CROSS_TOL}")
    rows32 = pe.make_engine(cfg, "rows", dev)
    c = rows32.run_fast(rows32.init(state)[0], k)
    torch.cuda.synchronize()
    LAUNCHES.reset()
    t0 = time.time()
    c = rows32.run_fast(c, k)
    torch.cuda.synchronize()
    out["f32_ms_per_step"] = 1e3 * (time.time() - t0) / k
    out["f32_launches"] = {n: v for n, v in LAUNCHES.snapshot().items() if v}
    require(out["f32_launches"].get("fused_dense_chunk", 0) == 1,
            "rows at N=62500: one fused chunk expected")
    require(bool(torch.isfinite(c.v).all()), "rows at N=62500 float32: non-finite velocities")
    LAUNCHES.reset()
    log(f"rows at N={cfg.n} (config 5, persistent grid): float64 {k} fused steps vs the "
        f"unfused cell-pair engine max rel diff over r, ru, v, a {out['f64_vs_cellpair']:.3e} "
        f"(tol {CROSS_TOL:.0e}), {out['f64_ms_per_step']:.3f} ms/step; float32 "
        f"{out['f32_ms_per_step']:.3f} ms/step")
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

    from ljmd_tpu_torch.config import load_config

    env = phase_environment(torch)
    phase_build()
    cases = phase_kernels(torch)
    cases.update(phase_rect_kernels(torch))
    cases.update(phase_list_kernels(torch))
    cases.update(phase_flags_kernel(torch))
    cases.update(phase_probe_kernels(torch))
    cases.update(phase_layout_kernels(torch))
    with tempfile.TemporaryDirectory(prefix="ljmd_chip_smoke_") as tmp:
        runs, final_cfg, final_state = phase_main_path(torch, tmp)
        cp_runs, cfg5, states5 = phase_cellpair_path(torch, tmp)
        runs["flagship_entry_f32"], flagship_cross = phase_flagship(torch)
        runs["n4000_f32_rows_ordered"], ordered_cross = phase_rows_ordered(torch, tmp)
        n4000 = load_config(str(REPO / "examples" / "n4000_production.json")).replace(**N4000_CUT)
        runs["n4000_f32_neighbor"] = _cli_run("n4000_f32_neighbor", n4000, "neighbor", tmp, (),
                                              MAIN_KERNELS)
        full_runs, full_cross = phase_full_sweeps(torch, cfg5, states5["cap512_end"], tmp)
        multi_runs, multi_cross, multi_drifts, multi_states = phase_multidevice(torch, tmp)
    multi_rates = phase_multidevice_rates(torch, multi_states)
    exp_runs = phase_experiments(torch)
    runs.update(cp_runs)
    runs.update(exp_runs)
    runs.update(full_runs)
    runs.update(multi_runs)
    state5 = states5["cap512_end"]
    # A third stretch of the fluid: the capacity-512 run's end with the
    # velocities reversed (it retraces the stretch before it).
    states5["cap512_end_reversed"] = dataclasses.replace(state5, v=-state5.v)
    cases.update(phase_pencil_kernels(torch, cfg5, state5))
    paths = phase_chunk_paths(torch, cfg5, states5)
    rows62500 = phase_rows_at_62500(torch, cfg5, state5)
    vs_rows = phase_engines_vs_rows(torch, final_cfg, final_state)
    series_err = phase_card_vs_cpu(torch)

    # Headline shape per kernel: where the main path runs it at full size;
    # every case is listed beside it.
    headline = {"lj_pair_terms": ("N=4000", "float32"),
                "pair_sweep_tri": ("N=4000", "float32"),
                "pair_sweep": ("N=4000", "float32"),
                "fused_dense_chunk": ("N=4000", "float32"),
                "fused_dense_chunk_ext": ("N=500", "float32"),
                "build_window_lists": ("N=4000", "float32"),
                "fused_dense_chunk_list": ("N=4000", "float32"),
                "pencil_sweep_hs": ("N=62500 cap=512", "float32"),
                "fused_pencil_chunk": ("N=62500 cap=384", "float32"),
                "fused_pencil_width_chunk": ("N=62500 cap=512", "float32"),
                "pencil_sweep_full": ("N=62500 cap=512", "float32"),
                "pencil_sweep_zband": ("N=62500 cap=512", "float32"),
                "pair_sweep_rect": ("N=4000 d=2 hop", "float32"),
                "pair_sweep_rect_newton": ("N=4000 d=4 hop", "float32"),
                "fused_dense_chunk_flags": ("N=4000 tile_j=512 real", "float32"),
                "mosaic_probes": ("t8n", "float32"),
                "layout_bodies": ("k1-512 v=128 L=16.796", "float32")}
    meta = {
        "lj_pair_terms": ("ljmd_tpu_torch/csrc/lj_pair_terms.cuh", "ljmd_tpu/ops/pallas_common.py:17"),
        "pair_sweep_tri": ("ljmd_tpu_torch/csrc/pair_sweep_tri.cu", "ljmd_tpu/ops/pallas_lj.py:240"),
        "pair_sweep": ("ljmd_tpu_torch/csrc/pair_sweep.cu", "ljmd_tpu/ops/pallas_lj.py:103"),
        "fused_dense_chunk": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:537"),
        "fused_dense_chunk_ext": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:465"),
        "build_window_lists": ("ljmd_tpu_torch/csrc/pack_window_lists.cu", "ljmd_tpu/ops/pallas_fused.py:803"),
        "fused_dense_chunk_list": ("ljmd_tpu_torch/csrc/fused_dense_chunk_list.cu", "ljmd_tpu/ops/pallas_fused.py:1383"),
        "pencil_sweep_hs": ("ljmd_tpu_torch/csrc/pencil_sweep_hs.cu", "ljmd_tpu/ops/pallas_pencil2.py:187"),
        "fused_pencil_chunk": ("ljmd_tpu_torch/csrc/fused_pencil_chunk.cu", "ljmd_tpu/ops/pallas_pencil_fused.py:277"),
        "fused_pencil_width_chunk": ("ljmd_tpu_torch/csrc/fused_pencil_chunk.cu", "ljmd_tpu/ops/pallas_pencil_fused.py:609"),
        "pencil_sweep_full": ("ljmd_tpu_torch/csrc/pencil_sweep_full.cu", "ljmd_tpu/ops/pallas_pencil.py:309"),
        "pencil_sweep_zband": ("ljmd_tpu_torch/csrc/pencil_sweep_zband.cu", "ljmd_tpu/ops/pallas_pencil.py:256"),
        "pair_sweep_rect": ("ljmd_tpu_torch/csrc/pair_sweep_rect.cu", "ljmd_tpu/ops/pallas_lj.py:364"),
        "pair_sweep_rect_newton": ("ljmd_tpu_torch/csrc/pair_sweep_rect.cu", "ljmd_tpu/ops/pallas_lj.py:533"),
        "fused_dense_chunk_flags": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:384"),
        "mosaic_probes": ("ljmd_tpu_torch/csrc/mosaic_probes.cu", "scripts/exp_mosaic_support.py:65"),
        "layout_bodies": ("ljmd_tpu_torch/csrc/layout_bodies.cu", "scripts/exp_layout.py:127"),
    }
    launches = dict.fromkeys(MAIN_KERNELS, 0)
    for run in runs.values():
        for k in launches:
            launches[k] += run["launches"].get(k, 0)
    # lj_pair_terms is a __device__ function with no launch of its own on the
    # main path: it runs inside every sweep and chunk launch, so its count is
    # theirs (its own element-wise kernel runs only in the comparison).
    launches["lj_pair_terms"] = sum(launches[k] for k in MAIN_KERNELS
                                    if k not in ("build_window_lists", "mosaic_probes"))
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
            # Verlet chunk or a greedy visit-list cover; the probes stand for
            # library operations (ITERS calls of each, probe_library).
            "library_ms": head.get("library_ms"),
            "timed_at": f"{head['shape']} {head['dtype']}",
            "launches_by_run": {run: r["launches"][name] for run, r in runs.items()
                                if r["launches"].get(name, 0)},
            "cases": cases[name],
        }
        if name == "lj_pair_terms":
            entry["launches_counted_as"] = "launches of the kernels that inline it"
        if name == "layout_bodies":
            entry["also_replaces"] = "scripts/exp_layout.py:308 and :324 (transposes)"
            entry["slopes_ns_per_visit"] = {k: 1e9 * v for k, v in
                                            runs["exp_layout"]["result"].items()}
        if name == "pencil_sweep_hs":
            # The mono kernel, n_pencils_i included: the strip cases (the
            # sharded pencil engine's launches are counted here too).
            entry["also_replaces"] = "ljmd_tpu/ops/pallas_pencil2.py:394"
            strip = next(c for c in cases[name]
                         if c.get("n_pencils_i") and c["dtype"] == "float32"
                         and c["shape"].startswith("N=62500 cap=384") and not c["observables"])
            entry["strip"] = {k: strip[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "max_abs_err")}
            entry["strip"]["launches_sharded_run"] = runs[
                f"n62500_f32_sharded_pencil_d{STRIP_D}"]["launches"]["pencil_sweep_hs"]
        kernels.append(entry)
    log(f"main path runs: {json.dumps(runs)}")
    for n_label, rows_run, zsort_run in (("N=4000", "n4000_f32", "n4000_f32_zsort"),
                                         ("N=864", "n864_f32", "n864_f32_zsort")):
        r_rate = runs[rows_run]["particle_steps_per_s"]
        z_rate = runs[zsort_run]["particle_steps_per_s"]
        log(f"production {n_label} float32 on {env['nvidia_smi']}: zsort {z_rate:.4e} "
            f"particle-steps/s, rows {r_rate:.4e} (zsort / rows {z_rate / r_rate:.3f})")
    for name in list(cp_runs) + list(full_runs):
        log(f"production N=62500 on {env['nvidia_smi']}: {name} "
            f"{runs[name]['particle_steps_per_s']:.4e} particle-steps/s")
    for name in ("flagship_entry_f32", "n4000_f32_rows_ordered", "n4000_f32_neighbor", "n4000_f32",
                 "n4000_f32_zsort"):
        log(f"N=4000 float32 on {env['nvidia_smi']}: {name} "
            f"{runs[name]['particle_steps_per_s']:.4e} particle-steps/s")
    for name in multi_runs:
        log(f"multi-device production on {env['nvidia_smi']}: {name} "
            f"{runs[name]['particle_steps_per_s']:.4e} particle-steps/s")
    host = multi_rates.pop("host")
    log(f"multi-device on {env['nvidia_smi']}: float64 cross checks "
        + ", ".join(f"{k} {v:.3e}" for k, v in multi_cross.items()) + "; fast-step rates "
        + ", ".join(f"{k} {v:.4e}" for k, v in multi_rates.items()) + "; host share "
        + ", ".join(f"{k} {v:.4f}" for k, v in host.items()) + "; |dE/E| sharded vs single "
        "card " + "; ".join(f"{k}: " + ", ".join(f"seed {x['seed']} {x['sharded']:.3e} vs "
                                                 f"{x['single']:.3e}" for x in v)
                            for k, v in multi_drifts.items()))
    log(f"card {env['nvidia_smi']}; zsort-vs-rows rel diff {vs_rows['zsort']:.3e}; "
        f"cellpair-vs-rows rel diff {vs_rows['cellpair']:.3e}; chunk paths "
        + ", ".join(f"{k} width {max(p['fused_width']['rel_diff_to_fused_static'].values()):.3e}"
                    f" unfused {max(p['unfused']['rel_diff_to_fused_static'].values()):.3e}"
                    f" planted {max(p['planted_fault']['rel_diff_to_fused_static'].values()):.3e}"
                    for k, p in paths.items())
        + f"; rows at N=62500 vs cellpair (float64) {rows62500['f64_vs_cellpair']:.3e}, "
        f"float32 {rows62500['f32_ms_per_step']:.3f} ms/step; card-vs-CPU series rel diff "
        f"{series_err:.3e}; "
        f"float64 cross checks: flagship step vs rows {flagship_cross:.3e}, rows ordered vs "
        f"tri {ordered_cross:.3e}, full9 vs half shell {full_cross['full9']:.3e}, zband vs half "
        f"shell {full_cross['zband']:.3e}")
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
