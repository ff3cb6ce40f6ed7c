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
      float32 and float64; the dense chunk's launch shape (threads a
      particle, work items, resident or streamed positions, blocks and warps
      an SM) and its share of the bound;
   b. the zsort path's kernels at the zsort engine's own geometry for
      ``examples/n4000_production.json`` (n_pad 4096) and
      ``examples/n864_liquid.json`` (n_pad 896): the visit-list pack on the
      flags of a z-sorted fluid and on random flags (lists compared exactly;
      timed back to back and by CUDA-graph replay of the whole call, whose
      device operations, the nodes of one call captured in a CUDA graph,
      must be the kernel alone, and which the profiler must see as at most
      one a call),
      the fused list chunk in its plain, ``obs_last`` and extended modes,
      float32 and float64;
   c. the cell-pair path's kernels at BASELINE config 5's geometry
      (``examples/n62500_large.json``, 14x14 pencils) on the post-production
      fluid of phase 4c, at capacity 512 (the lattice's) and 384 (the
      post-warmup census), float32 and
      float64: the half-shell sweep with and without observables, the fused
      pencil chunk and the width-listed chunk, each plain and extended (the
      width chunk with its launch shape, its per-block visit index's size,
      build time and device operations, and the busiest block's staged
      chunks beside the mean); the
      full 9-neighbour sweep with and without observables (with its launch
      shape and, modelled from the run's slots in the log, the partner
      stages kept and skipped and the cull's body share); at capacity 512
      the z-banded sweep (window 384), against its twin and against the full
      sweep;
   d. (in a.) the ordered N x N sweep at N=500 (n < n_pad) and N=4000, with
      and without observables, with its launch shape, back to back and on
      the card alone, and the (N, 3) force API around it; its rows 0..2
      against the tri sweep's on the same positions (N=4000, 500, 864, both
      precisions, observables on and off), logged bit-identical or not with
      both kernels' S; the
      dense chunk (and in b. the list chunk) with its persistent grid capped
      at 4 tiles a block, bit-equal to the full grid;
   e. the flag-gated dense chunk (kernel 8) on the experiments' melted
      N=4000 fluid, float32 and float64, plain and extended: the fluid's
      flags at tile_j 512 ... 4096, and all-zero, all-3 (bit-equal to the
      unflagged chunk) and random 0/1 flags at 512, with its launch shape;
   f. the nine layout probes (kernel 17) at N=4096, 200 iterations, back to
      back and on the card alone (CUDA-graph replay), beside 200 calls of the
      library operation each stands for (both ways); each probe's 1,000
      iterations must take at least 1.5x its 200 on the card alone (a loop
      the compiler cut short takes about 1x);
   g. the pair-tile layout bodies (kernel 18) over 128 visits at N_PAD=4096
      in the experiment's box and in a box of L = 8 (where the forces move
      r past float32's resolution), k5c also with 64 visits in its masked
      loop, each body back to back and on the card alone (also at 32
      visits: the slope per visit-step) with its launch plan, and the
      transpose glue;
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
      steps) on the N=4000 cut; then from one float64 state against
      ``triangular=True``: the series within 1e-9 over the whole 5,000-step
      cut where 3d found the two kernels' forces bit-identical, else over
      100 steps, each sampled;
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
6. rows at config 5 (N=62500, the dense chunk's persistent grid, positions
   streamed): float64, 8 fused steps against the unfused cell-pair engine
   within 1e-9, and its float32 ms per step, with the launch shapes;
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
      and float64, on a shuffled lattice (every block pair has pairs in
      the cutoff) and, for kernel 7 with its launch shape, in lattice
      order (a rank's rows a slab, as in production); the tri sweep
      (kernel 2) at the half ring's self blocks; their time as back-to-back
      calls (``ms``, as every kernel's) and, since the host's call takes
      longer than a hop's kernel, on the card alone by CUDA-graph replay
      (``card_ms``); and (in 3c) the
      half-shell sweep's ``n_pencils_i`` on
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
      thread-mesh hand-off at 1, 2 and 4 ranks and of one small launch;
10. the analysis pipeline at BASELINE config 3 (``examples/n4000_production.json``
    cut to 20,000 steps, warmup 1,000, interval 50: 380 frames): the CLI's
    ``simulate --stream`` on the card (``auto`` -> zsort, the native writer),
    then ``analyze --no-plots --device cuda``; in process on the same
    rva.dat, ``compute_msd``, ``compute_vacf`` and ``compute_rdf`` on the
    card (CUDA-event ms) against the same functions on the CPU, and the
    card's analysis_summary.json against ``analyze_run`` on the CPU, each
    within 1e-10 of the scale (float64); D_einstein and D_green_kubo logged;
11. streaming kill-and-resume at config 5 (N=62500 cut as in 4c, ``auto`` ->
    cellpair): ``init-config`` once; from its rv_init.dat B (in-memory
    ``simulate``), A (``simulate --stream --chunk-samples 2``) and C (A's
    command in another directory, SIGKILLed as soon as its first checkpoint
    exists, then run again to the end); C must die mid-run (return code -9,
    checkpoint sample in (0, 15)) and resume its carry verbatim, A, B and C's
    rva.dat, instantaneous_energies.dat, corr / corrmean files, means.dat,
    md_final_results.txt and summary.json must be equal byte for byte, no
    checkpoint may be left, the flags clear, the native writer used; logs A's
    and B's rates, checkpoint MB and ms a chunk, rva.dat MB/s, and the
    cell-pair kernels' launches in A and in the warmup.
12. the replica ensemble at BASELINE config 4 (``examples/ensemble64.json``:
    R=64 replicas of N=256, 10,000 steps, float32; ``auto`` -> the rows
    engine batched over the replicas):
    a. the replica launches of kernels 2 and 3 at R=64, N=256 (float32 and
       float64) and of kernel 4 at R=8, N=500 (dt=1e-4) against their
       batched twins, replicas 0, 31 and 63 against one-replica launches bit
       for bit, a planted NaN kept in its replica, kernel 3 under a capped
       grid; each timed against the R one-replica launches it replaces
       (kernel 2 also on the card alone);
    b. ``ensemble --config examples/ensemble64.json`` through the CLI: 64/64
       ok, the artifacts parsed, only replica launches; the same run in
       process (its artifacts byte-equal to the CLI's), the replicas'
       median |dE/E| <= 1e-3 and the worst within 3x the worst of the same
       ensemble run in float64, replicas 0 and 63 against one-replica
       ``run_production`` from their states (states bit for bit, series and
       means within 1e-6);
    c. the replica loop against the batched engine from the same states on a
       2,000-step cut: both rates, final states bit-equal;
    d. ``--stream --chunk-samples 32``: artifacts byte-equal to (b)'s, the
       correlation stage's peak device memory within 1.5x one replica
       group's lag products;
    e. the N=864 ensemble (``auto`` -> zsort, batched) cut to
       2,000 steps: at R=8 the replica loop over one-system zsort engines
       (the yardstick: kernels 9 and 10 launched R times one replica's
       count, 8/8 ok, its rate) and the batched engine from the same states
       (final states bit-equal to the loop's); at R=64 through the CLI
       (64/64 ok, no flag set, only the replica launches of kernels 9 and
       10) and in process (replica 0 bit-equal to its one-system zsort run),
       its rate against the loop's; the reference default in float32
       (compensated: kernel 4's replica launch) as an R=8 ensemble cut to
       2,000 steps;
    f. ``--per-run-dirs`` at R=4 on the cut: run_XXXX/ and several_runs.txt;
    and for the replica axis:
    a'. the replica launches of kernel 7 at R=8 on the half ring's d=4 hop
       (1000 x 1000 of N=4000) and at R=32 on config 4's d=2 half hop (128
       rows a rank), of kernel 6 at R=8 on the ring's 2000 x 2000 hop and at
       R=32 on config 4's d=2 ring (the rank's self block, where gi0 = gj0,
       and the visiting block), of kernel 2 at R=32 on config 4's 128-row
       self block, of kernels 9 and 10 at R=64 on config 2's N=864 (kernel
       10 plain and extended), float32 and float64: against their twins,
       replicas 0, mid
       and last against one-replica launches bit for bit, a planted NaN (the
       pack: planted flags) kept in its replica, kernel 10 under a capped
       grid; each timed against its R one-replica launches (``loop_ms``;
       kernels 6, 7 and 9 also on the card alone);
    g. config 4 through the replica x particle half-ring step
       (``make_ensemble_spatial_step_fn``) on a (replica=2, particle=2)
       thread mesh, cut to 2,000 steps: only replica launches, replicas 0 /
       31 / 63 bit-equal to ``make_spatial_step_fn`` on a 2-rank mesh run on
       each alone, the drift (median under 1e-3, the worst within 3x the
       batched rows engine's worst on the same cut), the aggregate rate and
       ms a step, float64 against the batched rows engine over 100 steps
       (1e-9); 200 steps of the ring (kernel 6's replica launch), its
       replicas 0 / 31 / 63 bit-equal to ``make_spatial_engine(comm="ring")``
       on a 2-rank mesh run on each alone;
       ``dryrun_multichip(4)`` (9b) runs the same step on a (2, 2) mesh.

The build (phase 2) also builds the native trajectory library
(``utils/native.py``) with the host's C++ compiler.

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
    "ensemble64_f32_rows_batched": 1e-3,  # the replicas' median (ENSEMBLE_DRIFT_VS_F64)
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
# Kernel 2 also at config 2's box (rows and zsort sample N=864 with it).
TRI_SHAPES = SHAPES + [("N=864", 6, 10.077577148295, 0.248075501007 * 10.077577148295)]
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
# k5c's masked loop also runs with this many of the visits (the experiment
# keeps 0), and the probes' gate: 5 x ITERS iterations on the card alone take
# at least this multiple of ITERS'.
LAYOUT_MASKED = 64
PROBE_SCALING = 1.5
EXPERIMENT_KERNELS = ("fused_dense_chunk_flags", "mosaic_probes", "layout_bodies")
# Phase 6: rows on config 5 against the unfused cell-pair engine.
ROWS62500_STEPS = 8
# The dense, list and width chunks' persistent grid capped for the bit check:
# each block takes this many work items (dense: 256 / S particles; list: 32
# particles; width: 128 slots).
TILES_PER_BLOCK = 4
ZSORT_KERNELS = ("build_window_lists", "fused_dense_chunk_list")
# The pack's calls under the profiler, for its reading of device operations.
PROFILED_CALLS = 20
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
# Phase 10: BASELINE config 3, examples/n4000_production.json cut to 20,000
# steps with a 1,000-step warmup (interval 50 kept: 380 frames, a 146 MB
# rva.dat); card against CPU analysis, float64: only the summation order
# differs (~1e-15 of each array's scale).
ANALYSIS_CUT = {"total_steps": 20_000, "warmup_steps": 1_000}
ANALYSIS_TOL = 1e-10
# Phase 11: the streaming run's chunk (15 samples: 8 chunks, 8 checkpoints).
KILL_CHUNK = 2
# Phase 12: BASELINE config 4 (examples/ensemble64.json: R=64 replicas of
# N=256, L=6.84, rc=2.5, dt=0.005, 10,000 steps, interval 20, float32; auto ->
# the rows engine, batched over the replicas). Kernels 2 and 3 at its shape
# (the chunk over the 19 unsampled steps of a cycle), kernel 4 at the
# reference default's (R=8, N=500, dt=1e-4: its compensated path; 99 steps);
# the replicas checked bit for bit against one-replica launches. The loop
# and per-run cuts keep its warmup (so its initial states); the N=864
# ensemble (examples/n864_liquid.json, auto -> zsort: the replica loop) at
# R=8, cut as phase 4's N=864 run is, to 2,000 steps.
ENSEMBLE_BIT_REPLICAS = (0, 31, 63)
ENSEMBLE_EXT_R = 8
ENSEMBLE_CUT = {"total_steps": 2_000}
ENSEMBLE_SINGLE_REPLICAS = (0, 63)
ENSEMBLE_ZSORT_R = 8
ENSEMBLE_ZSORT_CUT = {"total_steps": 2_000, "warmup_steps": 1_000}
ENSEMBLE_PER_RUN_R = 4
# Kernel 4's replica launch on the main path: the reference default in
# float32 (N=500, dt=1e-4: compensated) as an R=8 ensemble, cut as phase 9's
# compensated run is.
ENSEMBLE_EXT_CUT = {"total_steps": 2_000, "warmup_steps": 500, "dtype": "float32"}
# Config 4's drift: the replicas' median |dE/E| under DRIFT_BOUND, and the
# worst replica under ENSEMBLE_DRIFT_VS_F64 x the worst of the same ensemble
# in float64 (its own init, the same generators; experiments/ensemble_drift.py,
# which also runs it compensated and at half the dt). The worst of 64
# endpoint differences is set by the truncated potential's cutoff crossings
# at N=256, not by the integrator: on the H100 (700 W) float64 reached
# 1.147e-3 at dt=0.005 and 1.584e-3 at dt=0.0025 over the same time (1 and 4
# of 64 replicas over 1e-3), float32 1.236e-3 (2 of 64), compensated float32
# 1.198e-3, all with medians 3.0-3.5e-4; a precision loss would lift the
# float32 ensemble over the float64 one, as DRIFT_VS_SINGLE's 3x does for
# the sharded engines.
ENSEMBLE_DRIFT_VS_F64 = 3.0
# Replica q of the batched run against a one-replica run from its state:
# the states bit for bit; the series and means to the rounding of the
# replica axis's sums (float32: a 256-term sum in another order moves ~1e-7).
ENSEMBLE_SERIES_RTOL = 1e-6
# The streaming correlation stage's device-memory peak over one replica
# group's lag products: under 1.5x (the ungrouped stage at config 4 holds 2x).
CORR_PEAK_OVER_GROUP = 1.5
ENSEMBLE_FILES = ["means.txt", "simulation_results.txt", "simulation_results.json"] + [
    f"corrmean_runs_{o}.dat" for o in ("epot", "ekin", "etot", "temp", "press")]
REPLICA_KERNELS = ("pair_sweep_tri_replicas", "fused_dense_chunk_replicas",
                   "fused_dense_chunk_ext_replicas")
# Phase 12, the replica axis: the replica launches of kernels 6 and 7 (the replica x
# particle step's hops) and of kernels 9 and 10 (the batched zsort engine).
# (a) kernel 7 at R=8 on the half ring's d=4 hop (1000 x 1000 of N=4000) and
# at R=32 on config 4's d=2 half hop (128 rows a rank, the low rank's [64,
# 128) x [0, 128)); kernel 6 at R=8 on the ring's 2000 x 2000 and at R=32 on
# config 4's d=2 ring (the high rank's self block and its visiting block);
# kernel 2 at R=32 on config 4's 128-row self block; kernels 9 and 10 at
# R=64 on config 2's N=864 (n_pad 896, the 16-step chunk); replicas 0, mid
# and last against one-replica launches bit for bit. (b) config 4 through
# the replica x particle half ring on a (replica=2, particle=2) thread mesh,
# cut to 2,000 steps (plus REPLICA_RING_STEPS of the ring, for kernel 6's
# replica launch), its replicas REPLICA_PARTICLE_BITS against one-replica
# sharded runs, its drift beside the batched rows engine's on the same cut,
# float64 against that engine over CROSS_STEPS. (c) the N=864 ensemble at
# R=64 through the CLI (auto -> zsort, batched) on ENSEMBLE_ZSORT_CUT.
REPLICA_HOP_KERNELS = ("pair_sweep_rect_replicas", "pair_sweep_rect_newton_replicas")
REPLICA_ZSORT_KERNELS = ("build_window_lists_replicas", "fused_dense_chunk_list_replicas")
REPLICA_HOP_R, REPLICA_HALF_R, REPLICA_LIST_R = 8, 32, 64
REPLICA_PARTICLE_MESH = (2, 2)  # (replica, particle)
REPLICA_PARTICLE_CUT = {"total_steps": 2_000}
REPLICA_PARTICLE_BITS = (0, 31, 63)
REPLICA_RING_STEPS = 200
ENSEMBLE_ZSORT_BATCHED_R = 64
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
    from ljmd_tpu_torch.utils import native

    t0 = time.time()
    require(native.available(), "the native trajectory library did not build (no C++ compiler?)")
    log(f"build: {native.library_path()} (native rva.dat writer) ready in "
        f"{time.time() - t0:.1f}s")


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


def graph_ms(torch, fn, reps: int) -> float:
    """ms of one ``fn()`` on the card alone: ``reps`` calls captured in one
    CUDA graph and replayed (CUDA events), for kernels whose launch takes
    less time than the host's call (``cuda_time_ms`` of back-to-back calls
    then times the host)."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def plan_text(plan: dict) -> str:
    """The dense chunk kernel's launch shape (``fused.dense_plan``) in words."""
    return (f"S={plan['slices']} threads a particle, {plan['particles_per_item']} particles an "
            f"item, {plan['items']} items, positions "
            f"{'resident' if plan['resident'] else 'streamed'}, {plan['blocks_per_sm']} blocks "
            f"an SM -> grid {plan['blocks']} on {plan['sms']} SMs, "
            f"{plan['warps_per_sm']:.1f} warps an SM")


def rows_plan_text(lp: dict) -> str:
    """The row-sweep kernels' launch shape (``rows_sweep_plan``,
    ``rect_newton_plan``) in words."""
    return (f"S={lp['slices']} threads a row, {lp['tile']} rows a block, {lp['items']} live of "
            f"{lp['blocks']} blocks, {lp['blocks_per_sm']} blocks an SM ({lp['warps_per_sm']:.1f} "
            f"warps of live blocks an SM, {lp['regs']} registers, {lp['spill_bytes']} spill "
            f"bytes)")


def tri_case(torch, label: str, dname: str, r, n: int, box: float, rc2: float,
             want_obs: bool = True) -> dict:
    """Kernel 2 on the (8, n_pad) rows ``r`` against its twin, rows 0..7 and
    the padding, with its launch shape (``rows_sweep_plan``), its time back
    to back (``ms``) and on the card alone (``card_ms``)."""
    from ljmd_tpu_torch.ops import pair_sweep

    args = (r, n, box, rc2, want_obs)
    got = pair_sweep.pair_sweep_tri(*args)
    want = pair_sweep.pair_sweep_tri_plain(*args)
    errs = [rel_err(got[row], want[row]) for row in range(6)]
    worst = max(e[1] for e in errs)
    tag = f"pair_sweep_tri {label} {dname} obs={want_obs}"
    require(bool((got[6:] == 0).all()) and bool((got[:, n:] == 0).all())
            and (want_obs or bool((got[3:] == 0).all())), f"{tag}: padding not zero")
    require(worst <= KERNEL_TOL[dname], f"{tag}: rel err {worst:.3e} > {KERNEL_TOL[dname]}")
    cand, cut = n * (n - 1) // 2, pairs_within(torch, r[0:3, :n].T, box, rc2)
    return {**bound(dname, sweep_flops(cand, cut, want_obs), 2 * 8 * r.shape[1] * r.element_size()),
            "shape": label, "dtype": dname, "observables": want_obs, "candidates": cand,
            "cut_pairs": cut, "launch": pair_sweep.rows_sweep_plan(r, n, None, None, want_obs),
            "max_abs_err": max(e[0] for e in errs), "rel_err": worst,
            "ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_tri(*args), 50),
            "card_ms": graph_ms(torch, lambda: pair_sweep.pair_sweep_tri(*args), 50),
            "plain_ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_tri_plain(*args), 5)}


def device_ops(torch, fn) -> int:
    """Device operations (kernels, copies, fills) of one ``fn()``, counted
    by torch.profiler (a reading: the profiler's trace can lose launches)."""
    from ljmd_tpu_torch.utils.profiling import device_breakdown

    return sum(v["count"] for v in device_breakdown(fn, top=1 << 30)["device_ms_by_name"].values())


def graph_ops(fn) -> dict:
    """Device operations of one ``fn()``, exactly: the nodes of the call
    captured in a CUDA graph (``utils.profiling.graph_ops``)."""
    from ljmd_tpu_torch.utils.profiling import graph_ops as count

    return count(fn)


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

            # Kernel 2: tri sweep, rows 0..7 per column (also at N=864, below).
            cases["pair_sweep_tri"].append(tri_case(torch, label, dname, r, n, box, rc2))

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
                        "launch": pair_sweep.pair_sweep_plan(r, n, want_obs),
                        "ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep(
                            r, n, box, rc2, want_obs), 50),
                        "card_ms": graph_ms(torch, lambda: pair_sweep.pair_sweep(
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
                "rel_err": worst, "ms": ms, "plain_ms": plain_ms,
                "plan": fused.dense_plan(r, False)})

            # The persistent grid capped at TILES_PER_BLOCK work items a
            # block against the full grid, bit for bit.
            cap_blocks = max(1, fused.dense_plan(r)["items"] // TILES_PER_BLOCK)
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
                    "rel_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "plan": fused.dense_plan(r, True)})
    for label, k, box, rc in TRI_SHAPES[len(SHAPES):]:
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            n, r, _ = perturbed_fcc(k, box, 1234 + k, torch, dtype, dev)
            cases["pair_sweep_tri"].append(tri_case(torch, label, dname, r, n, box, rc * rc))
    for name, cs in cases.items():
        per = "per call" if name.startswith("pair_sweep") else f"per {chunk}-step chunk"
        for c in cs:
            extra = (f", observables {c['observables']}" if "observables" in c else "") + (
                f", {c['card_ms']:.4f} ms on the card alone; {rows_plan_text(c['launch'])}"
                if "launch" in c else "") + (
                f", force API (N, 3) call {c['force_api_ms']:.4f} ms" if "force_api_ms" in c else
                "") + (f", grid capped at {TILES_PER_BLOCK} work items a block bit-identical "
                       f"{c['capped_grid_bit_identical']}" if "capped_grid_bit_identical" in c
                       else "") + (
                f"; {plan_text(c['plan'])}; {100 * c['bound_ms'] / c['ms']:.2f}% of the bound"
                if "plan" in c else "")
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


def phase_ordered_vs_tri(torch) -> tuple[list, bool]:
    """Kernel 5's rows 0..2 against kernel 2's on the same positions (the
    perturbed FCC boxes of TRI_SHAPES: N=4000, 500 and 864), float32 and
    float64, observables on and off, with both launch shapes: the two
    kernels run one row-sweep kernel whose UPPER flag gates only rows 3..5,
    so at the same S the forces are equal bit for bit. Returns the cases and
    whether every case has equal plans and bit-identical forces."""
    from ljmd_tpu_torch.ops import pair_sweep
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    cases = []
    for label, k, box, rc in TRI_SHAPES:
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            n, r, _ = perturbed_fcc(k, box, 1234 + k, torch, dtype, dev)
            for want_obs in (True, False):
                args = (r, n, box, rc * rc, want_obs)
                ordered, tri = pair_sweep.pair_sweep(*args), pair_sweep.pair_sweep_tri(*args)
                s5 = pair_sweep.pair_sweep_plan(r, n, want_obs)["slices"]
                s2 = pair_sweep.rows_sweep_plan(r, n, None, None, want_obs)["slices"]
                cases.append({"shape": label, "dtype": dname, "observables": want_obs,
                              "slices_5": s5, "slices_2": s2,
                              "bit_identical": bool(torch.equal(ordered[0:3], tri[0:3])),
                              "rel_err": rel_err(ordered[0:3], tri[0:3])[1]})
    same = all(c["bit_identical"] and c["slices_5"] == c["slices_2"] for c in cases)
    for c in cases:
        log(f"kernel pair_sweep vs pair_sweep_tri rows 0..2 {c['shape']} {c['dtype']} obs="
            f"{c['observables']}: S {c['slices_5']} / {c['slices_2']}, bit-identical "
            f"{c['bit_identical']} (rel diff {c['rel_err']:.3e})")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases, same


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
    lattices; kernel 7 also on the lattice in its own order (a rank's rows
    are contiguous particle indices, as in production: its blocks are
    slabs), with its launch shape (``rect_newton_plan``); kernel 2 at the
    half ring's self blocks (a rank's rows). ``ms`` is the time of a call
    back to back, as for every other kernel; a hop's kernel takes less time
    than the host's call, so ``card_ms`` gives the card's time alone
    (``graph_ms``)."""
    import numpy as np

    from ljmd_tpu_torch.ops import pair_sweep
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    cases = {name: [] for name in RECT_KERNELS + ("pair_sweep_tri",)}
    for shape, which, d, rect_hops, newton_hops in RECT_SHAPES:
        label, k, box, rc = SHAPES[which]
        rc2 = rc * rc
        for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            tol = KERNEL_TOL[dname]
            n, lattice, _ = perturbed_fcc(k, box, 1234 + k, torch, dtype, dev)
            # Shuffled, so that every block pair has pairs inside the cutoff
            # (in lattice order blocks 0 and d/2 lie apart: the masks would go
            # untested).
            r = lattice.clone()
            r[:, :n] = r[:, torch.as_tensor(np.random.default_rng(k).permutation(n), device=dev)]
            ni = n // d
            half = ni // 2
            rect = {"self": (1, 1), "hop": (1, 0)}
            newton = {"self": ((1, 1, 0, ni),), "hop": ((1, 0, 0, ni),),
                      "half": ((0, d // 2, half, ni), (d // 2, 0, 0, half), (0, d // 2, 0, ni))}
            for order, src in (("", r), (" lattice", lattice)):
                def blk(s):
                    out = torch.zeros((8, -(-ni // 128) * 128), dtype=dtype, device=dev)
                    out[:, :ni] = src[:, s * ni:(s + 1) * ni]
                    return out

                rows_bytes = 8 * blk(0).shape[1] * src.element_size()
                xyz = [blk(s)[0:3, :ni].T for s in range(d)]
                if newton_hops and not order:
                    # The half ring's self block: the tri sweep over a rank's
                    # rows (kernel 2's launches in the sharded runs; the fast
                    # steps without observables).
                    for want_obs in (True, False):
                        cases["pair_sweep_tri"].append(tri_case(
                            torch, f"{shape} self block", dname, blk(0), ni, box, rc2, want_obs))
                for want_obs in (False, True):
                    for hop in rect_hops if not order else ():
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
                        cand, cut = block_pairs(torch, xyz[si], xyz[sj], box, rc2, si * ni,
                                                sj * ni)
                        cases["pair_sweep_rect"].append({
                            **bound(dname, sweep_flops(cand, cut, want_obs), 3 * rows_bytes),
                            "shape": f"{shape} {hop}", "dtype": dname,
                            "observables": want_obs, "candidates": cand, "cut_pairs": cut,
                            "launch": pair_sweep.rows_sweep_plan(args[0], ni, args[1], ni,
                                                                 want_obs),
                            "max_abs_err": max(e[0] for e in errs), "rel_err": worst,
                            "ms": cuda_time_ms(
                                torch, lambda: pair_sweep.pair_sweep_rect(*args), 50),
                            "card_ms": graph_ms(
                                torch, lambda: pair_sweep.pair_sweep_rect(*args), 50),
                            "plain_ms": cuda_time_ms(
                                torch, lambda: pair_sweep.pair_sweep_rect_plain(*args), 5)})
                    for hop in newton_hops:
                        outs = []
                        for si, sj, i_lo, j_hi in newton[hop]:
                            args = (blk(si), blk(sj), ni, ni, si * ni, sj * ni, box, rc2, i_lo,
                                    j_hi, want_obs)
                            got = pair_sweep.pair_sweep_rect_newton(*args)
                            want = pair_sweep.pair_sweep_rect_newton_plain(*args)
                            outs.append(got)
                            errs = [rel_err(g[row], w[row]) for g, w in zip(got, want)
                                    for row in range(6)]
                            worst = max(e[1] for e in errs)
                            tag = (f"pair_sweep_rect_newton {shape} {hop}{order} [{i_lo}, {ni}) "
                                   f"x [0, {j_hi}) {dname} obs={want_obs}")
                            require(bool((got[1][3:] == 0).all()), f"{tag}: acc_j rows 3..7 not 0")
                            require(bool((got[0][6:] == 0).all())
                                    and bool((got[0][:, ni:] == 0).all())
                                    and bool((got[1][:, ni:] == 0).all()),
                                    f"{tag}: padding not zero")
                            require(worst <= tol, f"{tag}: rel err {worst:.3e} > {tol}")
                            if hop == "half" and (i_lo, j_hi) == (0, ni):
                                continue  # the reference for the two halves, below
                            side = "" if hop != "half" else ("_low" if i_lo else "_high")
                            cand, cut = block_pairs(torch, xyz[si], xyz[sj], box, rc2, si * ni,
                                                    sj * ni, i_lo, j_hi)
                            cases["pair_sweep_rect_newton"].append({
                                **bound(dname, sweep_flops(cand, cut, want_obs), 4 * rows_bytes),
                                "shape": f"{shape} {hop}{side}{order}", "dtype": dname,
                                "observables": want_obs, "i_lo": i_lo, "j_hi": j_hi,
                                "candidates": cand, "cut_pairs": cut,
                                "launch": pair_sweep.rect_newton_plan(args[0], args[1], ni, ni,
                                                                      i_lo, j_hi, want_obs),
                                "max_abs_err": max(e[0] for e in errs), "rel_err": worst,
                                "ms": cuda_time_ms(
                                    torch, lambda: pair_sweep.pair_sweep_rect_newton(*args), 50),
                                "card_ms": graph_ms(
                                    torch, lambda: pair_sweep.pair_sweep_rect_newton(*args), 50),
                                "plain_ms": cuda_time_ms(
                                    torch, lambda: pair_sweep.pair_sweep_rect_newton_plain(*args),
                                    5)})
                        if hop != "half":
                            continue
                        # The gated half hop's two sides cover the block pair {0, d/2}
                        # once: the low rank's i side plus the high rank's reactions on
                        # block 0, and so on.
                        lo, hi, full = outs
                        pairs = ((lo[0][0:3] + hi[1][0:3], full[0][0:3]),
                                 (lo[1][0:3] + hi[0][0:3], full[1][0:3]))
                        if want_obs:
                            pairs += ((lo[0][3:6].sum(1) + hi[0][3:6].sum(1),
                                       full[0][3:6].sum(1)),)
                        cover = max(rel_err(a, b)[1] for a, b in pairs)
                        require(cover <= tol, f"pair_sweep_rect_newton {shape}{order} {dname} "
                                              f"obs={want_obs}: the two halves of the gated hop "
                                              f"differ from the full hop by {cover:.3e} > {tol}")
                        cases["pair_sweep_rect_newton"][-1]["halves_vs_full_rel_err"] = cover
    for name, cs in cases.items():
        for c in cs:
            lp = c.get("launch")
            log(f"kernel {name} {c['shape']} {c['dtype']} observables {c['observables']}: rel "
                f"err {c['rel_err']:.3e} (tol {KERNEL_TOL[c['dtype']]:.0e}), {c['ms']:.4f} ms a "
                f"call back to back, the host's call included ({c['card_ms']:.4f} ms on the card "
                f"alone) vs plain {c['plain_ms']:.4f} ms per call; bound "
                f"{c['bound_ms']:.5f} ms "
                f"({c['bound_by']}, {c['candidates']} candidates, {c['cut_pairs']} inside rc)"
                + (f"; gated halves vs full hop {c['halves_vs_full_rel_err']:.3e}"
                   if "halves_vs_full_rel_err" in c else "")
                + (f"; {rows_plan_text(lp)}" if lp else ""))
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


def list_body_share(torch, r, stages, n: int, slices: int, box_length: float,
                    rc_square: float) -> dict:
    """The modelled share of warp iterations that run the LJ body under the
    warp-vote cull of csrc/fused_dense_chunk_list.cu, worked out in float64
    from the positions the kernel starts from (no counter in the kernel):
    over the plan's (granule, 128-column stage) pairs (``stages``:
    ``list_plan_stages``), a warp being 32 / S consecutive particles (S
    threads each, S <= 32) or one particle's 32 threads (S = 64), thread
    slice taking the columns slice, slice + S, ...; and the pairs inside the
    mask over the candidates."""
    offsets, col0, meta = stages
    dev = r.device
    x = r.double()
    L = box_length
    gran = torch.repeat_interleave(torch.arange(offsets.numel() - 1, device=dev),
                                   offsets[1:] - offsets[:-1])
    ar = torch.arange(128, device=dev)
    pw, lw = max(1, 32 // slices), min(slices, 32)
    body = hits = total = 0
    for b0 in range(0, gran.numel(), 256):
        sl = slice(b0, b0 + 256)
        mt = meta[sl][:, None, None]
        ii = (gran[sl][:, None] * 128 + ar)[:, :, None]
        jj = (col0[sl][:, None] + ar)[:, None, :]
        d = [x[c][ii] - x[c][jj] for c in range(3)]
        for c, bit in ((0, 4), (1, 0), (2, 8)):
            rd = d[c] - L * torch.round(d[c] / L)
            d[c] = rd if bit == 0 else torch.where((mt & bit) > 0, rd, d[c])
        m = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < rc_square
        fwd = (mt & 1) > 0
        gr, gc = torch.where(fwd, ii, jj), torch.where(fwd, jj, ii)
        ok = (gc > gr) & (gc < n) & (gr < n) & (gc >= (mt >> 4) * 128)
        m &= ((mt & 2) == 0) | ok
        hits += int(m.sum())
        B = m.shape[0]
        warps = m.reshape(B, 128 // pw, pw, 128 // slices, slices // lw, lw)
        body += int(warps.any(dim=5).any(dim=2).sum())
        total += B * (128 // pw) * (128 // slices) * (slices // lw)
    return {"body": body / max(1, total), "pairs_in_mask": hits / max(1, gran.numel() * 128 * 128),
            "stages": int(gran.numel())}


def list_report(torch, r, tiles, tcounts, n: int, tile_j: int, box_length: float,
                rc_square: float) -> dict:
    """Kernel 10's launch shape (``list_plan``) and, under ``model`` (worked
    out here from this run's lists and positions, not counted in the
    kernel): the plan's 128-column stages a step over all work items, the
    busiest block's against the mean, the visit entries every block of the
    earlier port walked a step, and the cull's modelled body share."""
    from ljmd_tpu_torch.ops import fused_list

    plan = fused_list.list_plan(r)
    stages = fused_list.list_plan_stages(tiles, tcounts, r.shape[1], tile_j)
    per_gran = (stages[0][1:] - stages[0][:-1]).long()
    w = torch.arange(plan["items"], device=per_gran.device)
    cost = per_gran[w * plan["particles_per_item"] // 128]
    per_block = torch.zeros(plan["blocks"], dtype=torch.long, device=cost.device).index_add_(
        0, w % plan["blocks"], cost)
    return {"launch": plan,
            "model": {"stages": {"a_step": int(cost.sum()), "busiest_block": int(per_block.max()),
                                 "mean_block": float(per_block.double().mean()),
                                 "visits_walked_before": int(tcounts.sum())},
                      "body_share": list_body_share(torch, r, stages, n, plan["slices"],
                                                    box_length, rc_square)}}


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
            pack = lambda: window_lists.build_window_lists(flags, n, n_pad, 128, tj)  # noqa: E731
            ms = cuda_time_ms(torch, pack, 50)
            card_ms = graph_ms(torch, pack, 50)
            # Device operations a call: exactly, from the nodes of one call
            # captured in a CUDA graph; and from the profiler over
            # PROFILED_CALLS calls, which can lose launches but never adds any.
            ops = graph_ops(pack)
            require(ops["ops"] == 1, f"build_window_lists {label} {dname}: {ops['nodes']} in "
                                     "one call's graph, the kernel alone expected")
            seen = device_ops(torch, lambda: [pack() for _ in range(PROFILED_CALLS)])
            require(seen <= PROFILED_CALLS, f"build_window_lists {label} {dname}: the profiler "
                                            f"saw {seen} device operations in {PROFILED_CALLS} "
                                            "calls, one a call expected")
            plain_ms = cuda_time_ms(torch, lambda: window_lists.build_window_lists_plain(
                flags, n, n_pad, 128, tj), 3, warmup=1)
            # Integer work, one operation per flag, counted at the float32 rate.
            list_bytes = 4 * (flags.numel() + tiles.numel() + tcounts.numel())
            cases["build_window_lists"].append({
                **bound("float32", flags.numel(), list_bytes),
                "shape": label, "dtype": dname, "max_abs_err": 0.0, "rel_err": 0.0,
                "lists_equal": True, "tcounts": tcounts.tolist(), "ms": ms, "card_ms": card_ms,
                "device_ops": ops["ops"], "graph_nodes": ops["nodes"],
                "profiler_ops": seen, "profiled_calls": PROFILED_CALLS, "plain_ms": plain_ms})

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
            report = list_report(torch, r, tiles, tcounts, n, tj, L, cfg.rc_square)
            g_cap = max(1, report["launch"]["blocks"] // TILES_PER_BLOCK)
            capped = all(bool(torch.equal(g, w)) for g, w in zip(
                fused_list._launch(*largs, grid_cap=g_cap), fused_list._launch(*largs)))
            require(capped, f"fused_dense_chunk_list {label} {dname}: the grid capped at "
                            f"{g_cap} blocks ({TILES_PER_BLOCK}x the items a block) differs "
                            "from the full grid")
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
                "plain_ms": plain_ms, **report})
    for c in cases["build_window_lists"]:
        log(f"kernel build_window_lists {c['shape']} {c['dtype']}: lists equal to the twin's "
            f"(fluid and random flags), tcounts {c['tcounts']}, {c['ms']:.4f} ms back to back, "
            f"{c['card_ms']:.4f} ms on the card alone, {c['device_ops']} device operation(s) a "
            f"call (graph nodes {c['graph_nodes']}; the profiler saw {c['profiler_ops']} in "
            f"{c['profiled_calls']} calls), vs plain {c['plain_ms']:.4f} ms per call")
    for c in cases["fused_dense_chunk_list"]:
        modes = ", ".join(f"{m['mode']} {m['rel_err']:.3e}" for m in c["modes"])
        lp, st, sh = c["launch"], c["model"]["stages"], c["model"]["body_share"]
        log(f"kernel fused_dense_chunk_list {c['shape']} {c['dtype']}: rel err {modes} "
            f"(tol {KERNEL_TOL[c['dtype']]:.0e}), {c['ms']:.4f} ms vs plain {c['plain_ms']:.4f} ms "
            f"per {k}-step chunk; grid capped to a {TILES_PER_BLOCK}th bit-identical "
            f"{c['capped_grid_bit_identical']}; S={lp['slices']} threads a particle, 256 a "
            f"block, {lp['items']} items, positions "
            f"{'resident' if lp['resident'] else 'streamed'}, {lp['blocks_per_sm']} blocks an "
            f"SM -> grid {lp['blocks']} ({lp['warps_per_sm']:.1f} warps an SM, {lp['regs']} "
            f"registers, {lp['spill_bytes']} spill bytes); modelled from this "
            f"run's lists: {st['a_step']} plan stages a step (the busiest block "
            f"{st['busiest_block']}, mean {st['mean_block']:.1f}; the earlier port walked "
            f"{st['visits_walked_before']} visits a tile a step), modelled body share "
            f"{100 * sh['body']:.2f}% of warp iterations, {100 * sh['pairs_in_mask']:.2f}% of "
            f"candidates in the mask; {100 * c['bound_ms'] / c['ms']:.2f}% of the bound")
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


def width_index_report(torch, lists, n_pencils: int, capacity: int, r) -> dict:
    """Kernel 16's launch shape and its per-block visit index for the lists:
    the index's entries, its build time (CUDA events) and device operations
    (torch.profiler), and the staged 128-slot chunks a step of the busiest
    and the mean block of the persistent grid (block b takes the ordered
    items b, 2G - 1 - b, 2G + b, ...)."""
    from ljmd_tpu_torch.ops import fused_pencil

    def build():
        return fused_pencil.width_index(*lists, n_pencils, capacity)

    offsets, entries, order = (t.cpu().long() for t in build())
    grid = fused_pencil.width_grid(r)
    G, NB = grid["blocks"], order.numel()
    chunks = torch.cat([torch.zeros(1, dtype=torch.long),
                        torch.cumsum((entries[:int(offsets[-1])] >> 6) & 63, 0)])
    cost = (chunks[offsets[1:]] - chunks[offsets[:-1]]).double()
    pos = torch.arange(NB)
    lane = torch.where((pos // G) % 2 == 0, pos % G, G - 1 - pos % G)
    load = torch.zeros(G, dtype=torch.float64).index_add_(0, lane, cost[order])
    return {"grid": grid,
            "index": {"entries": int(offsets[-1]), "ms": cuda_time_ms(torch, build, 10),
                      "device_ops": device_ops(torch, build),
                      "busiest_chunks": float(load.max()), "mean_chunks": float(load.mean())}}


def static_report(torch, c, tbl, shf, n_pencils: int, capacity: int, box_length: float,
                  rc_square: float) -> dict:
    """Kernel 15's launch shape (``static_plan``) and, under ``model``
    (worked out here from this run's slots, not counted in the kernel): its
    live work items and rounds over the persistent grid, the stages its
    stream holds a step against the stream without skips (9 pencils x
    capacity / 128 for every live item), and the cull's modelled body
    share."""
    from ljmd_tpu_torch.ops import fused_pencil

    plan = fused_pencil.static_plan(c.r)
    chunks = static_chunks(torch, c, tbl, shf, n_pencils, capacity)
    item_live = (c.r[3].reshape(-1, 128)[:, 0] > 0.5).long()
    live = int(item_live.sum())
    # Block b takes the items at positions b, b + G, ... of the block-major
    # order (csrc/fused_pencil_chunk.cu hs_item).
    G, n_sub = plan["blocks"], capacity // 128
    w = torch.arange(item_live.numel(), device=item_live.device)
    lane = ((w % n_sub) * n_pencils + w // n_sub) % G
    per_block = torch.zeros(G, dtype=torch.long, device=lane.device).index_add_(0, lane, item_live)
    return {"static": plan,
            "model": {"stages": {"live_items": live, "rounds": int(per_block.max()),
                                 "staged": chunks[0].numel(),
                                 "unskipped": live * 9 * (capacity // 128)},
                      "body_share": modelled_body_share(torch, c.r, chunks, False, box_length,
                                                        rc_square)}}


def modelled_body_share(torch, pos, chunks, full_mic: bool, box_length: float,
                        rc_square: float) -> dict:
    """The modelled share of warp iterations that run the LJ body under the
    cull of csrc/pencil_cull.cuh, worked out in float64 from the positions
    the kernel starts from (no counter in the kernel): over the (128-slot
    block, 128-slot partner stage) chunks of a kernel's stream (``chunks``:
    i block, partner start slot, role 0 self / 1 forward / 2 backward / 3
    full-MIC / 4 the full sweep's shifted partner, image shifts), a warp
    being 32 consecutive slots facing one partner, the iterations where any
    lane's pair holds the mask; and the pairs inside the mask over the
    candidates. Roles 3 and 4 also test the validity."""
    blk, q0, role, shx, shy = chunks
    dev = pos.device
    x = pos.double()
    L = box_length
    ar = torch.arange(128, device=dev)
    body = hits = 0
    n = blk.numel()
    for b0 in range(0, n, 256):
        sl = slice(b0, b0 + 256)
        ii = blk[sl, None] * 128 + ar
        jj = q0[sl, None] + ar
        rl = role[sl, None]
        offx, offy = (s[sl, None].double() * L for s in (shx, shy))
        xi = torch.where(rl == 2, x[0][ii] + offx, x[0][ii])
        yi = torch.where(rl == 2, x[1][ii] + offy, x[1][ii])
        shifted = (rl == 1) | (rl == 4)
        xj = torch.where(shifted, x[0][jj] + offx, x[0][jj])
        yj = torch.where(shifted, x[1][jj] + offy, x[1][jj])
        d = [xi[:, :, None] - xj[:, None, :], yi[:, :, None] - yj[:, None, :],
             x[2][ii][:, :, None] - x[2][jj][:, None, :]]
        for c in (range(3) if full_mic else (2,)):
            d[c] = d[c] - L * torch.round(d[c] / L)
        m = d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < rc_square
        m &= ((rl == 1) | (rl == 2))[:, :, None] | (ii[:, :, None] != jj[:, None, :])
        m &= (rl < 3)[:, :, None] | ((x[3][ii][:, :, None] * x[3][jj][:, None, :]) > 0.5)
        hits += int(m.sum())
        body += int(m.reshape(-1, 4, 32, 128).any(dim=2).sum())  # (chunk, warp, lane, partner)
    return {"body": body / (n * 4 * 128), "pairs_in_mask": hits / (n * 128 * 128),
            "chunks": n}


def sweep_report(torch, pos, tbl, counts, shf, n_pencils_i: int, capacity: int,
                 box_length: float, rc_square: float, want_obs: bool) -> dict:
    """The half-shell sweep's launch shape (``sweep_hs_grid``) and, under
    ``model`` (worked out here from this run's slots, not counted in the
    kernel): its live work items and waves, the stages of its plan
    (``hs_stage_plan``) against the earlier sweep's (every non-empty partner
    at full capacity), the busiest item's stages beside the mean, and the
    cull's modelled body share."""
    from ljmd_tpu_torch.ops import pencil_sweep

    p_all = pos.shape[1] // capacity
    plan = pencil_sweep.hs_stage_plan(counts, tbl, shf,
                                      pencil_sweep.half_shell_lower(tbl, p_all), n_pencils_i,
                                      p_all, capacity)
    launch = pencil_sweep.sweep_hs_grid(pos, want_obs)
    per_item = plan["live"].sum(dim=1)[:, None].expand_as(plan["item_live"])[plan["item_live"]]
    launch.update(live_items=plan["items"],
                  waves=-(-plan["items"] // (launch["blocks_per_sm"] * launch["sms"])))
    return {"launch": launch,
            "model": {"stages": {"kept": plan["kept"], "full": plan["full"],
                                 "busiest_item": int(per_item.max()),
                                 "mean_item": plan["kept"] / max(1, plan["items"])},
                      "body_share": modelled_body_share(torch, pos, pencil_sweep.hs_chunks(plan),
                                                        False, box_length, rc_square)}}


def static_chunks(torch, c, tbl, shf, n_pencils: int, capacity: int):
    """Kernel 15's (block, stage) chunks of one step, from its stream
    (``static_stream``), in ``modelled_body_share``'s form."""
    from ljmd_tpu_torch.ops import fused_pencil

    offsets, entries, _ = (t.long() for t in fused_pencil.static_stream(
        c.r[3], tbl, shf, fused_pencil.half_shell_lower(tbl, n_pencils), n_pencils, capacity))
    dev = entries.device
    nblk = (entries >> 6) & 63
    ent = torch.repeat_interleave(torch.arange(entries.numel(), device=dev), nblk)
    first = torch.cumsum(nblk, 0) - nblk
    w = entries[ent]
    q0 = ((w >> 12) + torch.arange(ent.numel(), device=dev) - first[ent]) * 128
    role = torch.tensor([0, 0, 1, 2], device=dev)[(w >> 4) & 3]
    return (ent // 9, q0, role, ((w >> 2) & 3) - 1, (w & 3) - 1)


def zband_chunks(torch, plan):
    """Kernel 12's (i-slice, kept stage) chunks, in ``modelled_body_share``'s
    form."""
    t = torch.nonzero(plan["keep"], as_tuple=True)[0]
    zero = torch.zeros_like(t)
    return (t, plan["start"][plan["keep"]], zero + 3, zero, zero)


def full_report(torch, pos, tbl, counts, shf, n_pencils: int, capacity: int,
                box_length: float, rc_square: float, want_obs: bool) -> dict:
    """Kernel 11's launch shape (``full_grid``: 128-slot i-slices of 512
    threads, blocks and warps an SM, registers, spills; live slices and
    waves) and, under ``model`` (worked out here from this run's slots, not
    counted in the kernel): the stages of its plan (``full_stage_plan``)
    against the earlier sweep's (every non-empty partner at full capacity)
    and the cull's modelled body share."""
    from ljmd_tpu_torch.ops import pencil_sweep

    plan = pencil_sweep.full_stage_plan(counts, tbl, n_pencils, capacity)
    launch = pencil_sweep.full_grid(pos, want_obs)
    launch.update(live_blocks=plan["items"],
                  waves=-(-plan["items"] // (launch["blocks_per_sm"] * launch["sms"])))
    t, k, _ = torch.nonzero(plan["keep"], as_tuple=True)
    e = (t // (capacity // 128)) * 9 + k
    sh = shf.long().reshape(-1, 2)[e]
    chunks = (t, plan["start"][plan["keep"]], torch.full_like(t, 4), sh[:, 0], sh[:, 1])
    return {"launch": launch,
            "model": {"stages": {k: plan[k] for k in ("stages", "past_count", "kept")},
                      "body_share": modelled_body_share(torch, pos, chunks, False, box_length,
                                                        rc_square)}}


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

            # Kernels 13 + 14: the sweep, rows 0..5 on the valid slots; its
            # launch shape and modelled plan (with the observables: the
            # engine's sampled sweep).
            hs_report = sweep_report(torch, c.r, tbl, c.counts, shf, P, cap, L, rc2, True)
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
                                    2 * slots_bytes + table_bytes), **hs_report,
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
                # Without observables: the sharded engine's chunk steps (rank
                # 0's strip is timed and reported).
                s_report = {} if rank else sweep_report(torch, args[0], args[1], args[2],
                                                        args[3], p_loc, cap, L, rc2, False)
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
                        **s_report,
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
                f_report = full_report(torch, c.r, ftbl, c.counts, fshf, P, cap, L, rc2,
                                       want_obs)
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
                                    2 * slots_bytes + full_table_bytes), **f_report,
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
                # The kernel's launch shape; its stage plan (exact skips)
                # and the cull's modelled body share, worked out from this
                # run's slots (``model``: not counted in the kernel).
                zplan = pencil_sweep.zband_stage_plan(c.counts, ftbl, *wins, P, cap, window)
                zgrid = pencil_sweep.zband_grid(c.r)
                live = int(((torch.arange(grid.n_slots // 128, device=dev) % (cap // 128)) * 128
                            < c.counts.long().repeat_interleave(cap // 128)).sum())
                zgrid.update(live_blocks=live, waves=-(-live // (zgrid["blocks_per_sm"]
                                                                 * zgrid["sms"])))
                zmodel = {"stages": {k: zplan[k] for k in ("stages", "kept", "b_inside_a",
                                                          "a_past_count", "b_past_count")},
                          "body_share": modelled_body_share(torch, c.r, zband_chunks(torch, zplan),
                                                            True, L, rc2)}
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
                        "use_b": int(wins[2].sum()), "launch": zgrid, "model": zmodel,
                        "max_abs_err": max(e[0] for e in errs),
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
                    # The persistent grid capped to a TILES_PER_BLOCK-th
                    # (each block takes that many times the items), bit for
                    # bit.
                    if name == "fused_pencil_width_chunk":
                        g_cap = fused_pencil.width_grid(c.r, bool(kw))["blocks"] // TILES_PER_BLOCK
                        capped = fused_pencil._launch_width(
                            c.r, c.v, c.a, lists, P, cap, L, rc2, dt, k_check, kw.get("r_lo"),
                            kw.get("vc"), grid_cap=g_cap)
                    else:
                        g_cap = fused_pencil.static_plan(c.r, bool(kw))["blocks"] // TILES_PER_BLOCK
                        capped = fused_pencil._launch_static(
                            c.r, c.v, c.a, tbl, shf, P, cap, L, rc2, dt, k_check, kw.get("r_lo"),
                            kw.get("vc"), grid_cap=g_cap)
                    require(all(bool(torch.equal(g, w)) for g, w in zip(capped, got)),
                            f"{name} {label} {dname} {mode}: the capped grid differs")
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
                case = {
                    **base, **bound(dname, chunk_flops(k_time, cand, cut, n),
                                    6 * slots_bytes + extra),
                    "max_abs_err": max(x["max_abs_err"] for x in errs),
                    "rel_err": max(x["rel_err"] for x in errs), "modes": errs,
                    "ms": cuda_time_ms(torch, lambda: kernel(*targs), 10),
                    "plain_ms": cuda_time_ms(torch, lambda: plain(*targs), 1, warmup=1)}
                if name == "fused_pencil_width_chunk":
                    case.update(width_index_report(torch, lists, P, cap, c.r))
                else:
                    case.update(static_report(torch, c, tbl, shf, P, cap, L, rc2))
                cases[name].append(case)
    for name, cs in cases.items():
        sweep = "observables" in cs[0]
        per = "per call" if sweep else f"per {k_time}-step chunk"
        for c in cs:
            what = (f"observables {c['observables']}" if sweep else
                    ", ".join(f"{m['mode']} {m['rel_err']:.3e}" for m in c["modes"]))
            if "rel_err_vs_full" in c:
                st, zg, sh = c["model"]["stages"], c["launch"], c["model"]["body_share"]
                what += (f", window {c['window']} ({c['use_b']} window-B visits), vs the full "
                         f"sweep {c['rel_err_vs_full']:.3e}; {zg['threads']} threads a 128-slot "
                         f"slice, {zg['live_blocks']} of {zg['blocks']} slices live, "
                         f"{zg['blocks_per_sm']} blocks an SM ({zg['warps_per_sm']} warps, "
                         f"{zg['regs']} registers, {zg['spill_bytes']} spill bytes) -> "
                         f"{zg['waves']} wave(s); modelled from this run's slots: window "
                         f"stages a sweep {st['stages']}, {st['b_inside_a']} B inside A, "
                         f"{st['a_past_count']} + {st['b_past_count']} past the count skipped, "
                         f"{st['kept']} swept; modelled body share {100 * sh['body']:.2f}% of "
                         f"warp iterations, {100 * sh['pairs_in_mask']:.2f}% of candidates in "
                         f"the mask")
            if name == "pencil_sweep_full":
                fg, st, sh = c["launch"], c["model"]["stages"], c["model"]["body_share"]
                what += (f"; {fg['threads']} threads a 128-slot slice, {fg['live_blocks']} of "
                         f"{fg['blocks']} slices live, {fg['blocks_per_sm']} blocks an SM "
                         f"({fg['warps_per_sm']} warps, {fg['regs']} registers, "
                         f"{fg['spill_bytes']} spill bytes) -> {fg['waves']} wave(s); modelled "
                         f"from this run's slots: stages {st['kept']} of {st['stages']} "
                         f"({st['past_count']} past the count skipped), modelled body share "
                         f"{100 * sh['body']:.2f}% of warp iterations, "
                         f"{100 * sh['pairs_in_mask']:.2f}% of candidates in the mask")
            if name == "pencil_sweep_hs":
                sg, st, sh = c["launch"], c["model"]["stages"], c["model"]["body_share"]
                what += (f"; S={sg['slices']} threads a slot, {sg['threads']} a 128-slot item, "
                         f"{sg['live_items']} of {sg['blocks']} items live, "
                         f"{sg['blocks_per_sm']} blocks an SM ({sg['warps_per_sm']} warps, "
                         f"{sg['regs']} registers, {sg['spill_bytes']} spill bytes) -> "
                         f"{sg['waves']} wave(s); modelled from this run's slots: stages "
                         f"{st['kept']} of {st['full']} ({st['full'] - st['kept']} skipped), the "
                         f"busiest item {st['busiest_item']} (mean {st['mean_item']:.2f}), "
                         f"modelled body share {100 * sh['body']:.2f}% of warp iterations, "
                         f"{100 * sh['pairs_in_mask']:.2f}% of candidates in the mask")
            if "static" in c:
                sp, st, sh = c["static"], c["model"]["stages"], c["model"]["body_share"]
                what += (f"; S={sp['slices']} threads a slot, {sp['threads']} a block, "
                         f"{st['live_items']} of {sp['items']} items live, {sp['blocks_per_sm']} "
                         f"blocks an SM ({sp['warps_per_sm']} warps, {sp['regs']} registers, "
                         f"{sp['spill_bytes']} spill bytes) -> grid {sp['blocks']}; modelled "
                         f"from this run's slots: the busiest block runs {st['rounds']} live "
                         f"items a step (mean {st['live_items'] / sp['blocks']:.2f}), stages a "
                         f"step {st['staged']} of {st['unskipped']} "
                         f"({st['unskipped'] - st['staged']} skipped), modelled body share {100 * sh['body']:.2f}% of warp "
                         f"iterations, {100 * sh['pairs_in_mask']:.2f}% of candidates in the mask")
            if sweep or "static" in c:
                what += f"; {100 * c['bound_ms'] / c['ms']:.2f}% of the bound"
            if "index" in c:
                ix, wg = c["index"], c["grid"]
                what += (f"; {wg['threads']} threads a 128-slot item, {wg['items']} items, grid "
                         f"{wg['blocks']}; index: {ix['entries']} entries, built in "
                         f"{ix['ms']:.4f} ms by {ix['device_ops']} device operations; the "
                         f"busiest block runs {ix['busiest_chunks']:.0f} staged chunks a step, "
                         f"the mean {ix['mean_chunks']:.1f}; "
                         f"{100 * c['bound_ms'] / c['ms']:.2f}% of the bound")
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


def block_chunk_share(torch, flags, n: int, n_pad: int, tile_i: int, tile_j: int, plan: dict):
    """(128-column granules the busiest block runs, the mean over blocks,
    granules an item has) of kernel 8 under ``flags`` at the launch shape
    ``plan``: an item of TI particles runs a granule when its forward tile
    (j > i) or its backward tile (j < i) is active; block b runs items b,
    b + grid, ..."""
    ti, grid = plan["particles_per_item"], plan["blocks"]
    f = (flags.reshape(n_pad // tile_i, n_pad // tile_j) > 0).cpu()
    i0 = torch.arange(0, n_pad, ti)[:, None]
    j0 = torch.arange(0, n, 128)[None, :]
    g1 = torch.clamp(j0 + 128, max=n)
    fwd = (g1 - 1 > i0) & f[i0 // tile_i, j0 // tile_j]
    bwd = (j0 < i0 + ti - 1) & f[j0 // tile_i, i0 // tile_j]
    run = (fwd | bwd).sum(dim=1).double()
    per_block = torch.zeros(grid, dtype=torch.float64).index_add_(
        0, torch.arange(run.numel()) % grid, run)
    return int(per_block.max()), float(per_block.mean()), j0.numel()


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
                plan = fused.dense_plan(r, False, True)
                busiest, mean, per_item = block_chunk_share(torch, flags, n, n_pad, 128, tj, plan)
                case = {**bound(dname, chunk_flops(FLAG_CHUNK_STEPS, cand, cut, n),
                                6 * rows_bytes + 4 * flags.numel()),
                        "shape": f"N={n} tile_j={tj} {pname}", "dtype": dname,
                        "block_chunks": {"busiest": busiest, "mean": mean, "per_item": per_item},
                        "plan": plan,
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
            f"{c['tiles']} tiles active; the busiest block runs {bc['busiest']} 128-column "
            f"granules, the mean {bc['mean']:.1f}, {bc['per_item']} an item): rel err {modes} "
            f"(tol {KERNEL_TOL[c['dtype']]:.0e}), "
            f"{c['ms']:.4f} ms{plain} per {FLAG_CHUNK_STEPS}-step chunk; bound "
            f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {c['candidates']} candidates, "
            f"{100 * c['bound_ms'] / c['ms']:.2f}% of it); {plan_text(c['plan'])}")
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return {"fused_dense_chunk_flags": cases}


def probe_library(name: str, offs: list | None, x, iters: int):
    """ITERS calls of the library operation probe ``name`` stands for
    (``library_ms``; the port never calls these); ``offs`` as a host list,
    so that the calls can be captured in a CUDA graph."""
    import torch

    from ljmd_tpu_torch.experiments.mosaic_support import WINDOWS

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
    plain loop, timed back to back (``ms``) and on the card alone
    (``card_ms``, CUDA-graph replay) beside ITERS calls of the library
    operation it stands for (``probe_library``, both ways); the gate: on the
    card alone, 5 x ITERS iterations take at least PROBE_SCALING x the time
    of ITERS (a loop the compiler cut short takes about 1x)."""
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
        offs = inputs[0].tolist() if len(inputs) == 2 else None
        long_inputs = ms.probe_inputs(name, dev, iters=5 * ms.ITERS)
        card_ms = graph_ms(torch, lambda: ms.probe(name, *inputs), 20)
        card_5x_ms = graph_ms(torch, lambda: ms.probe(name, *long_inputs, iters=5 * ms.ITERS), 20)
        require(card_5x_ms >= PROBE_SCALING * card_ms,
                f"probe {name}: {5 * ms.ITERS} iterations take {card_5x_ms:.4f} ms on the card, "
                f"{card_5x_ms / card_ms:.2f}x the {ms.ITERS} iterations' {card_ms:.4f} ms "
                f"(gate {PROBE_SCALING}x): the loop was cut short")
        # Operations per iteration: an add per output element (transposes,
        # windows, roll), a multiply and an add per input element (row sums).
        per_iter = (2 * x.numel() if name.startswith("rowsum") else
                    512 if name.startswith("lane") else got.numel())
        nbytes = 4 * (x.numel() + got.numel() + (ms.ITERS if len(inputs) == 2 else 0))
        cases.append({**bound("float32", ms.ITERS * per_iter, nbytes), "shape": name,
                      "label": label, "dtype": "float32", "max_abs_err": err, "rel_err": rel,
                      "ms": cuda_time_ms(torch, lambda: ms.probe(name, *inputs), 20),
                      "card_ms": card_ms, "card_5x_ms": card_5x_ms,
                      "plan": ms.probe_plan(name, tuple(x.shape)),
                      "plain_ms": cuda_time_ms(torch, lambda: ms.probe_plain(name, *inputs), 2,
                                               warmup=1),
                      "library_ms": cuda_time_ms(torch, lambda: probe_library(
                          name, offs, x, ms.ITERS), 2, warmup=1),
                      "library_card_ms": graph_ms(torch, lambda: probe_library(
                          name, offs, x, ms.ITERS), 2)})
    for c in cases:
        log(f"kernel mosaic_probes {c['label']}: rel err {c['rel_err']:.3e} (tol {tol:.0e}), "
            f"{c['ms']:.4f} ms back to back, {c['card_ms']:.4f} ms on the card alone "
            f"({5 * ms.ITERS} iterations {c['card_5x_ms']:.4f} ms, "
            f"{c['card_5x_ms'] / c['card_ms']:.2f}x) vs plain {c['plain_ms']:.4f} ms vs library "
            f"{c['library_ms']:.4f} ms ({c['library_card_ms']:.4f} ms on the card alone) per "
            f"{ms.ITERS} iterations; bound {c['bound_ms']:.5f} ms ({c['bound_by']}); plan "
            f"{c['plan']}")
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
    resolution), and k5c with LAYOUT_MASKED visits in its masked loop too;
    in the experiment's box each body back to back (``ms``) and on the card
    alone (``card_ms``, CUDA-graph replay; also at 32 visits, for the slope
    per visit-step); the transpose glue at both shapes."""
    from ljmd_tpu_torch.experiments import layout as ly
    from ljmd_tpu_torch.experiments import mosaic_support as ms
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    tol = KERNEL_TOL["float32"]
    steps, v = LAYOUT_CHECK_STEPS, ly.V_HI
    ti, tj = ly.visit_lists(v, 7, ly.N_PAD)
    dense_box = 0.5 * math.ceil(ly.N_PAD ** (1.0 / 3.0) - 1e-9)  # lattice spacing 0.5
    items = [(item, 0) for item in LAYOUT_ITEMS] + [("k5c-512", LAYOUT_MASKED)]
    cases = []
    for box in (ly.L, dense_box):
        r8, rT = ly.make_state(0, ly.N_PAD, dev, box=box)
        for item, masked in items:
            name, w = item.rsplit("-", 1)
            tj_w = int(w)
            lv = ly.variant_lists(name, tj_w, ti, tj, ly.N_PAD)
            lists = [torch.tensor(x, dtype=torch.int32, device=dev) for x in lv]
            args = (name, r8, rT, *lists, v, tj_w, steps)
            got = ly.layout_body(*args, box=box, masked=masked)
            want = ly.layout_body_plain(*args, box=box, masked=masked)
            err, rel = rel_err(got, want)
            moved = float((want[1] - r8[1]).abs().max())
            tag = f"{item} v={v}" + (f" masked={masked}" if masked else "") + f" L={box}"
            require(rel <= tol, f"layout_body {tag}: rel err {rel:.3e} > {tol}")
            case = {"shape": tag, "dtype": "float32", "max_abs_err": err, "rel_err": rel,
                    "row1_moved": moved}
            if box == ly.L and not masked:
                cut = layout_cut_pairs(torch, r8, rT, name, *lv, v, tj_w, box, ly.RC2)
                nbytes = 4 * (2 * r8.numel() + rT.numel() + 2 * v)
                case.update(bound("float32", steps * (v * 128 * tj_w * FLOPS_CANDIDATE
                                                      + cut * FLOPS_FORCE), nbytes))
                lo = (name, r8, rT, *lists, ly.V_LO, tj_w, steps)
                cap = ly._max_blocks(dev.index, ly.VARIANTS[name][0])
                card_ms = graph_ms(torch, lambda: ly.layout_body(*args, box=box), 10)
                card_lo_ms = graph_ms(torch, lambda: ly.layout_body(*lo, box=box), 10)
                case.update(cut_pairs=cut,
                            ms=cuda_time_ms(torch, lambda: ly.layout_body(*args, box=box), 10),
                            card_ms=card_ms, card_ms_v32=card_lo_ms,
                            card_ns_per_visit_step=1e6 * (card_ms - card_lo_ms)
                            / ((v - ly.V_LO) * steps),
                            plan=ly.layout_plan(name, v, tj_w, cap),
                            plain_ms=cuda_time_ms(torch, lambda: ly.layout_body_plain(
                                *args, box=box), 1, warmup=1))
            elif box != ly.L:
                # The displacement itself within LAYOUT_DISP_TOL: float32
                # rounds r (~5e-7 at L = 8) far below it.
                disp = float((got - want).abs().max()) / moved
                case["disp_rel_err"] = disp
                require(moved > 1e-4, f"layout_body {tag}: the forces did not move r")
                require(disp <= LAYOUT_DISP_TOL, f"layout_body {tag}: displacement "
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
                      "card_ms": graph_ms(torch, lambda: ms.transpose_scaled(x, ly.ITERS_LO), 10),
                      "plain_ms": cuda_time_ms(torch, lambda: ms.transpose_scaled_plain(
                          x, ly.ITERS_LO), 1, warmup=1)})
    for c in cases:
        if "ms" in c:
            timing = (f", {c['ms']:.4f} ms back to back, {c['card_ms']:.4f} ms on the card alone"
                      + (f" (32 visits {c['card_ms_v32']:.4f} ms: "
                         f"{c['card_ns_per_visit_step']:.1f} ns a visit-step; plan {c['plan']})"
                         if "plan" in c else "")
                      + f" vs plain {c['plain_ms']:.4f} ms; bound {c['bound_ms']:.5f} ms "
                      f"({c['bound_by']}, {100 * c['bound_ms'] / c['card_ms']:.2f}% of it on the "
                      f"card alone)")
        elif "disp_rel_err" in c:
            timing = (f", row 1 moved {c['row1_moved']:.3e}, displacement rel err "
                      f"{c['disp_rel_err']:.3e} (tol {LAYOUT_DISP_TOL:.0e})")
        else:
            timing = ""
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


def _cli(name: str, args: list, timeout: int = 600) -> tuple[object, float]:
    """``python -m ljmd_tpu_torch <args>`` from the checkout; fails the
    phase on a non-zero exit. Returns (process, wall seconds)."""
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "ljmd_tpu_torch", *args], cwd=str(REPO),
                          capture_output=True, text=True, timeout=timeout)
    wall = time.time() - t0
    for line in proc.stdout.strip().splitlines():
        log(f"  {name}| {line}")
    require(proc.returncode == 0, f"{name}: CLI failed ({proc.returncode}):\n{proc.stderr}")
    return proc, wall


def _cli_json(proc, key: str) -> dict:
    """The ``{"<key>": ...}`` line of a CLI run's output."""
    for line in proc.stdout.splitlines():
        if line.startswith(f'{{"{key}"'):
            return json.loads(line)[key]
    raise AssertionError(f"the CLI printed no {key} line")


def _cli_rate(proc) -> float:
    """The production particle-steps/s that ``simulate`` printed."""
    line = next(x for x in proc.stdout.splitlines() if "particle-steps/s" in x)
    return float(line.split("(")[1].split(" particle-steps/s")[0])


def _write_cfg(tmp: str, name: str, cfg) -> str:
    """``cfg`` as a JSON config file in ``tmp``; returns its path."""
    keys = ("num_cells", "total_steps", "output_interval", "warmup_steps", "dt", "box_length",
            "rc_over_box", "target_total_energy", "dtype", "seed", "compensated_sum",
            "neighbor_skin", "neighbor_capacity")
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump({k: getattr(cfg, k) for k in keys}, f)
    return path


FULL_KERNELS = ("pencil_sweep_full", "pencil_sweep_zband")
MAIN_KERNELS = (("pair_sweep_tri", "pair_sweep", "fused_dense_chunk", "fused_dense_chunk_ext")
                + ZSORT_KERNELS + PENCIL_KERNELS + FULL_KERNELS + RECT_KERNELS
                + EXPERIMENT_KERNELS + REPLICA_KERNELS + REPLICA_HOP_KERNELS
                + REPLICA_ZSORT_KERNELS)


def _cli_run(name: str, cfg, backend: str, tmp: str, needed: tuple, forbidden: tuple) -> dict:
    """One ``python -m ljmd_tpu_torch simulate`` run on the card; the counts
    are the CLI process's own (it starts at 0 and prints them at the end)."""
    import numpy as np

    out_dir = os.path.join(tmp, name)
    proc, wall = _cli(name, ["simulate", "--config", _write_cfg(tmp, name, cfg),
                             "--out-dir", out_dir, "--device", DEVICE, "--backend", backend])
    counts = _cli_json(proc, "kernel_launches")
    host_reads = _cli_json(proc, "host_reads")
    diagnostics = _cli_json(proc, "diagnostics")
    rate = _cli_rate(proc)
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


def phase_rows_ordered(torch, tmp: str, same_forces: bool) -> tuple[dict, float]:
    """The rows engine with ``triangular=False`` on the N=4000 cut (warmup
    by the default rows engine, untimed), then in float64 from one state
    against ``triangular=True``: the sampled series within CROSS_TOL. Where
    kernels 5 and 2 gave bit-identical forces with equal plans
    (``phase_ordered_vs_tri``: ``same_forces``) the two follow one
    trajectory, and the comparison runs the whole 5,000-step cut at its
    interval; otherwise the kernels sum a row's pairs in other orders, the
    fluid's chaos grows that last-bit difference to O(1) over the cut (1.8e-1
    on an H100 with other orders), and it runs CROSS_STEPS steps, each one
    sampled (so each runs kernel 5 or kernel 2)."""
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
    if same_forces:
        cfg64 = cfg.replace(dtype="float64")
    else:
        cfg64 = cfg.replace(dtype="float64", total_steps=CROSS_STEPS, warmup_steps=0,
                            output_interval=1)
    s64 = state.to(dtype=torch.float64)
    series = [run_production(cfg64, s64, engine=pe._rows_engine(cfg64, DEVICE, triangular=tri),
                             device=DEVICE).series for tri in (False, True)]
    scale = series[1].abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    cross = float(((series[0] - series[1]).abs() / scale).max())
    log(f"rows triangular=False vs True (N={cfg.n}, float64, {cfg64.total_steps} steps from one "
        f"state, sampled every {cfg64.output_interval}; kernels 5 and 2 "
        f"{'bit-identical' if same_forces else 'in other orders'}): series rel diff "
        f"{cross:.3e} (tol {CROSS_TOL:.0e})")
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
    grid, its work items in rounds over the blocks the card holds): from
    ``state`` in
    float64, ROWS62500_STEPS fused steps against the unfused cell-pair
    engine at the same chunk, within CROSS_TOL (summation order only); then
    its float32 ms per step over ROWS62500_STEPS after one untimed chunk."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops import fused
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
    n_pad = -(-cfg.n // pe.ROW_PAD) * pe.ROW_PAD
    out["plans"] = {d: fused.dense_plan(torch.zeros((8, n_pad), dtype=t, device=dev))
                    for d, t in (("float32", torch.float32), ("float64", torch.float64))}
    require(out["f32_launches"].get("fused_dense_chunk", 0) == 1,
            "rows at N=62500: one fused chunk expected")
    require(bool(torch.isfinite(c.v).all()), "rows at N=62500 float32: non-finite velocities")
    LAUNCHES.reset()
    log(f"rows at N={cfg.n} (config 5, persistent grid): float64 {k} fused steps vs the "
        f"unfused cell-pair engine max rel diff over r, ru, v, a {out['f64_vs_cellpair']:.3e} "
        f"(tol {CROSS_TOL:.0e}), {out['f64_ms_per_step']:.3f} ms/step; float32 "
        f"{out['f32_ms_per_step']:.3f} ms/step; dense chunk float32: "
        f"{plan_text(out['plans']['float32'])}; float64: {plan_text(out['plans']['float64'])}")
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


# ---------------------------------------------------------------- phase 10
def _rel_scale_err(got, want) -> float:
    """max |got - want| / max |want| (NaN-free arrays)."""
    import numpy as np

    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    require(got.shape == want.shape, f"shapes {got.shape} and {want.shape} differ")
    require(bool(np.isfinite(got).all() and np.isfinite(want).all()), "non-finite values")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _summary_diff(got, want, path: str = "") -> float:
    """Worst relative difference of two analysis summaries (the same keys,
    strings and counts equal, NaN where the other has NaN)."""
    if isinstance(want, dict):
        require(set(got) == set(want), f"summary keys differ at {path}: {set(got) ^ set(want)}")
        return max([_summary_diff(got[k], want[k], f"{path}.{k}") for k in want] or [0.0])
    if isinstance(want, float) or isinstance(got, float):
        if math.isnan(want) or math.isnan(got):
            require(math.isnan(want) and math.isnan(got), f"NaN at {path}: {got} vs {want}")
            return 0.0
        return abs(got - want) / max(abs(want), 1e-300)
    require(got == want, f"summary differs at {path}: {got!r} vs {want!r}")
    return 0.0


def phase_analysis(torch, tmp: str) -> dict:
    """BASELINE config 3 (N=4000 with g(r), MSD, VACF, D) on the card:
    ``simulate --stream`` of the cut config (``auto`` -> zsort), then
    ``analyze --no-plots --device cuda``; in process on the same rva.dat,
    compute_msd / compute_vacf / compute_rdf on the card against the same
    functions on the CPU, and the card's analysis_summary.json against
    ``analyze_run`` on the CPU, each within ANALYSIS_TOL."""
    from ljmd_tpu_torch.analysis.msd_vacf import compute_msd, compute_vacf
    from ljmd_tpu_torch.analysis.rdf import compute_rdf
    from ljmd_tpu_torch.analysis.report import analyze_run
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import auto_backend
    from ljmd_tpu_torch.utils.native import read_rva_native

    cfg = load_config(str(REPO / "examples" / "n4000_production.json")).replace(**ANALYSIS_CUT)
    require(auto_backend(cfg, True, cfg.output_interval) == "zsort",
            "auto does not route config 3 to zsort")
    run_dir = os.path.join(tmp, "n4000_analysis")
    proc, wall = _cli("n4000_stream", ["simulate", "--config", _write_cfg(tmp, "n4000_an", cfg),
                                       "--out-dir", run_dir, "--device", DEVICE, "--stream"])
    counts = _cli_json(proc, "kernel_launches")
    _check_launches("n4000_f32_zsort_stream", counts, ZSORT_KERNELS,
                    ("fused_dense_chunk",) + PENCIL_KERNELS)
    diagnostics = _cli_json(proc, "diagnostics")
    require(not any(diagnostics.values()), f"config 3 stream: diagnostics {diagnostics}")
    stream = _cli_json(proc, "stream")
    require(stream["writer"] == "native", f"config 3 stream: writer {stream['writer']}")
    require("Python writer" not in proc.stderr, "config 3 stream: the Python writer ran")
    _check_artifacts(run_dir, with_frames=True)
    rate = _cli_rate(proc)
    rva_mb = os.path.getsize(os.path.join(run_dir, "rva.dat")) / 1e6

    an, an_wall = _cli("analyze", ["analyze", "--run-dir", run_dir, "--no-plots", "--device",
                                   DEVICE])
    with open(os.path.join(run_dir, "analysis_summary.json")) as f:
        card_summary = json.load(f)
    traj = card_summary["trajectory"]
    n_frames = (cfg.total_steps - cfg.warmup_steps) // cfg.output_interval
    require(traj["n_snapshots"] == n_frames, f"analysis read {traj['n_snapshots']} frames, "
                                             f"expected {n_frames}")

    data = read_rva_native(os.path.join(run_dir, "rva.dat"))
    frames = {k: torch.as_tensor(getattr(data, k), dtype=torch.float64) for k in ("ru", "v", "r")}
    dev = {k: v.to(DEVICE) for k, v in frames.items()}
    max_lag = traj["max_lag"]
    fns = {"compute_msd": (lambda f: compute_msd(f["ru"], max_lag=max_lag)),
           "compute_vacf": (lambda f: compute_vacf(f["v"], max_lag=max_lag)),
           "compute_rdf": (lambda f: compute_rdf(f["r"], data.box_length))}
    report = {}
    for name, fn in fns.items():
        fn(dev)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        card = fn(dev)
        end.record()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cpu = fn(frames)
        cpu_s = time.perf_counter() - t0
        err = _rel_scale_err(card.cpu().numpy(), cpu.numpy())
        report[name] = {"card_ms": start.elapsed_time(end), "cpu_ms": 1e3 * cpu_s,
                        "rel_err": err, "points": int(card.shape[0])}
        require(err <= ANALYSIS_TOL, f"{name}: card and CPU differ by {err:.3e} of the scale")
    t0 = time.perf_counter()
    cpu_summary = analyze_run(run_dir, make_plots=False, device="cpu")
    cpu_summary_s = time.perf_counter() - t0
    summary_err = _summary_diff(card_summary, cpu_summary)
    require(summary_err <= ANALYSIS_TOL,
            f"analysis_summary.json: card and CPU differ by {summary_err:.3e}")
    log(f"config 3 analysis (N={cfg.n}, {n_frames} frames, rva.dat {rva_mb:.1f} MB, max_lag "
        f"{max_lag}, float64): " + ", ".join(
            f"{k} card {v['card_ms']:.3f} ms, CPU {v['cpu_ms']:.1f} ms, rel err {v['rel_err']:.3e}"
            for k, v in report.items())
        + f"; summary card vs CPU {summary_err:.3e} (tol {ANALYSIS_TOL:.0e}); D_einstein "
        f"{traj['D_einstein']:.6g}, D_green_kubo {traj['D_green_kubo']:.6g} (logged only: the VACF "
        f"is sampled every {cfg.dt * cfg.output_interval:g} tau); analyze CLI wall {an_wall:.1f}s, "
        f"CPU analyze_run {cpu_summary_s:.1f}s; stream production {rate:.4e} particle-steps/s, "
        f"{json.dumps(stream)}")
    return {"run": {"engine": "auto", "n": cfg.n, "wall_s": wall, "particle_steps_per_s": rate,
                    "diagnostics": diagnostics, "launches": counts, "stream": stream},
            "functions": report, "summary_rel_err": summary_err,
            "D_einstein": traj["D_einstein"], "D_green_kubo": traj["D_green_kubo"]}


# ---------------------------------------------------------------- phase 11
# ---------------------------------------------------------------- phase 12
def replica_stack(torch, num_cells: int, box: float, replicas: int, dtype, seed: int):
    """R seeded perturbed-FCC boxes as (R, 8, n_pad) rows and velocities."""
    parts = [perturbed_fcc(num_cells, box, seed + q, torch, dtype, torch.device(DEVICE))
             for q in range(replicas)]
    return parts[0][0], torch.stack([p[1] for p in parts]), torch.stack([p[2] for p in parts])


def replica_checks(torch, fn, stacks: tuple, got: tuple, picks, col: int = 3) -> dict:
    """Replica q of ``got`` (``fn`` on the stacks) against ``fn`` on replica
    q alone for q in ``picks``, bit for bit; and a NaN planted in one
    position of replica 5 (column ``col``, an active row): that replica's
    first output changes (a NaN position fails every cutoff test, so its
    pairs drop out) and every other replica's bits stay as they were."""
    bits = {}
    for q in picks:
        alone = fn(*(s[q].contiguous() for s in stacks))
        bits[q] = all(bool(torch.equal(g[q], w)) for g, w in zip(got, alone))
    bad = [s.clone() for s in stacks]
    bad[0][5, 0, col] = float("nan")
    out = fn(*bad)
    keep = [q for q in range(stacks[0].shape[0]) if q != 5]
    nan_isolated = (not bool(torch.equal(out[0][5], got[0][5]))
                    and all(bool(torch.equal(o[keep], g[keep])) for o, g in zip(out, got)))
    return {"bit_identical_to_alone": bits, "nan_isolated": nan_isolated}


def phase_ensemble_kernels(torch) -> dict:
    """Phase 12a: the replica launches of kernels 2, 3 and 4 against their
    batched twins, against one-replica launches bit for bit, with a planted
    NaN; one replica launch timed against the R one-replica launches it
    replaces (back to back; kernel 2 also on the card alone)."""
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.ops import fused, pair_sweep

    cfg = load_config(str(REPO / "examples" / "ensemble64.json"))
    reps, k, box, rc2, dt = cfg.n_runs, cfg.num_cells, cfg.box_length, cfg.rc_square, cfg.dt
    steps = cfg.output_interval - 1
    label = f"R={reps} N={cfg.n}"
    cases = {name: [] for name in REPLICA_KERNELS}
    for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        tol = KERNEL_TOL[dname]
        n, r, v = replica_stack(torch, k, box, reps, dtype, 4000)
        a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc2)
        cand = reps * (n * (n - 1) // 2)
        cut = sum(pairs_within(torch, r[q, 0:3, :n].T, box, rc2) for q in range(reps))
        rows_bytes = 8 * r.shape[-1] * r.element_size() * reps
        singles = [(r[q].contiguous(), v[q].contiguous(), a[q].contiguous()) for q in range(reps)]

        def tri(p):
            return (pair_sweep.pair_sweep_tri(p, n, box, rc2),)

        got = tri(r)
        want = pair_sweep.pair_sweep_tri_plain(r, n, box, rc2)
        errs = [rel_err(got[0][:, row], want[:, row]) for row in range(6)]
        worst = max(e[1] for e in errs)
        tag = f"pair_sweep_tri_replicas {label} {dname}"
        require(worst <= tol, f"{tag}: rel err {worst:.3e} > {tol}")
        checks = replica_checks(torch, tri, (r,), got, ENSEMBLE_BIT_REPLICAS)
        require(all(checks["bit_identical_to_alone"].values()) and checks["nan_isolated"],
                f"{tag}: replicas not independent: {checks}")
        launch = pair_sweep.rows_sweep_plan(r[0], n)
        launch = {**launch, "replicas": reps, "blocks": launch["blocks"] * reps,
                  "items": launch["items"] * reps}
        cases["pair_sweep_tri_replicas"].append({
            **bound(dname, sweep_flops(cand, cut, True), 2 * rows_bytes),
            "shape": label, "dtype": dname, "max_abs_err": max(e[0] for e in errs),
            "rel_err": worst, **checks, "launch": launch,
            "ms": cuda_time_ms(torch, lambda: tri(r), 50),
            "card_ms": graph_ms(torch, lambda: tri(r), 20),
            "loop_ms": cuda_time_ms(torch, lambda: [tri(s[0]) for s in singles], 10),
            "loop_card_ms": graph_ms(torch, lambda: [tri(s[0]) for s in singles], 5),
            "plain_ms": cuda_time_ms(torch, lambda: pair_sweep.pair_sweep_tri_plain(
                r, n, box, rc2), 5)})

        def chunk(r_, v_, a_):
            return fused.fused_dense_chunk(r_, v_, a_, n, box, rc2, dt, steps)

        got = chunk(r, v, a)
        want = fused.fused_dense_chunk_plain(r, v, a, n, box, rc2, dt, steps)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        worst = max(e[1] for e in errs)
        tag = f"fused_dense_chunk_replicas {label} {dname}"
        require(worst <= tol, f"{tag}: rel err {worst:.3e} > {tol}")
        checks = replica_checks(torch, chunk, (r, v, a), got, ENSEMBLE_BIT_REPLICAS)
        plan = fused.dense_plan(r)
        full = fused._launch("fused_dense_chunk", False, r, None, v, None, a, n, box, rc2, dt,
                             steps)
        capped = fused._launch("fused_dense_chunk", False, r, None, v, None, a, n, box, rc2, dt,
                               steps, grid_cap=max(1, plan["items"] // TILES_PER_BLOCK))
        checks["capped_grid_bit_identical"] = all(
            g is None or bool(torch.equal(g, w)) for g, w in zip(capped, full))
        require(all(checks["bit_identical_to_alone"].values()) and checks["nan_isolated"]
                and checks["capped_grid_bit_identical"], f"{tag}: replicas not independent "
                                                          f"or grid-dependent: {checks}")
        cases["fused_dense_chunk_replicas"].append({
            **bound(dname, chunk_flops(steps, cand, cut, reps * n), 6 * rows_bytes),
            "shape": label, "dtype": dname, "steps": steps,
            "max_abs_err": max(e[0] for e in errs), "rel_err": worst, **checks, "plan": plan,
            "ms": cuda_time_ms(torch, lambda: chunk(r, v, a), 20),
            "loop_ms": cuda_time_ms(torch, lambda: [chunk(*s) for s in singles], 5),
            "plain_ms": cuda_time_ms(torch, lambda: fused.fused_dense_chunk_plain(
                r, v, a, n, box, rc2, dt, steps), 1, warmup=1)})

    # Kernel 4: R=8 replicas of the reference default's box (N=500, rc=4.9,
    # dt=1e-4, float32), its 99-step chunk; checked over 10 steps.
    ext_label, ek, ebox, erc = SHAPES[0]
    erc2, edt, ereps = erc * erc, 1e-4, ENSEMBLE_EXT_R
    n, r, v = replica_stack(torch, ek, ebox, ereps, torch.float32, 5000)
    a = 24.0 * pair_sweep.pair_forces_plain(r, n, ebox, erc2)
    zero = torch.zeros_like(r)

    def ext(steps_):
        def fn(r_, lo_, v_, vc_, a_):
            return fused.fused_dense_chunk_ext(r_, lo_, v_, vc_, a_, n, ebox, erc2, edt, steps_)
        return fn

    got = ext(10)(r, zero, v, zero, a)
    want = fused.fused_dense_chunk_ext_plain(r, zero, v, zero, a, n, ebox, erc2, edt, 10)
    errs = [rel_err(g, w) for g, w in ((got[0].double() + got[1].double(),
                                        want[0].double() + want[1].double()),
                                       (got[2].double() + got[3].double(),
                                        want[2].double() + want[3].double()),
                                       (got[4], want[4]))]
    worst = max(e[1] for e in errs)
    label = f"R={ereps} {ext_label}"
    tag = f"fused_dense_chunk_ext_replicas {label} float32"
    require(worst <= KERNEL_TOL["float32"], f"{tag}: rel err {worst:.3e}")
    checks = replica_checks(torch, ext(10), (r, zero, v, zero, a), got, (0, 3, ereps - 1))
    require(all(checks["bit_identical_to_alone"].values()) and checks["nan_isolated"],
            f"{tag}: replicas not independent: {checks}")
    singles = [tuple(t[q].contiguous() for t in (r, zero, v, zero, a)) for q in range(ereps)]
    cand = ereps * (n * (n - 1) // 2)
    cut = sum(pairs_within(torch, r[q, 0:3, :n].T, ebox, erc2) for q in range(ereps))
    cases["fused_dense_chunk_ext_replicas"].append({
        **bound("float32", chunk_flops(CHUNK_STEPS, cand, cut, ereps * n),
                10 * 8 * r.shape[-1] * r.element_size() * ereps),
        "shape": label, "dtype": "float32", "steps": CHUNK_STEPS,
        "max_abs_err": max(e[0] for e in errs), "rel_err": worst, **checks,
        "plan": fused.dense_plan(r, True),
        "ms": cuda_time_ms(torch, lambda: ext(CHUNK_STEPS)(r, zero, v, zero, a), 5),
        "loop_ms": cuda_time_ms(torch, lambda: [ext(CHUNK_STEPS)(*s) for s in singles], 3),
        "plain_ms": cuda_time_ms(torch, lambda: fused.fused_dense_chunk_ext_plain(
            r, zero, v, zero, a, n, ebox, erc2, edt, CHUNK_STEPS), 1, warmup=1)})
    for name, cs in cases.items():
        for c in cs:
            bits = all(c["bit_identical_to_alone"].values())
            extra = (f", on the card alone {c['card_ms']:.4f} ms (R one-replica launches "
                     f"{c['loop_card_ms']:.4f}); {rows_plan_text(c['launch'])}"
                     if "card_ms" in c else f"; {plan_text(c['plan'])}, {c['steps']} steps")
            log(f"kernel {name} {c['shape']} {c['dtype']}: rel err {c['rel_err']:.3e} (tol "
                f"{KERNEL_TOL[c['dtype']]:.0e}), replicas {list(c['bit_identical_to_alone'])} "
                f"bit-identical to one-replica launches {bits}, planted NaN isolated "
                f"{c['nan_isolated']}" + (f", capped grid bit-identical "
                                          f"{c['capped_grid_bit_identical']}"
                                          if "capped_grid_bit_identical" in c else "")
                + f"; one replica launch {c['ms']:.4f} ms against the R one-replica launches "
                f"back to back {c['loop_ms']:.4f} ms ({c['loop_ms'] / c['ms']:.1f}x), plain "
                f"{c['plain_ms']:.4f} ms; bound {c['bound_ms']:.4f} ms ({c['bound_by']})"
                + extra)
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


def replica_case(torch, name: str, label: str, dname: str, fn, twin, stacks: tuple,
                 flops: float, nbytes: float, col: int = 3, card: bool = True,
                 compare=None, reps: int = 50, loop_reps: int = 10, plain_reps: int = 3) -> dict:
    """One replica launch (``fn`` on the (R, ...) ``stacks``) against its
    twin (``compare`` maps both outputs to the arrays compared), replicas 0,
    R/2 and R-1 against one-replica launches bit for bit, a planted NaN
    (``replica_checks``); timed back to back (``ms``), the R one-replica
    launches it replaces back to back (``loop_ms``), with ``card`` both on
    the card alone too (``card_ms``, ``loop_card_ms``), and the twin."""
    reps_r = stacks[0].shape[0]
    tol = KERNEL_TOL[dname]
    got = fn(*stacks)
    torch.cuda.synchronize()
    t0 = time.time()
    want = twin(*stacks)
    torch.cuda.synchronize()
    twin_ms = 1e3 * (time.time() - t0)
    cg, cw = (compare(got), compare(want)) if compare else (got, want)
    errs = [rel_err(g, w) for g, w in zip(cg, cw)]
    worst = max(e[1] for e in errs)
    tag = f"{name} {label} {dname}"
    require(worst <= tol, f"{tag}: rel err {worst:.3e} > {tol}")
    checks = replica_checks(torch, fn, stacks, got, (0, reps_r // 2, reps_r - 1), col)
    require(all(checks["bit_identical_to_alone"].values()) and checks["nan_isolated"],
            f"{tag}: replicas not independent: {checks}")
    singles = [tuple(x[q].contiguous() for x in stacks) for q in range(reps_r)]
    case = {**bound(dname, flops, nbytes), "shape": label, "dtype": dname, "replicas": reps_r,
            "max_abs_err": max(e[0] for e in errs), "rel_err": worst, **checks,
            "ms": cuda_time_ms(torch, lambda: fn(*stacks), reps),
            "loop_ms": cuda_time_ms(torch, lambda: [fn(*x) for x in singles], loop_reps),
            # plain_reps 0: the comparison's own call of the twin (host clock
            # after a synchronize), for twins that take seconds
            "plain_ms": (cuda_time_ms(torch, lambda: twin(*stacks), plain_reps, warmup=1)
                         if plain_reps else twin_ms)}
    if card:
        case["card_ms"] = graph_ms(torch, lambda: fn(*stacks), reps)
        case["loop_card_ms"] = graph_ms(torch, lambda: [fn(*x) for x in singles],
                                        max(1, loop_reps // 2))
    return case


def _replica_block_stacks(torch, which: int, d: int, blocks: tuple, reps: int, dtype,
                          seed: int):
    """R shuffled perturbed lattices of SHAPES[which] cut into d rank blocks:
    (n a rank, [(R, 8, ld) stack of block b for b in ``blocks``], [each
    replica's (n, 3) rows of each block])."""
    import numpy as np

    dev = torch.device(DEVICE)
    _, k, box, _ = SHAPES[which]
    per = {b: [] for b in blocks}
    for q in range(reps):
        n, lattice, _ = perturbed_fcc(k, box, seed + q, torch, dtype, dev)
        r = lattice.clone()
        r[:, :n] = r[:, torch.as_tensor(np.random.default_rng(seed + q).permutation(n),
                                        device=dev)]
        ni = n // d
        for b in blocks:
            out = torch.zeros((8, -(-ni // 128) * 128), dtype=dtype, device=dev)
            out[:, :ni] = r[:, b * ni:(b + 1) * ni]
            per[b].append(out)
    return ni, [torch.stack(per[b]) for b in blocks]


def replica_launch(plan: dict, replicas: int) -> dict:
    """A row-sweep kernel's one-replica launch shape (``rows_sweep_plan``,
    ``rect_newton_plan``) as its replica launch's: ``blockIdx.y`` the
    replica, so R times the blocks and live blocks."""
    return {**plan, "replicas": replicas, "blocks": plan["blocks"] * replicas,
            "items": plan["items"] * replicas}


def phase_replica_kernels(torch) -> dict:
    """Phase 12a': the replica launches of kernels 6, 7, 9 and 10
    (REPLICA_HOP_KERNELS, REPLICA_ZSORT_KERNELS) against their twins, against
    one-replica launches bit for bit (replicas 0, mid, last), with a planted
    NaN (kernel 9: planted flags), each timed against the R one-replica
    launches it replaces (``loop_ms``; kernels 6, 7 and 9 also on the card
    alone)."""
    import numpy as np

    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import zsort_geometry
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import fused_list, pair_sweep, window_lists
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    cases = {name: [] for name in ("pair_sweep_tri_replicas",) + REPLICA_HOP_KERNELS
             + REPLICA_ZSORT_KERNELS}
    ens = load_config(str(REPO / "examples" / "ensemble64.json"))
    for dname, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        # Kernel 7: the half ring's full hop at N=4000 d=4 (block 1 visiting
        # block 0's rows), R=8, observables off (the fast steps) and on.
        _, _, box, rc = SHAPES[1]
        rc2 = rc * rc
        ni, (pi, pj) = _replica_block_stacks(torch, 1, 4, (0, 1), REPLICA_HOP_R, dtype, 1500)
        cand = cut = 0
        for q in range(REPLICA_HOP_R):
            c_, k_ = block_pairs(torch, pi[q, 0:3, :ni].T, pj[q, 0:3, :ni].T, box, rc2, 0, ni)
            cand, cut = cand + c_, cut + k_
        rows_bytes = 8 * pi.shape[-1] * pi.element_size() * REPLICA_HOP_R
        for want_obs in (False, True):
            def newton(a, b, obs=want_obs):
                return pair_sweep.pair_sweep_rect_newton(a, b, ni, ni, 0, ni, box, rc2, 0, ni,
                                                         obs)

            def newton_twin(a, b, obs=want_obs):
                return pair_sweep.pair_sweep_rect_newton_plain(a, b, ni, ni, 0, ni, box, rc2, 0,
                                                               ni, obs)

            c = replica_case(torch, "pair_sweep_rect_newton_replicas",
                             f"R={REPLICA_HOP_R} N=4000 d=4 hop", dname, newton, newton_twin,
                             (pi, pj), sweep_flops(cand, cut, want_obs), 4 * rows_bytes)
            c.update(observables=want_obs, candidates=cand, cut_pairs=cut,
                     launch=replica_launch(pair_sweep.rect_newton_plan(
                         pi[0], pj[0], ni, ni, 0, ni, want_obs), REPLICA_HOP_R))
            cases["pair_sweep_rect_newton_replicas"].append(c)
        # Kernel 7 at config 4's d=2 half hop: the low rank's i rows [64, 128)
        # against the visiting block's [0, 128), R=32 (a row of the (2, 2)
        # mesh holds 32 of the 64 replicas).
        box4, rc4 = ens.box_length, ens.rc_square
        ni4 = ens.n // 2
        stacks, halves = [], []
        for q in range(REPLICA_HALF_R):
            rng = np.random.default_rng(2500 + q)
            r = fcc_lattice(ens.num_cells, box4, dtype=torch.float64).numpy()
            r = np.mod(r + rng.normal(scale=0.04 * box4 / ens.num_cells, size=r.shape), box4)
            r = r[rng.permutation(len(r))]
            halves.append([torch.as_tensor(r[b * ni4:(b + 1) * ni4], device=dev)
                           for b in (0, 1)])
        for b in (0, 1):
            st = torch.zeros((REPLICA_HALF_R, 8, 128), dtype=dtype, device=dev)
            for q in range(REPLICA_HALF_R):
                st[q, 0:3, :ni4] = halves[q][b].T.to(dtype)
            stacks.append(st)
        cand = cut = 0
        for q in range(REPLICA_HALF_R):
            c_, k_ = block_pairs(torch, halves[q][0], halves[q][1], box4, rc4, 0, ni4,
                                 ni4 // 2, ni4)
            cand, cut = cand + c_, cut + k_

        block_bytes = 8 * 128 * stacks[0].element_size() * REPLICA_HALF_R
        for want_obs in (False, True):
            def half(a, b, obs=want_obs):
                return pair_sweep.pair_sweep_rect_newton(a, b, ni4, ni4, 0, ni4, box4, rc4,
                                                         ni4 // 2, ni4, obs)

            def half_twin(a, b, obs=want_obs):
                return pair_sweep.pair_sweep_rect_newton_plain(a, b, ni4, ni4, 0, ni4, box4,
                                                               rc4, ni4 // 2, ni4, obs)

            c = replica_case(torch, "pair_sweep_rect_newton_replicas",
                             f"R={REPLICA_HALF_R} N=256 d=2 half hop", dname, half, half_twin,
                             tuple(stacks), sweep_flops(cand, cut, want_obs), 4 * block_bytes,
                             col=ni4 - 1)
            c.update(observables=want_obs, candidates=cand, cut_pairs=cut,
                     launch=replica_launch(pair_sweep.rect_newton_plan(
                         stacks[0][0], stacks[1][0], ni4, ni4, ni4 // 2, ni4, want_obs),
                         REPLICA_HALF_R))
            cases["pair_sweep_rect_newton_replicas"].append(c)

        # Kernel 6 at config 4's d=2 ring, R=32: the high rank's first sweep
        # (its own block, gi0 = gj0: the i != j exclusion) and its second
        # (the visiting low block), observables off and on (the ring's steps).
        for role, (bj, gj0) in (("self", (1, ni4)), ("hop", (0, 0))):
            cand = cut = 0
            for q in range(REPLICA_HALF_R):
                c_, k_ = block_pairs(torch, halves[q][1], halves[q][bj], box4, rc4, ni4, gj0)
                cand, cut = cand + c_, cut + k_
            for want_obs in (False, True):
                def ring(a, b, obs=want_obs, gj0=gj0):
                    return (pair_sweep.pair_sweep_rect(a, b, ni4, ni4, ni4, gj0, box4, rc4,
                                                       obs),)

                def ring_twin(a, b, obs=want_obs, gj0=gj0):
                    return (pair_sweep.pair_sweep_rect_plain(a, b, ni4, ni4, ni4, gj0, box4,
                                                             rc4, obs),)

                c = replica_case(torch, "pair_sweep_rect_replicas",
                                 f"R={REPLICA_HALF_R} N=256 d=2 {role}", dname, ring, ring_twin,
                                 (stacks[1], stacks[bj]), sweep_flops(cand, cut, want_obs),
                                 3 * block_bytes)
                c.update(observables=want_obs, candidates=cand, cut_pairs=cut,
                         launch=replica_launch(pair_sweep.rows_sweep_plan(
                             stacks[1][0], ni4, stacks[bj][0], ni4, want_obs), REPLICA_HALF_R))
                cases["pair_sweep_rect_replicas"].append(c)

        # Kernel 2 at config 4's d=2 half ring, R=32: the low rank's self
        # block (128 rows), observables off and on (the half ring's steps).
        cand = REPLICA_HALF_R * (ni4 * (ni4 - 1) // 2)
        cut = sum(pairs_within(torch, halves[q][0], box4, rc4) for q in range(REPLICA_HALF_R))
        for want_obs in (False, True):
            def tri(a, obs=want_obs):
                return (pair_sweep.pair_sweep_tri(a, ni4, box4, rc4, obs),)

            def tri_twin(a, obs=want_obs):
                return (pair_sweep.pair_sweep_tri_plain(a, ni4, box4, rc4, obs),)

            c = replica_case(torch, "pair_sweep_tri_replicas",
                             f"R={REPLICA_HALF_R} N=256 d=2 self block", dname, tri, tri_twin,
                             (stacks[0],), sweep_flops(cand, cut, want_obs), 2 * block_bytes)
            c.update(observables=want_obs, candidates=cand, cut_pairs=cut,
                     launch=replica_launch(pair_sweep.rows_sweep_plan(
                         stacks[0][0], ni4, want_observables=want_obs), REPLICA_HALF_R))
            cases["pair_sweep_tri_replicas"].append(c)

        # Kernel 6: the ring's hop at N=4000 d=2 (2000 x 2000), R=8.
        ni, (pi, pj) = _replica_block_stacks(torch, 1, 2, (0, 1), REPLICA_HOP_R, dtype, 1600)
        cand = cut = 0
        for q in range(REPLICA_HOP_R):
            c_, k_ = block_pairs(torch, pi[q, 0:3, :ni].T, pj[q, 0:3, :ni].T, box, rc2, 0, ni)
            cand, cut = cand + c_, cut + k_
        rows_bytes = 8 * pi.shape[-1] * pi.element_size() * REPLICA_HOP_R
        for want_obs in (False, True):
            def rect(a, b, obs=want_obs):
                return (pair_sweep.pair_sweep_rect(a, b, ni, ni, 0, ni, box, rc2, obs),)

            def rect_twin(a, b, obs=want_obs):
                return (pair_sweep.pair_sweep_rect_plain(a, b, ni, ni, 0, ni, box, rc2, obs),)

            c = replica_case(torch, "pair_sweep_rect_replicas",
                             f"R={REPLICA_HOP_R} N=4000 d=2 hop", dname, rect, rect_twin,
                             (pi, pj), sweep_flops(cand, cut, want_obs), 3 * rows_bytes,
                             plain_reps=1)
            c.update(observables=want_obs, candidates=cand, cut_pairs=cut,
                     launch=replica_launch(pair_sweep.rows_sweep_plan(pi[0], ni, pj[0], ni,
                                                                      want_obs), REPLICA_HOP_R))
            cases["pair_sweep_rect_replicas"].append(c)

        # Kernels 9 and 10 at config 2's N=864 (the zsort geometry: n_pad 896,
        # tile_j 512), R=64 sorted fluids, the 16-step chunk.
        zcfg = load_config(str(REPO / "examples" / "n864_liquid.json"))
        geo = zsort_geometry(zcfg, inner_chunk=LIST_CHUNK_STEPS)
        L, n_pad, tj, k = zcfg.box_length, geo.n_pad, geo.tile_j, LIST_CHUNK_STEPS
        parts = [sorted_fluid(zcfg, n_pad, 6000 + q, torch, dtype, dev)
                 for q in range(REPLICA_LIST_R)]
        n = parts[0][0]
        r, v, a = (torch.stack([x[i] for x in parts]) for i in (1, 2, 3))
        flags = window_lists.compute_tile_flags(r, n, 128, 128, L, geo.window,
                                                cross_margin=0.6 * geo.sort_skin)
        label = f"R={REPLICA_LIST_R} N={n}"

        def pack(f, zero_fill=True):
            return window_lists.build_window_lists(f, n, n_pad, 128, tj, zero_fill=zero_fill)

        got = pack(flags)
        t0 = time.time()
        want = window_lists.build_window_lists(flags.cpu(), n, n_pad, 128, tj)
        pack_plain_ms = 1e3 * (time.time() - t0)  # the twin (Python, the CPU), once
        require(torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1]),
                f"build_window_lists_replicas {label} {dname}: lists differ from the twin's")
        bits = {q: all(bool(torch.equal(g[q], w)) for g, w in zip(got, pack(flags[q])))
                for q in (0, REPLICA_LIST_R // 2, REPLICA_LIST_R - 1)}
        bad = flags.clone()
        bad[5] = 0  # no active block: replica 5 gets empty lists
        planted = pack(bad)
        keep = [q for q in range(REPLICA_LIST_R) if q != 5]
        isolated = (not bool(torch.equal(planted[1][5], got[1][5]))
                    and all(bool(torch.equal(p[keep], g[keep])) for p, g in zip(planted, got)))
        require(all(bits.values()) and isolated,
                f"build_window_lists_replicas {label} {dname}: replicas not independent "
                f"(bits {bits}, planted flags isolated {isolated})")
        tiles, tcounts = pack(flags, zero_fill=False)
        ops = graph_ops(lambda: pack(flags, False))
        require(ops["ops"] == 1, f"build_window_lists_replicas {label} {dname}: "
                                 f"{ops['nodes']} in one call's graph, the kernel alone expected")
        singles = [flags[q].contiguous() for q in range(REPLICA_LIST_R)]
        cases["build_window_lists_replicas"].append({
            **bound("float32", flags.numel(), 4 * (flags.numel() + tiles.numel()
                                                    + tcounts.numel())),
            "shape": label, "dtype": dname, "replicas": REPLICA_LIST_R, "max_abs_err": 0.0,
            "rel_err": 0.0, "lists_equal": True, "bit_identical_to_alone": bits,
            "planted_flags_isolated": isolated, "device_ops": ops["ops"],
            "visits": int(tcounts.sum()),
            "ms": cuda_time_ms(torch, lambda: pack(flags, False), 50),
            "card_ms": graph_ms(torch, lambda: pack(flags, False), 50),
            "loop_ms": cuda_time_ms(torch, lambda: [pack(f, False) for f in singles], 10),
            "loop_card_ms": graph_ms(torch, lambda: [pack(f, False) for f in singles], 5),
            "plain_ms": pack_plain_ms})

        cand = cut = 0
        for q in range(REPLICA_LIST_R):
            cover = fused_list.list_coverage(tiles[q], tcounts[q], n, n_pad, 128, tj)[0]
            cand += int(cover[:n, :n].sum())
            cut += pairs_within(torch, r[q, 0:3, :n].T, L, zcfg.rc_square)
        rows_bytes = 8 * n_pad * r.element_size() * REPLICA_LIST_R
        zero = torch.zeros_like(r)
        for mode in ("plain", "extended"):
            ext = mode == "extended"
            if ext:
                def chunk(r_, lo_, v_, vc_, a_, t_, c_):
                    return fused_list.fused_dense_chunk_list(r_, v_, a_, t_, c_, n, L,
                                                             zcfg.rc_square, zcfg.dt, k,
                                                             tile_j=tj, r_lo=lo_, vc=vc_)

                def chunk_twin(r_, lo_, v_, vc_, a_, t_, c_):
                    return fused_list.fused_dense_chunk_list_plain(r_, v_, a_, t_, c_, n, L,
                                                                   zcfg.rc_square, zcfg.dt, k,
                                                                   tile_j=tj, r_lo=lo_,
                                                                   vc=vc_)

                stacks = (r, zero, v, zero, a, tiles, tcounts)

                def compare(out):
                    return (out[0].double() + out[1].double(),
                            out[2].double() + out[3].double(), out[4])
            else:
                def chunk(r_, v_, a_, t_, c_):
                    return fused_list.fused_dense_chunk_list(r_, v_, a_, t_, c_, n, L,
                                                             zcfg.rc_square, zcfg.dt, k,
                                                             tile_j=tj)

                def chunk_twin(r_, v_, a_, t_, c_):
                    return fused_list.fused_dense_chunk_list_plain(r_, v_, a_, t_, c_, n, L,
                                                                   zcfg.rc_square, zcfg.dt, k,
                                                                   tile_j=tj)

                stacks, compare = (r, v, a, tiles, tcounts), None
            c = replica_case(torch, "fused_dense_chunk_list_replicas",
                             label + (" extended" if ext else ""), dname, chunk, chunk_twin,
                             stacks, chunk_flops(k, cand, cut, REPLICA_LIST_R * n),
                             (10 if ext else 6) * rows_bytes, card=False, compare=compare,
                             reps=10, loop_reps=2, plain_reps=0)
            plan = fused_list.list_replicas_plan(r, ext)
            largs = (r, v, a, tiles, tcounts, n, L, zcfg.rc_square, zcfg.dt, k, 128, tj,
                     zero if ext else None, zero if ext else None, False)
            capped = all(bool(torch.equal(g, w)) for g, w in zip(
                fused_list._launch(*largs, grid_cap=max(1, plan["blocks"] // TILES_PER_BLOCK)),
                fused_list._launch(*largs)))
            require(capped, f"fused_dense_chunk_list_replicas {label} {mode} {dname}: a capped "
                            "grid differs from the full grid")
            c.update(steps=k, candidates=cand, cut_pairs=cut, visits=int(tcounts.sum()),
                     capped_grid_bit_identical=capped, plan=plan)
            cases["fused_dense_chunk_list_replicas"].append(c)
    for name, cs in cases.items():
        for c in cs:
            bits = all(c["bit_identical_to_alone"].values())
            card = (f"; on the card alone {c['card_ms']:.4f} ms against the R launches' "
                    f"{c['loop_card_ms']:.4f} ({c['loop_card_ms'] / c['card_ms']:.1f}x)"
                    if "card_ms" in c else "")
            if "launch" in c:
                shape = rows_plan_text(c["launch"])
            elif "plan" in c:
                lp = c["plan"]
                shape = (f"S={lp['slices']} (the one-replica plan's), {lp['items']} items, "
                         f"{'resident' if lp['resident'] else 'streamed'}, grid {lp['blocks']} "
                         f"({lp['blocks_per_sm']} blocks an SM, {lp['regs']} registers, "
                         f"{lp['spill_bytes']} spill bytes), capped grid bit-identical "
                         f"{c['capped_grid_bit_identical']}, {c['steps']} steps")
            else:
                shape = (f"{c['device_ops']} device operation a call, {c['visits']} visits, "
                         f"planted flags isolated {c['planted_flags_isolated']}")
            log(f"kernel {name} {c['shape']} {c['dtype']}"
                + (f" observables {c['observables']}" if "observables" in c else "")
                + f": rel err {c['rel_err']:.3e} (tol {KERNEL_TOL[c['dtype']]:.0e}), replicas "
                f"{list(c['bit_identical_to_alone'])} bit-identical to one-replica launches "
                f"{bits}" + (f", planted NaN isolated {c['nan_isolated']}"
                             if "nan_isolated" in c else "")
                + f"; one replica launch {c['ms']:.4f} ms back to back against the R "
                f"one-replica launches {c['loop_ms']:.4f} ({c['loop_ms'] / c['ms']:.1f}x){card};"
                f" plain {c['plain_ms']:.4f} ms; bound {c['bound_ms']:.5f} ms ({c['bound_by']}); "
                + shape)
    LAUNCHES.reset()  # comparison launches do not count for the main path
    return cases


def phase_replica_particle(torch) -> dict:
    """Phase 12g: config 4 (64 x N=256, float32) through the
    replica x particle half-ring step on a (replica=2, particle=2) thread
    mesh on the card for REPLICA_PARTICLE_CUT's steps from the batched rows
    engine's post-warmup states, the observables each step, etot sampled
    every interval: launches of the replica kernels only, the aggregate rate
    and ms a step; replicas REPLICA_PARTICLE_BITS bit for bit against
    ``make_spatial_step_fn`` on a particle=2 mesh run on that replica alone;
    the drift (median under DRIFT_BOUND, the worst within
    DRIFT_VS_SINGLE["float32"] x the batched rows engine's worst on the same
    cut and cadence from the same states); float64 against the batched rows
    engine over CROSS_STEPS (CROSS_TOL); REPLICA_RING_STEPS of the ring
    (kernel 6's replica launch), its replicas REPLICA_PARTICLE_BITS bit for
    bit against ``make_spatial_engine(comm="ring")`` on a particle=2 mesh
    run on that replica alone. dryrun_multichip(4) runs the same step in
    phase 9b."""
    import numpy as np

    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.models.simulation import initialize_replicas, replica_generators
    from ljmd_tpu_torch.ops._cuda import LAUNCHES
    from ljmd_tpu_torch.parallel import spatial as psp
    from ljmd_tpu_torch.parallel.mesh import make_mesh

    cfg = load_config(str(REPO / "examples" / "ensemble64.json")).replace(
        **REPLICA_PARTICLE_CUT)
    reps, interval, L = cfg.n_runs, cfg.output_interval, cfg.box_length
    n_rep, n_par = REPLICA_PARTICLE_MESH
    states = initialize_replicas(cfg, replica_generators(cfg.seed, reps), device=DEVICE)
    one_system = ("pair_sweep_tri", "pair_sweep_rect", "pair_sweep_rect_newton",
                  "fused_dense_chunk", "fused_dense_chunk_ext") + ZSORT_KERNELS
    out = {"runs": {}}

    mesh = make_mesh(particle=n_par, replica=n_rep, device=DEVICE)
    one_mesh = make_mesh(particle=n_par, device=DEVICE)
    try:
        fn = psp.make_ensemble_spatial_step_fn(cfg, mesh, comm="half_ring")
        c, obs = fn.init(psp.shard_replica_states(states, mesh, cfg))
        etot = [obs.epot + obs.ekin]
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t0 = time.time()
        for s in range(cfg.total_steps):
            c, obs = fn(c)
            if (s + 1) % interval == 0:
                etot.append(obs.epot + obs.ekin)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = LAUNCHES.snapshot()
        name = f"ensemble64_f32_replica_particle_half_ring_{n_rep}x{n_par}"
        _check_launches(name, counts, ("pair_sweep_tri_replicas",
                                       "pair_sweep_rect_newton_replicas"),
                        one_system + ("pair_sweep_rect_replicas",) + REPLICA_ZSORT_KERNELS)
        got = psp.gather_replica_states(c, mesh)
        series = torch.stack(etot, dim=1).cpu()
        drifts = [_drift(series[q]) for q in range(reps)]
        require(all(math.isfinite(x) for x in drifts), f"{name}: non-finite energies")

        # The batched rows engine on the same cut and cadence from the same
        # states: its drift for the gate.
        rows = pe._rows_engine(cfg, DEVICE, replicas=reps)
        rc, robs = rows.init(states)
        r_etot = [robs.epot + robs.ekin]
        for _ in range(cfg.total_steps // interval):
            rc = rows.run_fast(rc, interval - 1)
            rc, robs = rows.step(rc)
            r_etot.append(robs.epot + robs.ekin)
        r_series = torch.stack(r_etot, dim=1).cpu()
        r_drifts = [_drift(r_series[q]) for q in range(reps)]
        limit = DRIFT_VS_SINGLE["float32"]
        require(float(np.median(drifts)) <= DRIFT_BOUND["ensemble64_f32_rows_batched"]
                and max(drifts) <= limit * max(r_drifts),
                f"{name}: |dE/E| median {np.median(drifts):.3e}, max {max(drifts):.3e} against "
                f"the batched rows engine's max {max(r_drifts):.3e} (limit {limit}x)")

        # Replicas against one-replica sharded runs from their states.
        bits = {}
        one = psp.make_spatial_engine(cfg, one_mesh, comm="half_ring")
        for q in REPLICA_PARTICLE_BITS:
            cq, _ = one.init(pe.replica_state(states, q))
            for _ in range(cfg.total_steps):
                cq, _ = one.step(cq)
            want = one.get_state(cq)
            bits[q] = all(bool(torch.equal(getattr(got, f)[q], getattr(want, f)))
                          for f in ("r", "ru", "v", "a"))
        require(all(bits.values()), f"{name}: replicas against one-replica sharded runs: {bits}")

        # float64 against the batched rows engine from the same states.
        cfg64 = cfg.replace(dtype="float64")
        s64 = states.to(dtype=torch.float64)
        fn64 = psp.make_ensemble_spatial_step_fn(cfg64, mesh, comm="half_ring")
        c64, _ = fn64.init(psp.shard_replica_states(s64, mesh, cfg64))
        for _ in range(CROSS_STEPS):
            c64, _ = fn64(c64)
        rows64 = pe._rows_engine(cfg64, DEVICE, replicas=reps)
        ref = rows64.get_state(rows64.run_fast(rows64.init(s64)[0], CROSS_STEPS))
        cross = _cross_diff(torch, psp.gather_replica_states(c64, mesh), ref, L)
        require(cross <= CROSS_TOL, f"{name} float64: {cross:.3e} from the batched rows engine "
                                    f"over {CROSS_STEPS} steps (tol {CROSS_TOL:.0e})")

        # The ring: kernel 6's replica launch.
        ring = psp.make_ensemble_spatial_step_fn(cfg, mesh, comm="ring")
        cr, _ = ring.init(psp.shard_replica_states(states, mesh, cfg))
        torch.cuda.synchronize()
        LAUNCHES.reset()
        t1 = time.time()
        for _ in range(REPLICA_RING_STEPS):
            cr, robs = ring(cr)
        torch.cuda.synchronize()
        ring_s = time.time() - t1
        ring_counts = LAUNCHES.snapshot()
        ring_name = f"ensemble64_f32_replica_particle_ring_{n_rep}x{n_par}"
        _check_launches(ring_name, ring_counts, ("pair_sweep_rect_replicas",),
                        one_system + ("pair_sweep_tri_replicas",
                                      "pair_sweep_rect_newton_replicas")
                        + REPLICA_ZSORT_KERNELS)
        require(bool(torch.isfinite(robs.epot).all()), f"{ring_name}: non-finite observables")
        ring_got = psp.gather_replica_states(cr, mesh)
        ring_bits = {}
        one_ring = psp.make_spatial_engine(cfg, one_mesh, comm="ring")
        for q in REPLICA_PARTICLE_BITS:
            cq, _ = one_ring.init(pe.replica_state(states, q))
            for _ in range(REPLICA_RING_STEPS):
                cq, _ = one_ring.step(cq)
            want = one_ring.get_state(cq)
            ring_bits[q] = all(bool(torch.equal(getattr(ring_got, f)[q], getattr(want, f)))
                               for f in ("r", "ru", "v", "a"))
        require(all(ring_bits.values()),
                f"{ring_name}: replicas against one-replica sharded ring runs: {ring_bits}")
    finally:
        mesh.close()
        one_mesh.close()
    rate = reps * cfg.n * cfg.total_steps / seconds
    ring_rate = reps * cfg.n * REPLICA_RING_STEPS / ring_s
    out["runs"][name] = {"engine": "replica x particle half ring", "n": cfg.n,
                         "replicas": reps, "mesh": list(REPLICA_PARTICLE_MESH),
                         "launches": counts, "production_s": seconds,
                         "particle_steps_per_s": rate,
                         "ms_per_step": 1e3 * seconds / cfg.total_steps,
                         "max_drift": max(drifts), "median_drift": float(np.median(drifts)),
                         "rows_max_drift": max(r_drifts), "bit_identical_to_one_replica": bits,
                         "f64_vs_rows": cross}
    out["runs"][ring_name] = {"engine": "replica x particle ring", "n": cfg.n, "replicas": reps,
                              "launches": ring_counts, "production_s": ring_s,
                              "particle_steps_per_s": ring_rate,
                              "ms_per_step": 1e3 * ring_s / REPLICA_RING_STEPS,
                              "bit_identical_to_one_replica": ring_bits}
    log(f"{name}: R={reps} N={cfg.n} x {cfg.total_steps} steps (observables every step) on a "
        f"(replica={n_rep}, particle={n_par}) thread mesh on the card: {seconds:.3f}s = "
        f"{rate:.4e} aggregate particle-steps/s, {1e3 * seconds / cfg.total_steps:.4f} ms a "
        f"step; replicas {list(bits)} bit-identical to one-replica sharded runs "
        f"{all(bits.values())}; |dE/E| median {np.median(drifts):.3e}, max {max(drifts):.3e} "
        f"against the batched rows engine's max {max(r_drifts):.3e} (median "
        f"{np.median(r_drifts):.3e}; limit {limit}x) on the same cut and cadence; float64 vs "
        f"the batched rows engine over {CROSS_STEPS} steps {cross:.3e} (tol {CROSS_TOL:.0e}); "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    log(f"{ring_name}: {REPLICA_RING_STEPS} steps {ring_s:.3f}s = {ring_rate:.4e} aggregate "
        f"particle-steps/s, {1e3 * ring_s / REPLICA_RING_STEPS:.4f} ms a step; replicas "
        f"{list(ring_bits)} bit-identical to one-replica sharded ring runs "
        f"{all(ring_bits.values())}; launches "
        f"{json.dumps({k: v for k, v in ring_counts.items() if v})}")
    LAUNCHES.reset()
    return out


def _ensemble_cli(name: str, args: list) -> tuple:
    """``python -m ljmd_tpu_torch ensemble <args>`` on the card: (its
    ``{"ensemble": ...}`` summary, its launch counts, wall seconds)."""
    proc, wall = _cli(name, ["ensemble", *args, "--device", DEVICE])
    return _cli_json(proc, "ensemble"), _cli_json(proc, "kernel_launches"), wall


def _ensemble_files(out_dir: str, replicas: int) -> None:
    """The ensemble's artifacts are there and parse: R finite rows of means,
    the cross-run JSON, five corrmean curves."""
    import numpy as np

    for f in ENSEMBLE_FILES:
        path = os.path.join(out_dir, f)
        require(os.path.isfile(path) and os.path.getsize(path) > 0, f"missing: {path}")
    means = np.loadtxt(os.path.join(out_dir, "means.txt"), ndmin=2)
    require(means.shape == (replicas, 11) and bool(np.isfinite(means).all()),
            f"{out_dir}/means.txt: shape {means.shape} or non-finite")
    with open(os.path.join(out_dir, "simulation_results.json")) as f:
        results = json.load(f)
    require(results["n_runs"] == replicas and all(
        math.isfinite(v["mean"]) for v in results["cross_run"].values()),
        f"{out_dir}/simulation_results.json")
    for o in ("epot", "ekin", "etot", "temp", "press"):
        curve = np.loadtxt(os.path.join(out_dir, f"corrmean_runs_{o}.dat"))
        require(curve.ndim == 2 and bool(np.isfinite(curve).all()), f"corrmean_runs_{o}.dat")


def _same_bytes(a: str, b: str, names) -> bool:
    for f in names:
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            if fa.read() != fb.read():
                return False
    return True


def phase_ensemble(torch, tmp: str) -> dict:
    """Phase 12b-f: config 4 through the CLI (in memory and --stream), the
    same run in process against one-replica runs, the replica loop against
    the batched engine, the N=864 ensemble through the zsort loop, and
    --per-run-dirs."""
    import numpy as np

    from ljmd_tpu_torch.cli import write_ensemble_artifacts
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.experiments import ensemble_drift
    from ljmd_tpu_torch.models.engine import (
        _replica_loop_engine,
        make_engine,
        replica_backend,
        replica_state,
    )
    from ljmd_tpu_torch.models.simulation import (
        initialize_replicas,
        replica_generators,
        run_production,
    )
    from ljmd_tpu_torch.ops._cuda import LAUNCHES
    from ljmd_tpu_torch.parallel.ensemble import ensemble_aggregate

    path = str(REPO / "examples" / "ensemble64.json")
    cfg = load_config(path)
    reps = cfg.n_runs
    require(replica_backend(cfg, "auto", DEVICE, cfg.output_interval) == ("rows", True),
            "auto does not route config 4 to the batched rows engine")
    singles_k = ("pair_sweep_tri", "fused_dense_chunk", "fused_dense_chunk_ext")
    no_rows = ZSORT_KERNELS + PENCIL_KERNELS + ("pair_sweep",)
    runs, report = {}, {}

    # (b) config 4 in full through the CLI, then in process from the same
    # initial states (the replica generators are deterministic).
    name = "ensemble64_f32_rows_batched"
    out_mem = os.path.join(tmp, name)
    summary, counts, wall = _ensemble_cli(name, ["--config", path, "--out-dir", out_mem])
    _check_launches(name, counts, ("pair_sweep_tri_replicas", "fused_dense_chunk_replicas"),
                    singles_k + no_rows + ("fused_dense_chunk_ext_replicas",))
    require(summary["n_ok"] == reps and summary["batched"], f"{name}: {summary}")
    _ensemble_files(out_mem, reps)
    torch.cuda.synchronize()
    t0 = time.time()
    states = initialize_replicas(cfg, replica_generators(cfg.seed, reps), device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    LAUNCHES.reset()
    t0 = time.time()
    res = run_production(cfg, states, device=DEVICE)
    torch.cuda.synchronize()
    prod_s = time.time() - t0
    in_counts = LAUNCHES.snapshot()
    out = ensemble_aggregate(cfg, res)
    write_ensemble_artifacts(os.path.join(tmp, "ensemble64_in_process"), cfg, out, reps)
    same_as_cli = _same_bytes(out_mem, os.path.join(tmp, "ensemble64_in_process"),
                              ENSEMBLE_FILES)
    require(same_as_cli, f"{name}: the in-process run's artifacts differ from the CLI's")
    drifts = [_drift(res.series[q, 2].cpu()) for q in range(reps)]
    variants = ensemble_drift.main(["--device", DEVICE, "--config", path])
    f64 = variants["float64"]
    require(float(np.median(drifts)) <= DRIFT_BOUND[name]
            and max(drifts) <= ENSEMBLE_DRIFT_VS_F64 * f64["max"],
            f"{name}: |dE/E| median {np.median(drifts):.3e} (bound {DRIFT_BOUND[name]:.0e}), "
            f"max {max(drifts):.3e} against float64's max {f64['max']:.3e} "
            f"(bound {ENSEMBLE_DRIFT_VS_F64}x)")
    vs_single = {}
    for q in ENSEMBLE_SINGLE_REPLICAS:
        one = run_production(cfg, replica_state(states, q), device=DEVICE)
        bits = all(bool(torch.equal(getattr(res.final_state, f)[q], getattr(one.final_state, f)))
                   for f in ("r", "ru", "v", "a"))
        series = _rel_scale_err(res.series[q].cpu(), one.series.cpu())
        means = _rel_scale_err(res.means.means[q].cpu(), one.means.means.cpu())
        vs_single[q] = {"final_state_bit_identical": bits, "series_rel_err": series,
                        "means_rel_err": means}
        require(bits and series <= ENSEMBLE_SERIES_RTOL and means <= ENSEMBLE_SERIES_RTOL,
                f"{name}: replica {q} against its one-replica run: {vs_single[q]}")
    rate = reps * cfg.n * cfg.total_steps / prod_s
    runs[name] = {"engine": "rows", "n": cfg.n, "replicas": reps, "launches": counts,
                  "cli": summary, "cli_wall_s": wall, "init_s": init_s, "production_s": prod_s,
                  "particle_steps_per_s": rate, "in_process_launches": in_counts,
                  "max_drift": max(drifts), "median_drift": float(np.median(drifts)),
                  "over_1e-3": sum(d > 1e-3 for d in drifts), "drift_variants": variants,
                  "vs_single": vs_single}
    log(f"{name}: R={reps} N={cfg.n} x {cfg.total_steps} steps, CLI wall {wall:.1f}s, CLI "
        f"production {summary['production_s']:.3f}s = {summary['particle_steps_per_s']:.4e} "
        f"aggregate particle-steps/s, {summary['n_ok']}/{reps} ok; in process init "
        f"{init_s:.3f}s, production {prod_s:.3f}s = {rate:.4e}, artifacts byte-equal to the "
        f"CLI's; |dE/E| median {np.median(drifts):.3e} (bound {DRIFT_BOUND[name]:.0e}), max "
        f"{max(drifts):.3e} ({sum(d > 1e-3 for d in drifts)} of {reps} over 1e-3) against the "
        f"float64 ensemble's max {f64['max']:.3e} (bound {ENSEMBLE_DRIFT_VS_F64}x; every variant: "
        f"{json.dumps(variants)}); against one-replica runs {json.dumps(vs_single)}; CLI "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")

    # (c) the design question: the replica loop against the batched engine on
    # a 2,000-step cut from the same states.
    cut = cfg.replace(**ENSEMBLE_CUT)
    LAUNCHES.reset()
    t0 = time.time()
    batched = run_production(cut, states, device=DEVICE)
    torch.cuda.synchronize()
    t_b = time.time() - t0
    b_counts = LAUNCHES.snapshot()
    loop_engine = _replica_loop_engine([make_engine(cut, "rows", DEVICE) for _ in range(reps)])
    LAUNCHES.reset()
    t0 = time.time()
    looped = run_production(cut, states, engine=loop_engine)
    torch.cuda.synchronize()
    t_l = time.time() - t0
    l_counts = LAUNCHES.snapshot()
    same = all(bool(torch.equal(getattr(batched.final_state, f), getattr(looped.final_state, f)))
               for f in ("r", "ru", "v", "a"))
    require(same, "ensemble64 cut: the replica loop's final states differ from the batched "
                  "engine's")
    _check_launches("ensemble64_f32_rows_loop", l_counts, singles_k[:2], REPLICA_KERNELS)
    _check_launches("ensemble64_f32_rows_batched_cut", b_counts, REPLICA_KERNELS[:2], singles_k)
    r_b = reps * cut.n * cut.total_steps / t_b
    r_l = reps * cut.n * cut.total_steps / t_l
    loop_series = _rel_scale_err(looped.series.cpu(), batched.series.cpu())
    runs["ensemble64_f32_rows_loop"] = {"engine": "rows (loop)", "n": cut.n, "replicas": reps,
                                        "launches": l_counts, "production_s": t_l,
                                        "particle_steps_per_s": r_l}
    report["loop_vs_batched"] = {"steps": cut.total_steps, "batched_s": t_b, "loop_s": t_l,
                                 "batched_rate": r_b, "loop_rate": r_l,
                                 "final_states_bit_identical": same,
                                 "series_rel_err": loop_series, "batched_launches": b_counts}
    log(f"ensemble64 cut to {cut.total_steps} steps from the same states: batched {t_b:.3f}s = "
        f"{r_b:.4e} particle-steps/s, the replica loop {t_l:.3f}s = {r_l:.4e} (batched / loop "
        f"{r_b / r_l:.1f}x); final states bit-identical {same}, series rel diff "
        f"{loop_series:.3e}; launches batched {json.dumps({k: v for k, v in b_counts.items() if v})}"
        f", loop {json.dumps({k: v for k, v in l_counts.items() if v})}")

    # (d) --stream: the same artifacts byte for byte; the correlation stage's
    # memory within its group.
    name = "ensemble64_f32_rows_stream"
    out_st = os.path.join(tmp, name)
    st_summary, st_counts, st_wall = _ensemble_cli(
        name, ["--config", path, "--out-dir", out_st, "--stream", "--chunk-samples", "32"])
    _check_launches(name, st_counts, REPLICA_KERNELS[:2], singles_k + no_rows)
    stream = st_summary["stream"]
    peak_ratio = stream["corr_peak_bytes"] / stream["corr_group_bytes"]
    equal = _same_bytes(out_st, out_mem, ENSEMBLE_FILES)
    require(equal, f"{name}: the streamed artifacts differ from the in-memory run's")
    require(peak_ratio <= CORR_PEAK_OVER_GROUP, f"{name}: the correlation stage's peak "
            f"{stream['corr_peak_bytes']} B is {peak_ratio:.2f}x its group's lag products")
    runs[name] = {"engine": "rows", "n": cfg.n, "replicas": reps, "launches": st_counts,
                  "cli": st_summary, "cli_wall_s": st_wall,
                  "particle_steps_per_s": st_summary["particle_steps_per_s"]}
    log(f"{name}: --stream --chunk-samples 32, {stream['chunks']} chunks, artifacts byte-equal "
        f"to the in-memory run's {equal}; correlation stage in groups of {stream['corr_group']} "
        f"of {reps} replicas: peak {stream['corr_peak_bytes'] / 2**20:.2f} MiB = "
        f"{peak_ratio:.3f}x a group's lag products ({stream['corr_group_bytes'] / 2**20:.2f} "
        f"MiB; all {reps} at once: {stream['corr_group_bytes'] * reps / stream['corr_group'] / 2**20:.2f}"
        f" MiB); init + production {st_summary['production_s']:.3f}s, CLI wall {st_wall:.1f}s")

    # (e) the N=864 ensemble (auto -> zsort, batched): the replica
    # loop over one-system zsort engines at R=8, the yardstick, then the
    # batched engine from the same states (bit-equal), then R=64 batched
    # through the CLI, and in process replica 0 against its one-system run.
    name = "n864_f32_ensemble_zsort_loop"
    zcfg = load_config(str(REPO / "examples" / "n864_liquid.json")).replace(**ENSEMBLE_ZSORT_CUT)
    zreps = ENSEMBLE_ZSORT_R
    require(replica_backend(zcfg, "auto", DEVICE, zcfg.output_interval) == ("zsort", True),
            "auto does not route the N=864 ensemble to the batched zsort engine")
    torch.cuda.synchronize()
    t0 = time.time()
    zstates = initialize_replicas(zcfg, replica_generators(zcfg.seed, zreps), device=DEVICE)
    torch.cuda.synchronize()
    z_init = time.time() - t0
    loop = _replica_loop_engine([make_engine(zcfg, "zsort", DEVICE,
                                             sample_interval=zcfg.output_interval)
                                 for _ in range(zreps)])
    LAUNCHES.reset()
    t0 = time.time()
    zres = run_production(zcfg, zstates, engine=loop)
    torch.cuda.synchronize()
    z_prod = time.time() - t0
    z_counts = LAUNCHES.snapshot()
    zout = ensemble_aggregate(zcfg, zres)
    flags = {k: bool(v.any()) for k, v in zres.diagnostics.items()}
    LAUNCHES.reset()
    one = run_production(zcfg, replica_state(zstates, 0), device=DEVICE)
    one_counts = LAUNCHES.snapshot()
    per_replica = all(z_counts[k] == zreps * one_counts[k] and one_counts[k] > 0
                      for k in ZSORT_KERNELS)
    z_same = all(bool(torch.equal(getattr(zres.final_state, f)[0], getattr(one.final_state, f)))
                 for f in ("r", "ru", "v", "a"))
    require(int(zout.n_ok) == zreps and not any(flags.values()) and per_replica and z_same,
            f"{name}: n_ok {int(zout.n_ok)}, flags {flags}, launches {z_counts} against one "
            f"replica's {one_counts}, replica 0 equal to its one-replica run {z_same}")
    z_rate = zreps * zcfg.n * zcfg.total_steps / z_prod
    runs[name] = {"engine": "zsort (loop)", "n": zcfg.n, "replicas": zreps, "launches": z_counts,
                  "init_s": z_init, "production_s": z_prod, "particle_steps_per_s": z_rate,
                  "diagnostics": flags}
    log(f"{name}: R={zreps} N={zcfg.n} x {zcfg.total_steps} steps through the replica loop: "
        f"init {z_init:.3f}s (batched), production {z_prod:.3f}s = {z_rate:.4e} aggregate "
        f"particle-steps/s, {int(zout.n_ok)}/{zreps} ok, flags {flags}; kernels 9 / 10 "
        f"{z_counts['build_window_lists']} / {z_counts['fused_dense_chunk_list']} launches = "
        f"{zreps} x one replica's ({one_counts['build_window_lists']} / "
        f"{one_counts['fused_dense_chunk_list']}); replica 0 bit-identical to its one-replica "
        f"run {z_same}")
    name = f"n864_f32_ensemble_zsort_batched_r{zreps}"
    LAUNCHES.reset()
    t0 = time.time()
    bres = run_production(zcfg, zstates, device=DEVICE)
    torch.cuda.synchronize()
    b_prod = time.time() - t0
    b_counts = LAUNCHES.snapshot()
    b_same = all(bool(torch.equal(getattr(bres.final_state, f), getattr(zres.final_state, f)))
                 for f in ("r", "ru", "v", "a"))
    _check_launches(name, b_counts, REPLICA_ZSORT_KERNELS, ZSORT_KERNELS + ("pair_sweep_tri",))
    require(b_same, f"{name}: final states differ from the replica loop's")
    b_rate = zreps * zcfg.n * zcfg.total_steps / b_prod
    report["zsort_loop_vs_batched"] = {"replicas": zreps, "loop_rate": z_rate,
                                       "batched_rate": b_rate,
                                       "final_states_bit_identical": b_same,
                                       "batched_launches": b_counts}
    log(f"{name}: the batched zsort engine from the loop's states: {b_prod:.3f}s = {b_rate:.4e} "
        f"(batched / loop {b_rate / z_rate:.2f}x), final states bit-identical to the loop's "
        f"{b_same}; launches {json.dumps({k: v for k, v in b_counts.items() if v})}")

    # (e'') R=64 through the CLI (auto -> zsort, batched): the main path.
    name = "n864_f32_ensemble_zsort_batched"
    zr = ENSEMBLE_ZSORT_BATCHED_R
    out_z = os.path.join(tmp, name)
    zsum, zc, zwall = _ensemble_cli(name, ["--config", _write_cfg(tmp, name, zcfg), "--out-dir",
                                           out_z, "--n-runs", str(zr)])
    _check_launches(name, zc, REPLICA_ZSORT_KERNELS,
                    ZSORT_KERNELS + ("pair_sweep_tri", "pair_sweep", "fused_dense_chunk",
                                     "fused_dense_chunk_ext") + REPLICA_KERNELS[1:])
    require(zsum["n_ok"] == zr and zsum["batched"] and zsum["engine"] == "zsort"
            and not any(zsum["flags"].values()), f"{name}: {zsum}")
    _ensemble_files(out_z, zr)
    states64 = initialize_replicas(zcfg, replica_generators(zcfg.seed, zr), device=DEVICE)
    res64 = run_production(zcfg, states64, device=DEVICE)
    one = run_production(zcfg, replica_state(states64, 0), device=DEVICE)
    same0 = all(bool(torch.equal(getattr(res64.final_state, f)[0], getattr(one.final_state, f)))
                for f in ("r", "ru", "v", "a"))
    ok64 = int(ensemble_aggregate(zcfg, res64).n_ok)
    require(same0 and ok64 == zr and not bool(res64.diagnostics["zsort_invalid"].any()),
            f"{name}: in process {ok64}/{zr} ok, replica 0 bit-identical to its one-system "
            f"zsort run {same0}")
    runs[name] = {"engine": "zsort (batched)", "n": zcfg.n, "replicas": zr, "launches": zc,
                  "cli": zsum, "cli_wall_s": zwall,
                  "particle_steps_per_s": zsum["particle_steps_per_s"],
                  "replica0_bit_identical_to_one_system": same0}
    report["zsort_loop_vs_batched"]["cli_r64_rate"] = zsum["particle_steps_per_s"]
    log(f"{name}: R={zr} N={zcfg.n} x {zcfg.total_steps} steps through the CLI (auto -> zsort, "
        f"batched): init {zsum['init_s']:.3f}s, production {zsum['production_s']:.3f}s = "
        f"{zsum['particle_steps_per_s']:.4e} aggregate particle-steps/s against the R={zreps} "
        f"loop's {z_rate:.4e} ({zsum['particle_steps_per_s'] / z_rate:.1f}x), {zsum['n_ok']}/{zr}"
        f" ok, flags {zsum['flags']}, CLI wall {zwall:.1f}s; in process replica 0 bit-identical "
        f"to its one-system zsort run {same0}; CLI launches "
        f"{json.dumps({k: v for k, v in zc.items() if v})}")

    # (e') the compensated replica chunk (kernel 4) on its main path: the
    # reference default in float32 as an R=8 ensemble.
    name = "reference_default_f32_ensemble8"
    ecfg = load_config(str(REPO / "examples" / "reference_default.json")).replace(
        **ENSEMBLE_EXT_CUT)
    estates = initialize_replicas(ecfg, replica_generators(ecfg.seed, ENSEMBLE_EXT_R),
                                  device=DEVICE)
    LAUNCHES.reset()
    t0 = time.time()
    eres = run_production(ecfg, estates, device=DEVICE)
    torch.cuda.synchronize()
    e_prod = time.time() - t0
    e_counts = LAUNCHES.snapshot()
    _check_launches(name, e_counts, ("pair_sweep_tri_replicas", "fused_dense_chunk_ext_replicas"),
                    singles_k + ("fused_dense_chunk_replicas",))
    eout = ensemble_aggregate(ecfg, eres)
    e_drift = max(_drift(eres.series[q, 2].cpu()) for q in range(ENSEMBLE_EXT_R))
    require(int(eout.n_ok) == ENSEMBLE_EXT_R and e_drift <= DRIFT_BOUND["reference_default_f32"],
            f"{name}: {int(eout.n_ok)} ok, max |dE/E| {e_drift:.3e}")
    e_rate = ENSEMBLE_EXT_R * ecfg.n * ecfg.total_steps / e_prod
    runs[name] = {"engine": "rows (compensated)", "n": ecfg.n, "replicas": ENSEMBLE_EXT_R,
                  "launches": e_counts, "production_s": e_prod, "particle_steps_per_s": e_rate,
                  "max_drift": e_drift}
    log(f"{name}: R={ENSEMBLE_EXT_R} N={ecfg.n} x {ecfg.total_steps} steps (float32, dt=1e-4, "
        f"compensated), production {e_prod:.3f}s = {e_rate:.4e} aggregate particle-steps/s, "
        f"{int(eout.n_ok)}/{ENSEMBLE_EXT_R} ok, max |dE/E| {e_drift:.3e} (bound "
        f"{DRIFT_BOUND['reference_default_f32']:.0e}); launches "
        f"{json.dumps({k: v for k, v in e_counts.items() if v})}")

    # (f) --per-run-dirs on the cut, R=4.
    name = "ensemble64_per_run_dirs"
    out_pr = os.path.join(tmp, name)
    pr_summary, pr_counts, pr_wall = _ensemble_cli(
        name, ["--config", _write_cfg(tmp, name, cut), "--out-dir", out_pr, "--n-runs",
               str(ENSEMBLE_PER_RUN_R), "--per-run-dirs"])
    with open(os.path.join(out_pr, "several_runs.txt")) as f:
        listed = f.read().split()
    want_dirs = [os.path.join(out_pr, f"run_{i:04d}") for i in range(ENSEMBLE_PER_RUN_R)]
    require(listed == want_dirs, f"{name}: several_runs.txt lists {listed}")
    for d in want_dirs:
        _check_artifacts(d, with_frames=False)
    _ensemble_files(out_pr, ENSEMBLE_PER_RUN_R)
    runs[name] = {"engine": "rows", "n": cut.n, "replicas": ENSEMBLE_PER_RUN_R,
                  "launches": pr_counts, "cli": pr_summary, "cli_wall_s": pr_wall,
                  "particle_steps_per_s": pr_summary["particle_steps_per_s"]}
    log(f"{name}: R={ENSEMBLE_PER_RUN_R} on the {cut.total_steps}-step cut, run_0000..run_"
        f"{ENSEMBLE_PER_RUN_R - 1:04d} written, checked and listed in several_runs.txt; CLI wall "
        f"{pr_wall:.1f}s")
    return {"runs": runs, **report}


def phase_kill_resume(torch, tmp: str) -> dict:
    """BASELINE config 5 (N=62500, ``auto`` -> cellpair) cut as N62500_CUT:
    ``init-config`` once, then from its rv_init.dat B (in-memory
    ``simulate``), A (``simulate --stream --chunk-samples 2``) and C (A's
    command in another directory, SIGKILLed once its first checkpoint
    exists, then run again to the end). C must have died mid-run, A, B and
    C's artifacts must be equal byte for byte, no checkpoint may be left,
    the flags clear, the native writer used."""
    import signal

    import numpy as np

    from ljmd_tpu_torch.config import load_config

    cfg = load_config(str(REPO / "examples" / "n62500_large.json")).replace(**N62500_CUT)
    cfg_path = _write_cfg(tmp, "n62500_kill", cfg)
    n_samples = cfg.n_samples
    base = os.path.join(tmp, "kill_resume")
    init = os.path.join(base, "rv_init.dat")
    proc, _ = _cli("init", ["init-config", "--config", cfg_path, "--out", init, "--device",
                            DEVICE])
    init_counts = _cli_json(proc, "kernel_launches")
    common = ["--config", cfg_path, "--from-init", init, "--device", DEVICE]
    dirs = {k: os.path.join(base, k) for k in ("A", "B", "C")}
    stream_args = ["--stream", "--chunk-samples", str(KILL_CHUNK)]
    b, _ = _cli("B", ["simulate", "--out-dir", dirs["B"], *common])
    a, _ = _cli("A", ["simulate", "--out-dir", dirs["A"], *common, *stream_args])

    cmd = [sys.executable, "-m", "ljmd_tpu_torch", "simulate", "--out-dir", dirs["C"], *common,
           *stream_args]
    ckpt = os.path.join(dirs["C"], "production_checkpoint.npz")
    t0 = time.time()
    victim = subprocess.Popen(cmd, cwd=str(REPO), stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    try:
        while victim.poll() is None and not os.path.exists(ckpt) and time.time() - t0 < 600:
            time.sleep(0.002)
        victim.send_signal(signal.SIGKILL)
    finally:
        victim.wait()
    require(victim.returncode == -signal.SIGKILL,
            f"C was not killed mid-run: return code {victim.returncode} (it finished first)")
    require(os.path.exists(ckpt), "C left no checkpoint")
    with np.load(ckpt) as z:
        killed_at = int(z["sample_idx"])
    require(0 < killed_at < n_samples, f"C's checkpoint holds sample {killed_at} of {n_samples}")
    c, _ = _cli("C", ["simulate", "--out-dir", dirs["C"], *common, *stream_args])

    out = {}
    for name, proc in (("A", a), ("B", b), ("C", c)):
        flags = _cli_json(proc, "diagnostics")
        require(not any(flags.values()), f"kill/resume {name}: diagnostics {flags}")
        _check_artifacts(dirs[name], with_frames=True)
        require(not os.path.exists(os.path.join(dirs[name], "production_checkpoint.npz")),
                f"kill/resume {name}: a checkpoint was left after completion")
        out[name] = {"particle_steps_per_s": _cli_rate(proc),
                     "launches": _cli_json(proc, "kernel_launches"), "diagnostics": flags}
    for name, proc in (("A", a), ("C", c)):
        stream = _cli_json(proc, "stream")
        require(stream["writer"] == "native" and "Python writer" not in proc.stderr,
                f"kill/resume {name}: the native writer was not used ({stream['writer']})")
        out[name]["stream"] = stream
    require(out["C"]["stream"]["resumed_from"] == killed_at
            and out["C"]["stream"]["carry"] == "verbatim",
            f"C did not resume verbatim from sample {killed_at}: {out['C']['stream']}")
    files = ["rva.dat", "instantaneous_energies.dat", "means.dat", "md_final_results.txt",
             "summary.json"] + [f"{p}_{o}.dat" for p in ("corr", "corrmean")
                                for o in ("epot", "ekin", "etot", "temp", "press")]
    for f in files:
        with open(os.path.join(dirs["B"], f), "rb") as fb:
            want = fb.read()
        for name in ("A", "C"):
            with open(os.path.join(dirs[name], f), "rb") as fx:
                require(fx.read() == want, f"kill/resume: {name}/{f} differs from B/{f}")
    s = out["A"]["stream"]
    per_chunk = {"checkpoint_mb": s["checkpoint_bytes"] / s["chunks"] / 1e6,
                 "checkpoint_ms": 1e3 * s["checkpoint_s"] / s["chunks"]}
    rva_mb_s = s["rva_bytes"] / 1e6 / s["write_s"] if s["write_s"] else None
    kernels = {k: out["A"]["launches"].get(k, 0) for k in PENCIL_KERNELS}
    require(kernels["pencil_sweep_hs"] > 0 and kernels["fused_pencil_chunk"] > 0,
            f"A did not run the cell-pair kernels: {kernels}")
    log(f"config 5 kill/resume (N={cfg.n}, {n_samples} samples, chunks of {KILL_CHUNK}): C "
        f"SIGKILLed at sample {killed_at}, resumed verbatim; A = B = C byte for byte over "
        f"{len(files)} files; production A (stream) {out['A']['particle_steps_per_s']:.4e}, B "
        f"(in memory) {out['B']['particle_steps_per_s']:.4e} particle-steps/s (A / B "
        f"{out['A']['particle_steps_per_s'] / out['B']['particle_steps_per_s']:.3f}); "
        f"checkpoint {per_chunk['checkpoint_mb']:.2f} MB and {per_chunk['checkpoint_ms']:.1f} ms "
        f"a chunk; rva.dat {s['rva_bytes'] / 1e6:.1f} MB at "
        f"{rva_mb_s if rva_mb_s is None else round(rva_mb_s, 1)} MB/s (append + sync); "
        f"launches in A {json.dumps(kernels)}, in the warmup (init-config) "
        f"{json.dumps({k: init_counts.get(k, 0) for k in PENCIL_KERNELS})}")
    return {"runs": out, "killed_at": killed_at, "per_chunk": per_chunk, "rva_mb_s": rva_mb_s,
            "launches_A": kernels}


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

    start = time.time()
    marks = {}

    def mark(name: str) -> None:
        marks[name] = round(time.time() - start, 1)
        log(f"[{marks[name]:.1f}s] {name} done")

    env = phase_environment(torch)
    phase_build()
    mark("build")
    cases = phase_kernels(torch)
    ordered_vs_tri, same_forces = phase_ordered_vs_tri(torch)
    rect = phase_rect_kernels(torch)
    cases["pair_sweep_tri"] += rect.pop("pair_sweep_tri")
    cases.update(rect)
    cases.update(phase_list_kernels(torch))
    cases.update(phase_flags_kernel(torch))
    cases.update(phase_probe_kernels(torch))
    cases.update(phase_layout_kernels(torch))
    mark("phase 3")
    cases.update(phase_ensemble_kernels(torch))
    mark("phase 12a")
    replica = phase_replica_kernels(torch)
    cases["pair_sweep_tri_replicas"] += replica.pop("pair_sweep_tri_replicas")
    cases.update(replica)
    mark("phase 12a'")
    with tempfile.TemporaryDirectory(prefix="ljmd_chip_smoke_") as tmp:
        runs, final_cfg, final_state = phase_main_path(torch, tmp)
        mark("phase 4a-b")
        cp_runs, cfg5, states5 = phase_cellpair_path(torch, tmp)
        mark("phase 4c")
        runs["flagship_entry_f32"], flagship_cross = phase_flagship(torch)
        runs["n4000_f32_rows_ordered"], ordered_cross = phase_rows_ordered(torch, tmp,
                                                                           same_forces)
        n4000 = load_config(str(REPO / "examples" / "n4000_production.json")).replace(**N4000_CUT)
        runs["n4000_f32_neighbor"] = _cli_run("n4000_f32_neighbor", n4000, "neighbor", tmp, (),
                                              MAIN_KERNELS)
        full_runs, full_cross = phase_full_sweeps(torch, cfg5, states5["cap512_end"], tmp)
        mark("phase 4d-g")
        multi_runs, multi_cross, multi_drifts, multi_states = phase_multidevice(torch, tmp)
        mark("phase 9b")
        analysis = phase_analysis(torch, tmp)
        runs["n4000_f32_zsort_stream"] = analysis.pop("run")
        mark("phase 10")
        kill = phase_kill_resume(torch, tmp)
        runs["n62500_f32_cellpair_stream"] = {
            "engine": "auto", "n": cfg5.n, "launches": kill["runs"]["A"]["launches"],
            "particle_steps_per_s": kill["runs"]["A"]["particle_steps_per_s"]}
        mark("phase 11")
        ensemble = phase_ensemble(torch, tmp)
        runs.update(ensemble["runs"])
        mark("phase 12b-f")
        runs.update(phase_replica_particle(torch)["runs"])
        mark("phase 12g")
    multi_rates = phase_multidevice_rates(torch, multi_states)
    mark("phase 9c")
    exp_runs = phase_experiments(torch)
    mark("phase 4h")
    runs.update(cp_runs)
    runs.update(exp_runs)
    runs.update(full_runs)
    runs.update(multi_runs)
    state5 = states5["cap512_end"]
    # A third stretch of the fluid: the capacity-512 run's end with the
    # velocities reversed (it retraces the stretch before it).
    states5["cap512_end_reversed"] = dataclasses.replace(state5, v=-state5.v)
    cases.update(phase_pencil_kernels(torch, cfg5, state5))
    mark("phase 3c")
    paths = phase_chunk_paths(torch, cfg5, states5)
    mark("phase 5")
    rows62500 = phase_rows_at_62500(torch, cfg5, state5)
    mark("phase 6")
    vs_rows = phase_engines_vs_rows(torch, final_cfg, final_state)
    series_err = phase_card_vs_cpu(torch)
    mark("phases 7-8")

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
                "pencil_sweep_mono": ("N=62500 cap=384 strip", "float32"),
                "fused_pencil_chunk": ("N=62500 cap=384", "float32"),
                "fused_pencil_width_chunk": ("N=62500 cap=512", "float32"),
                "pencil_sweep_full": ("N=62500 cap=512", "float32"),
                "pencil_sweep_zband": ("N=62500 cap=512", "float32"),
                "pair_sweep_rect": ("N=4000 d=2 hop", "float32"),
                "pair_sweep_rect_newton": ("N=4000 d=4 hop", "float32"),
                "fused_dense_chunk_flags": ("N=4000 tile_j=512 real", "float32"),
                "mosaic_probes": ("t8n", "float32"),
                "layout_bodies": ("k1-512 v=128 L=16.796", "float32"),
                "pair_sweep_tri_replicas": ("R=64 N=256", "float32"),
                "fused_dense_chunk_replicas": ("R=64 N=256", "float32"),
                "fused_dense_chunk_ext_replicas": ("R=8 N=500", "float32"),
                # Kernels 6 and 7's replica launches at the replica x particle
                # step's: R=32 replicas of config 4's 128-row rank blocks, with
                # observables (the step's).
                "pair_sweep_rect_replicas": (f"R={REPLICA_HALF_R} N=256 d=2 hop", "float32",
                                             True),
                "pair_sweep_rect_newton_replicas": (f"R={REPLICA_HALF_R} N=256 d=2 half hop",
                                                    "float32", True),
                "build_window_lists_replicas": (f"R={REPLICA_LIST_R} N=864", "float32"),
                "fused_dense_chunk_list_replicas": (f"R={REPLICA_LIST_R} N=864", "float32")}
    meta = {
        "lj_pair_terms": ("ljmd_tpu_torch/csrc/lj_pair_terms.cuh", "ljmd_tpu/ops/pallas_common.py:17"),
        "pair_sweep_tri": ("ljmd_tpu_torch/csrc/pair_sweep_tri.cu", "ljmd_tpu/ops/pallas_lj.py:240"),
        "pair_sweep": ("ljmd_tpu_torch/csrc/pair_sweep.cu", "ljmd_tpu/ops/pallas_lj.py:103"),
        "fused_dense_chunk": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:537"),
        "fused_dense_chunk_ext": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:465"),
        "build_window_lists": ("ljmd_tpu_torch/csrc/pack_window_lists.cu", "ljmd_tpu/ops/pallas_fused.py:803"),
        "fused_dense_chunk_list": ("ljmd_tpu_torch/csrc/fused_dense_chunk_list.cu", "ljmd_tpu/ops/pallas_fused.py:1383"),
        "pencil_sweep_hs": ("ljmd_tpu_torch/csrc/pencil_sweep_hs.cu", "ljmd_tpu/ops/pallas_pencil2.py:187"),
        "pencil_sweep_mono": ("ljmd_tpu_torch/csrc/pencil_sweep_hs.cu", "ljmd_tpu/ops/pallas_pencil2.py:394"),
        "fused_pencil_chunk": ("ljmd_tpu_torch/csrc/fused_pencil_chunk.cu", "ljmd_tpu/ops/pallas_pencil_fused.py:277"),
        "fused_pencil_width_chunk": ("ljmd_tpu_torch/csrc/fused_pencil_width_chunk.cu", "ljmd_tpu/ops/pallas_pencil_fused.py:609"),
        "pencil_sweep_full": ("ljmd_tpu_torch/csrc/pencil_sweep_full.cu", "ljmd_tpu/ops/pallas_pencil.py:309"),
        "pencil_sweep_zband": ("ljmd_tpu_torch/csrc/pencil_sweep_zband.cu", "ljmd_tpu/ops/pallas_pencil.py:256"),
        "pair_sweep_rect": ("ljmd_tpu_torch/csrc/pair_sweep_rect.cu", "ljmd_tpu/ops/pallas_lj.py:364"),
        "pair_sweep_rect_newton": ("ljmd_tpu_torch/csrc/pair_sweep_rect.cu", "ljmd_tpu/ops/pallas_lj.py:533"),
        "fused_dense_chunk_flags": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:384"),
        "mosaic_probes": ("ljmd_tpu_torch/csrc/mosaic_probes.cu", "scripts/exp_mosaic_support.py:65"),
        "layout_bodies": ("ljmd_tpu_torch/csrc/layout_bodies.cu", "scripts/exp_layout.py:127"),
        # Kernels 2, 3 and 4 with a replica dimension: one launch for the R
        # replicas of an ensemble (the JAX package's vmap of the same kernels).
        "pair_sweep_tri_replicas": ("ljmd_tpu_torch/csrc/pair_sweep_tri.cu", "ljmd_tpu/ops/pallas_lj.py:240"),
        "fused_dense_chunk_replicas": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:537"),
        "fused_dense_chunk_ext_replicas": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:465"),
        # Kernels 6, 7, 9 and 10 with a replica dimension: the replica x
        # particle step's hops and the batched zsort engine's pack and chunk.
        "pair_sweep_rect_replicas": ("ljmd_tpu_torch/csrc/pair_sweep_rect.cu", "ljmd_tpu/ops/pallas_lj.py:364"),
        "pair_sweep_rect_newton_replicas": ("ljmd_tpu_torch/csrc/pair_sweep_rect.cu", "ljmd_tpu/ops/pallas_lj.py:533"),
        "build_window_lists_replicas": ("ljmd_tpu_torch/csrc/pack_window_lists.cu", "ljmd_tpu/ops/pallas_fused.py:803"),
        "fused_dense_chunk_list_replicas": ("ljmd_tpu_torch/csrc/fused_dense_chunk_list.cu", "ljmd_tpu/ops/pallas_fused.py:1383"),
    }
    launches = dict.fromkeys(MAIN_KERNELS, 0)
    for run in runs.values():
        for k in launches:
            launches[k] += run["launches"].get(k, 0)
    # lj_pair_terms is a __device__ function with no launch of its own on the
    # main path: it runs inside every sweep and chunk launch, so its count is
    # theirs (its own element-wise kernel runs only in the comparison).
    launches["lj_pair_terms"] = sum(launches[k] for k in MAIN_KERNELS
                                    if k not in ("build_window_lists", "mosaic_probes",
                                                 "build_window_lists_replicas"))
    # Kernel 14 (the mono kernel: a strip and its halo, n_pencils_i) is kernel
    # 13's CUDA kernel; its row counts the sharded pencil engine's launches
    # and is timed at the strip (no observables, as that engine's chunks), and
    # kernel 13's row counts the other runs' launches, so no launch is in both.
    sharded = f"n62500_f32_sharded_pencil_d{STRIP_D}"
    launches["pencil_sweep_mono"] = runs[sharded]["launches"]["pencil_sweep_hs"]
    launches["pencil_sweep_hs"] -= launches["pencil_sweep_mono"]
    cases["pencil_sweep_mono"] = [c for c in cases["pencil_sweep_hs"] if c.get("n_pencils_i")]
    for k, n in launches.items():
        require(n > 0, f"kernel {k} was launched no time on the main path")
    kernels = []
    for name, (source, replaces) in meta.items():
        shape, dname, *obs = headline[name]
        if name == "pencil_sweep_mono":
            head = next(c for c in cases[name] if c["shape"].startswith(shape)
                        and c["dtype"] == dname and not c["observables"])
        else:
            head = next(c for c in cases[name] if (c["shape"], c["dtype"]) == (shape, dname)
                        and (not obs or c["observables"] == obs[0]))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            # Kernels 2, 5, 6, 7, 9, 17 and 18: ``ms`` is a call back to back
            # (the host's call included, as every row and every earlier PR
            # times it), and ``card_ms`` the card's time alone (CUDA-graph
            # replay).
            **({"card_ms": head["card_ms"]} if "card_ms" in head else {}),
            # The probes' library operation (ITERS calls) on the card alone.
            **({"library_card_ms": head["library_card_ms"]} if "library_card_ms" in head
               else {}),
            # The replica launches: the R one-replica launches they replace,
            # back to back (and for kernel 2 on the card alone).
            **{k: head[k] for k in ("loop_ms", "loop_card_ms") if k in head},
            # No single PyTorch call computes a cut-off LJ sweep, a fused
            # Verlet chunk or a greedy visit-list cover; the probes stand for
            # library operations (ITERS calls of each, probe_library).
            "library_ms": head.get("library_ms"),
            "timed_at": f"{head['shape']} {head['dtype']}"
                        + (f" observables {obs[0]}" if obs else ""),
            "launches_by_run": {run: r["launches"][name] for run, r in runs.items()
                                if r["launches"].get(name, 0)
                                and not (name == "pencil_sweep_hs" and run == sharded)},
            # ``model`` holds figures worked out from the run's inputs (the
            # stage plan, the cull's body share), not measured: the log has them.
            "cases": [{k: v for k, v in c.items() if k != "model"} for c in cases[name]],
        }
        if name == "lj_pair_terms":
            entry["launches_counted_as"] = "launches of the kernels that inline it"
        if name == "layout_bodies":
            entry["also_replaces"] = "scripts/exp_layout.py:308 and :324 (transposes)"
            entry["slopes_ns_per_visit"] = {k: 1e9 * v for k, v in
                                            runs["exp_layout"]["result"].items()}
        if name == "pair_sweep_rect_newton":
            # The production order beside the shuffled headline (which tests
            # the masks): a rank's rows are contiguous particle indices.
            lat = next(c for c in cases[name] if c["shape"] == f"{head['shape']} lattice"
                       and c["dtype"] == head["dtype"] and c["observables"] == head["observables"])
            entry.update(lattice_ms=lat["ms"], lattice_card_ms=lat["card_ms"],
                         lattice_bound_ms=lat["bound_ms"], launch=head["launch"])
        if name in ("pencil_sweep_full", "pair_sweep_tri", "pair_sweep_rect", "pair_sweep"):
            entry["launch"] = head["launch"]
        if name == "pair_sweep":
            entry["forces_vs_tri"] = {"bit_identical": same_forces, "cases": ordered_vs_tri}
        if name == "pencil_sweep_hs":
            entry["launches_counted_as"] = "launches outside the sharded pencil engine's run " \
                                           "(those are pencil_sweep_mono's)"
        if name == "pencil_sweep_mono":
            entry["launches_counted_as"] = "launches of pencil_sweep_hs (one CUDA kernel) " \
                                           "in the sharded pencil engine's run"
            entry["launches_by_run"] = {sharded: launches[name]}
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
    ens = runs["ensemble64_f32_rows_batched"]
    lvb = ensemble["loop_vs_batched"]
    log(f"ensemble on {env['nvidia_smi']}: config 4 (R=64, N=256, 10,000 steps, float32) CLI "
        f"production {ens['cli']['production_s']:.3f}s = {ens['cli']['particle_steps_per_s']:.4e} "
        f"aggregate particle-steps/s, in process {ens['particle_steps_per_s']:.4e}, "
        f"{ens['cli']['n_ok']}/64 ok, max |dE/E| {ens['max_drift']:.3e}; on the 2,000-step cut "
        f"batched {lvb['batched_rate']:.4e} against the replica loop {lvb['loop_rate']:.4e} "
        f"({lvb['batched_rate'] / lvb['loop_rate']:.1f}x, final states bit-identical "
        f"{lvb['final_states_bit_identical']}); stream "
        f"{runs['ensemble64_f32_rows_stream']['particle_steps_per_s']:.4e} (init included); "
        f"N=864 zsort loop R=8 "
        f"{runs['n864_f32_ensemble_zsort_loop']['particle_steps_per_s']:.4e}, batched R=8 "
        f"{ensemble['zsort_loop_vs_batched']['batched_rate']:.4e}, batched R=64 (CLI) "
        f"{runs['n864_f32_ensemble_zsort_batched']['particle_steps_per_s']:.4e}")
    rp = next(r for k, r in runs.items() if k.startswith("ensemble64_f32_replica_particle_half"))
    log(f"replica x particle on {env['nvidia_smi']}: config 4 (R=64, N=256, 2,000 steps) on a "
        f"(replica, particle) = {tuple(rp['mesh'])} thread mesh {rp['particle_steps_per_s']:.4e} "
        f"aggregate particle-steps/s, {rp['ms_per_step']:.4f} ms a step, max |dE/E| "
        f"{rp['max_drift']:.3e} (batched rows {rp['rows_max_drift']:.3e}), float64 vs rows "
        f"{rp['f64_vs_rows']:.3e}")
    log(f"analysis and streaming on {env['nvidia_smi']}: config 3 "
        + ", ".join(f"{k} {v['card_ms']:.3f} ms" for k, v in analysis["functions"].items())
        + f" (card vs CPU within {max(v['rel_err'] for v in analysis['functions'].values()):.3e}, "
        f"summary {analysis['summary_rel_err']:.3e}), D_einstein {analysis['D_einstein']:.6g}, "
        f"D_green_kubo {analysis['D_green_kubo']:.6g}; config 5 stream "
        f"{kill['runs']['A']['particle_steps_per_s']:.4e} vs in memory "
        f"{kill['runs']['B']['particle_steps_per_s']:.4e} particle-steps/s, checkpoint "
        f"{kill['per_chunk']['checkpoint_mb']:.2f} MB / {kill['per_chunk']['checkpoint_ms']:.1f} "
        f"ms a chunk, killed at sample {kill['killed_at']} and resumed bit for bit")
    log(f"phase times (s since start, on {env['nvidia_smi']}): {json.dumps(marks)}")
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
