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
   both (CUDA events):
   a. the rows path's kernels on seeded perturbed-FCC inputs at N=500 (the
      reference default's box) and N=4000 (``examples/n4000_production.json``),
      float32 and float64;
   b. the zsort path's kernels at the zsort engine's own geometry for
      ``examples/n4000_production.json`` (n_pad 4096) and
      ``examples/n864_liquid.json`` (n_pad 896): the visit-list pack on the
      flags of a z-sorted fluid and on random flags (lists compared exactly),
      the fused list chunk in its plain, ``obs_last`` and extended modes,
      float32 and float64;
4. the main path, each run with the launch counts set to 0 just before and
   read just after:
   a. rows (``--backend rows``): the CLI on the reference default cut to
      20,000 steps (float64), the same path in process in float32 (the
      compensated ``_ext`` kernel), and N=4000 cut to 5,000 steps;
   b. zsort (``--backend auto``, which picks it on the card): the CLI on
      N=4000 cut to 5,000 steps, N=864 cut the same way, and N=4000 with
      ``compensated_sum`` (the extended list chunk); N=864 also runs on rows
      for the rate comparison;
   every run must launch its kernels (zsort: the pack and the list chunk,
   and no dense chunk), write every artifact, give finite means and thermo,
   keep ``zsort_invalid`` False and conserve energy within a stated bound;
5. zsort against rows on the card: one float64 N=4000 state, 32 fused steps
   (two resorts): positions within 1e-10;
6. the rows path on the card and on the CPU from one state (N=256, 200
   steps, float64): the sampled series must agree to 1e-8.

The lines before the last hold the particle-steps/s of both engines beside
the card's name and power limit, one JSON object with the kernels' launches,
errors and times, and the ``nvidia-smi`` line; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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
ZSORT_VS_ROWS_TOL = 1e-10

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
ZSORT_VS_ROWS_STEPS = 32
ZSORT_KERNELS = ("build_window_lists", "fused_dense_chunk_list")


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
            pair_terms_report.append({
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
            cases["build_window_lists"].append({
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
            cases["fused_dense_chunk_list"].append({
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
    import math

    vals = [m["mean"] for m in summary["means"].values()] + [m["std"] for m in summary["means"].values()]
    vals += list(summary["thermodynamic_coefficients"].values())
    require(all(math.isfinite(x) for x in vals), f"non-finite means/thermo in {out_dir}/summary.json")


def _check_launches(run: str, counts: dict, needed: tuple, forbidden: tuple = ()) -> None:
    log(f"{run}: kernel launches {json.dumps(counts)}")
    for k in needed:
        require(counts.get(k, 0) > 0, f"{run}: kernel {k} was not launched on the main path")
    for k in forbidden:
        require(counts.get(k, 0) == 0, f"{run}: kernel {k} launched on another engine's path")


MAIN_KERNELS = ("pair_sweep_tri", "fused_dense_chunk", "fused_dense_chunk_ext") + ZSORT_KERNELS


def _cli_run(name: str, cfg, backend: str, tmp: str, needed: tuple, forbidden: tuple) -> dict:
    """One ``python -m ljmd_tpu_torch simulate`` run on the card; the counts
    are the CLI process's own (it starts at 0 and prints them at the end)."""
    import numpy as np

    cut = {k: getattr(cfg, k) for k in ("num_cells", "total_steps", "output_interval",
                                         "warmup_steps", "dt", "box_length", "rc_over_box",
                                         "target_total_energy", "dtype", "seed",
                                         "compensated_sum")}
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
                    forbidden: tuple) -> tuple[dict, object]:
    """initialize + run_production + artifacts in this process, the counts
    set to 0 just before and read just after."""
    from ljmd_tpu_torch.io.artifacts import write_run_artifacts
    from ljmd_tpu_torch.models.simulation import initialize, run_production
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    LAUNCHES.reset()
    t0 = time.time()
    state = initialize(cfg, backend=backend, device=dev)
    torch.cuda.synchronize()
    t1 = time.time()
    res = run_production(cfg, state, backend=backend, record_frames=True, device=dev)
    torch.cuda.synchronize()
    t2 = time.time()
    counts = LAUNCHES.snapshot()
    _check_launches(name, counts, needed, forbidden)
    diagnostics = {k: bool(v) for k, v in res.diagnostics.items()}
    require(not any(diagnostics.values()), f"{name}: diagnostic flag set: {diagnostics}")
    out_dir = os.path.join(tmp, name)
    write_run_artifacts(out_dir, cfg, res, write_frames=True)
    _check_artifacts(out_dir, with_frames=True)
    require(bool(torch.isfinite(res.series).all()), f"{name}: non-finite series")
    drift = _drift(res.series[2].cpu())
    rate = cfg.n * cfg.total_steps / (t2 - t1)
    warm_rate = cfg.n * cfg.warmup_steps / (t1 - t0)
    log(f"{name} (--backend {backend}): N={cfg.n} |dE/E| {drift:.3e} (bound "
        f"{DRIFT_BOUND[name]:.0e}), production {t2 - t1:.3f}s = {rate:.4e} particle-steps/s, "
        f"initialize (warmup {cfg.warmup_steps}) {t1 - t0:.3f}s = {warm_rate:.4e} particle-steps/s")
    require(drift < DRIFT_BOUND[name], f"{name}: energy drift over bound")
    return ({"engine": backend, "n": cfg.n, "drift": drift, "production_s": t2 - t1,
             "particle_steps_per_s": rate, "init_s": t1 - t0, "diagnostics": diagnostics,
             "launches": counts}, res.final_state)


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
    no_dense = ("fused_dense_chunk", "fused_dense_chunk_ext")
    no_list = ZSORT_KERNELS
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
    totals = dict.fromkeys(MAIN_KERNELS, 0)
    for run in runs.values():
        for k in totals:
            totals[k] += run["launches"].get(k, 0)
    return {"runs": runs, "launches": totals}, comp, final


# ---------------------------------------------------------------- phase 5
def phase_zsort_vs_rows(torch, cfg, state) -> float:
    """One float64 state (the N=4000 compensated zsort run's final fluid),
    32 fused steps on both engines: rows in one dense chunk, zsort in two
    list chunks with a resort before each."""
    from ljmd_tpu_torch.models import engine as pe
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    dev = torch.device(DEVICE)
    cfg = cfg.replace(dtype="float64", compensated_sum=False)
    state = state.to(device=dev, dtype=torch.float64)
    rows = pe.make_engine(cfg, "rows", dev)
    zsort = pe.make_engine(cfg, "zsort", dev)
    s_rows = rows.get_state(rows.run_fast(rows.init(state)[0], ZSORT_VS_ROWS_STEPS))
    c_z = zsort.run_fast(zsort.init(state)[0], ZSORT_VS_ROWS_STEPS)
    s_z = zsort.get_state(c_z)
    require(not bool(c_z.invalid), "zsort vs rows: zsort_invalid set")
    L = cfg.box_length
    d = s_z.r.double() - s_rows.r.double()
    d = d - L * torch.round(d / L)  # a particle on a face may wrap on either side
    worst = float(d.abs().max()) / max(1.0, float(s_rows.r.abs().max()))
    for k in ("ru", "v", "a"):
        worst = max(worst, rel_err(getattr(s_z, k), getattr(s_rows, k))[1])
    LAUNCHES.reset()
    log(f"zsort vs rows on the card (N={cfg.n}, float64, {ZSORT_VS_ROWS_STEPS} fused steps, "
        f"2 resorts): max rel diff over r, ru, v, a {worst:.3e} (tol {ZSORT_VS_ROWS_TOL:.0e})")
    require(worst <= ZSORT_VS_ROWS_TOL, "zsort and rows disagree")
    return worst


# ---------------------------------------------------------------- phase 6
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
        main_path, final_cfg, final_state = phase_main_path(torch, tmp)
    zsort_vs_rows = phase_zsort_vs_rows(torch, final_cfg, final_state)
    series_err = phase_card_vs_cpu(torch)

    # Headline shape per kernel: where the main path runs it at full size;
    # every case is listed beside it.
    headline = {"lj_pair_terms": ("N=4000", "float32"),
                "pair_sweep_tri": ("N=4000", "float32"),
                "fused_dense_chunk": ("N=4000", "float32"),
                "fused_dense_chunk_ext": ("N=500", "float32"),
                "build_window_lists": ("N=4000", "float32"),
                "fused_dense_chunk_list": ("N=4000", "float32")}
    meta = {
        "lj_pair_terms": ("ljmd_tpu_torch/csrc/lj_pair_terms.cuh", "ljmd_tpu/ops/pallas_common.py:17"),
        "pair_sweep_tri": ("ljmd_tpu_torch/csrc/pair_sweep_tri.cu", "ljmd_tpu/ops/pallas_lj.py:240"),
        "fused_dense_chunk": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:537"),
        "fused_dense_chunk_ext": ("ljmd_tpu_torch/csrc/fused_dense_chunk.cu", "ljmd_tpu/ops/pallas_fused.py:465"),
        "build_window_lists": ("ljmd_tpu_torch/csrc/pack_window_lists.cu", "ljmd_tpu/ops/pallas_fused.py:803"),
        "fused_dense_chunk_list": ("ljmd_tpu_torch/csrc/fused_dense_chunk_list.cu", "ljmd_tpu/ops/pallas_fused.py:1383"),
    }
    launches = dict(main_path["launches"])
    # lj_pair_terms is a __device__ function with no launch of its own on the
    # main path: it runs inside every sweep and chunk launch, so its count is
    # theirs (its own element-wise kernel runs only in the comparison).
    launches["lj_pair_terms"] = sum(launches[k] for k in MAIN_KERNELS if k != "build_window_lists")
    kernels = []
    for name, (source, replaces) in meta.items():
        head = next(c for c in cases[name] if (c["shape"], c["dtype"]) == headline[name])
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "timed_at": f"{head['shape']} {head['dtype']}", "cases": cases[name],
        }
        if name == "lj_pair_terms":
            entry["launches_counted_as"] = "launches of the kernels that inline it"
        kernels.append(entry)
    runs = main_path["runs"]
    log(f"main path runs: {json.dumps(runs)}")
    for n_label, rows_run, zsort_run in (("N=4000", "n4000_f32", "n4000_f32_zsort"),
                                         ("N=864", "n864_f32", "n864_f32_zsort")):
        r_rate = runs[rows_run]["particle_steps_per_s"]
        z_rate = runs[zsort_run]["particle_steps_per_s"]
        log(f"production {n_label} float32 on {env['nvidia_smi']}: zsort {z_rate:.4e} "
            f"particle-steps/s, rows {r_rate:.4e} (zsort / rows {z_rate / r_rate:.3f})")
    log(f"card {env['nvidia_smi']}; zsort-vs-rows rel diff {zsort_vs_rows:.3e}; "
        f"card-vs-CPU series rel diff {series_err:.3e}")
    print(json.dumps({"kernels": kernels}))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
