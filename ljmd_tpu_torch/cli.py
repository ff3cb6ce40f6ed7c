"""Command-line interface of the PyTorch port (counterpart of
``ljmd_tpu/cli.py``):

  python -m ljmd_tpu_torch init-config --config <file> [--out rv_init.dat]
                                       [--device cuda] [--backend auto]
  python -m ljmd_tpu_torch simulate    --config <file> --out-dir <dir>
                                       [--from-init rv_init.dat] [--no-frames]
                                       [--stream [--chunk-samples 64]]
                                       [--device cuda] [--backend auto]
  python -m ljmd_tpu_torch analyze     --run-dir <dir> [--device cuda]
                                       [--skip-rva] [--msd-fit-frac 0.5]
                                       [--vacf-tmax-frac 1.0] [--rva-max-lag L]
                                       [--origin-stride S] [--no-plots]
  python -m ljmd_tpu_torch run-all     --config <file> --out-dir <dir>
                                       (simulate, then analyze the run
                                        directory: the run_all.sh pipeline)
  python -m ljmd_tpu_torch ensemble    --config <file> --out-dir <dir>
                                       [--n-runs R] [--per-run-dirs]
                                       [--stream [--chunk-samples 32]]
                                       [--device cuda] [--backend auto]

``--backend``: auto (on a CUDA device zsort where it fits, cellpair for
large N, rows otherwise; rows on the CPU), rows (or pallas, the JAX
package's name for it), zsort, cellpair, neighbor or dense.
``simulate`` ends with a ``{"diagnostics": ...}`` line (``zsort_invalid``,
``pencil_overflow``, ``neighbor_overflow``), a ``{"kernel_launches": ...}``
line and a ``{"host_reads": ...}`` line (device flags the engines read on
the host, ``engine.HOST_READS``); with ``--stream`` (the chunked driver,
``models/streaming.py``: rva.dat written per chunk, a checkpoint per chunk,
a rerun in the same ``--out-dir`` resumes bit for bit) also a
``{"stream": ...}`` line (chunks, checkpoint bytes and seconds, frames and
bytes written and the seconds spent on them, the writer, the resume point).
``analyze`` plots with matplotlib; where it is not installed, pass
``--no-plots``. ``ensemble`` runs R replicas (``parallel/ensemble.py``:
batched on every backend's engine)
and writes means.txt, simulation_results.{txt,json} and corrmean_runs_*.dat,
with ``--per-run-dirs`` also run_XXXX/ per replica that is ok and
several_runs.txt; it ends with an ``{"ensemble": ...}`` line (replicas, N,
engine, production seconds, aggregate particle-steps/s, replicas ok, the
kernels launched, and in memory the replicas each diagnostic flag is set
in) and the ``{"kernel_launches": ...}`` line.

``--device`` is ``cuda`` by default (the port's kernels run on the card);
``--device cpu`` runs the same path through the kernels' plain PyTorch
twins. Asking for ``cuda`` where no CUDA device exists is an error, never a
silent switch to the CPU. Config files: the reference's block-text format
or JSON (``config.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _load_cfg(args):
    from ljmd_tpu_torch.config import SimConfig, load_config

    return load_config(args.config) if args.config else SimConfig()


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device {args.device} but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass --device cpu to run "
            "the plain PyTorch path"
        )
    return dev


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_initialized(state, cfg) -> None:
    """Fail fast on an unusable initial state (the reference stops inside
    rescale_velocities_to_target_energy when E_target < U,
    md_initial_config_program.f90:257; the port's init surfaces that as NaN
    velocities instead: catch it here before burning a full run)."""
    from ljmd_tpu_torch.utils.debug import validate_state

    try:
        validate_state(state, cfg.box_length)
    except FloatingPointError as e:
        raise SystemExit(
            f"error: initial state is not finite ({e}). Most common cause: "
            f"target_total_energy={cfg.target_total_energy} is below the "
            "potential energy of the initial lattice, so the velocity "
            "rescale has no solution (reference aborts with 'target energy "
            "too low'). Raise target_total_energy."
        ) from e


def _launch_report() -> str:
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    return json.dumps({"kernel_launches": LAUNCHES.snapshot()})


def _host_read_report() -> str:
    from ljmd_tpu_torch.models.engine import HOST_READS

    return json.dumps({"host_reads": HOST_READS})


def cmd_init_config(args) -> int:
    from ljmd_tpu_torch.io.checkpoint import save_rv_init
    from ljmd_tpu_torch.models.simulation import initialize

    cfg = _load_cfg(args)
    device = _device(args)
    t0 = time.time()
    seed = args.seed if args.seed is not None else cfg.seed
    state = initialize(cfg, torch.Generator().manual_seed(seed),
                       backend=args.backend, device=device)
    _check_initialized(state, cfg)
    out = args.out or "outputs/rv_init.dat"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_rv_init(out, state)
    print(f"wrote {out} (N={cfg.n}, warmup={cfg.warmup_steps} steps, "
          f"device={device}, {time.time() - t0:.1f}s)")
    print(_launch_report())
    return 0


def cmd_simulate(args) -> int:
    from ljmd_tpu_torch.io.artifacts import write_run_artifacts
    from ljmd_tpu_torch.io.checkpoint import load_rv_init
    from ljmd_tpu_torch.models.engine import _effective_dtype
    from ljmd_tpu_torch.models.simulation import initialize, run_production

    cfg = _load_cfg(args)
    device = _device(args)
    t0 = time.time()
    if args.from_init:
        state = load_rv_init(args.from_init, cfg.n, dtype=_effective_dtype(cfg),
                             device=device)
    else:
        state = initialize(cfg, torch.Generator().manual_seed(cfg.seed),
                           backend=args.backend, device=device)
    _check_initialized(state, cfg)
    _sync(device)
    t1 = time.time()
    record = not args.no_frames
    out_dir = args.out_dir or "outputs/one_run"
    stream_stats = None
    if args.stream:
        from ljmd_tpu_torch.models.streaming import run_production_streaming

        stream_stats = {}
        out = run_production_streaming(cfg, state, out_dir, backend=args.backend,
                                       chunk_samples=args.chunk_samples, write_frames=record,
                                       device=device, stats=stream_stats)
    else:
        out = run_production(cfg, state, backend=args.backend, record_frames=record,
                             device=device)
    _sync(device)
    t2 = time.time()
    write_run_artifacts(out_dir, cfg, out, write_frames=record and not args.stream)
    diagnostics = {k: bool(v) for k, v in out.diagnostics.items()}
    for k, v in diagnostics.items():
        if v:
            print(f"WARNING: diagnostic flag {k} is set", file=sys.stderr)
    print(f"simulated N={cfg.n} x {cfg.total_steps} steps on {device}: "
          f"init {t1 - t0:.2f}s, production {t2 - t1:.2f}s "
          f"({cfg.n * cfg.total_steps / (t2 - t1):.4e} particle-steps/s); "
          f"artifacts in {out_dir}")
    print(json.dumps({k: float(out.means.mean(k))
                      for k in ("epot", "ekin", "etot", "temp", "press")}))
    print(json.dumps({"diagnostics": diagnostics}))
    if stream_stats is not None:
        print(json.dumps({"stream": stream_stats}))
    print(_launch_report())
    print(_host_read_report())
    return 0


def cmd_analyze(args) -> int:
    from ljmd_tpu_torch.analysis.report import analyze_run

    device = _device(args)
    t0 = time.time()
    summary = analyze_run(
        args.run_dir,
        skip_rva=args.skip_rva,
        msd_fit_frac=args.msd_fit_frac,
        vacf_tmax_frac=args.vacf_tmax_frac,
        rva_max_lag=args.rva_max_lag,
        origin_stride=args.origin_stride,
        make_plots=not args.no_plots,
        device=device,
    )
    traj = summary.get("trajectory", {})
    if traj:
        print(f"D_einstein={traj['D_einstein']:.6g}  D_green_kubo={traj['D_green_kubo']:.6g}")
    print(f"analysis_summary.json written in {args.run_dir} on {device} "
          f"({time.time() - t0:.2f}s)")
    return 0


def cmd_ensemble(args) -> int:
    from ljmd_tpu_torch.models.engine import resolve_backend
    from ljmd_tpu_torch.models.simulation import (
        initialize_replicas,
        replica_generators,
        run_production,
    )
    from ljmd_tpu_torch.parallel.ensemble import (
        ensemble_aggregate,
        ensemble_simulate_streaming,
        replica_result,
    )

    if args.per_run_dirs and args.stream:
        raise SystemExit("error: --per-run-dirs needs the in-memory ensemble, not --stream")
    cfg = _load_cfg(args)
    device = _device(args)
    n_runs = args.n_runs or cfg.n_runs
    out_dir = args.out_dir or "outputs"
    os.makedirs(out_dir, exist_ok=True)
    engine = resolve_backend(cfg, args.backend, device, cfg.output_interval)
    t0 = time.time()
    stream_stats = None
    if args.stream:
        # The series to the host per chunk, the correlations over replica
        # groups; init and production are one call, timed together.
        stream_stats = {}
        out = ensemble_simulate_streaming(cfg, n_replicas=n_runs, backend=args.backend,
                                          device=device, chunk_samples=args.chunk_samples,
                                          stats=stream_stats)
        _sync(device)
        t1 = t0
    else:
        states = initialize_replicas(cfg, replica_generators(cfg.seed, n_runs),
                                     backend=args.backend, device=device)
        _sync(device)
        t1 = time.time()
        results = run_production(cfg, states, backend=args.backend, device=device)
        out = ensemble_aggregate(cfg, results)
        _sync(device)
    t2 = time.time()
    ok = out.replica_ok.cpu().numpy()
    if args.per_run_dirs:
        from ljmd_tpu_torch.io.artifacts import write_run_artifacts

        # run_XXXX/ per replica that is ok + several_runs.txt
        # (run_many_md.f90:59,74)
        run_dirs = []
        for i in range(n_runs):
            d = os.path.join(out_dir, f"run_{i:04d}")
            if ok[i]:
                write_run_artifacts(d, cfg, replica_result(results, i), write_frames=False)
                run_dirs.append(d)
        with open(os.path.join(out_dir, "several_runs.txt"), "w") as f:
            f.write("\n".join(run_dirs) + ("\n" if run_dirs else ""))
    write_ensemble_artifacts(out_dir, cfg, out, n_runs)
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    summary = {"replicas": n_runs, "n": cfg.n, "engine": engine, "batched": True,
               "device": str(device), "init_s": t1 - t0, "production_s": t2 - t1,
               "particle_steps_per_s": n_runs * cfg.n * cfg.total_steps / (t2 - t1),
               "n_ok": int(ok.sum()),
               "launches": {k: v for k, v in LAUNCHES.snapshot().items() if v}}
    if stream_stats is not None:
        summary["stream"] = stream_stats
    else:  # the replicas whose diagnostic flags are set, per flag
        summary["flags"] = {k: int(torch.as_tensor(v).sum())
                            for k, v in results.diagnostics.items()}
    print(json.dumps({"ensemble": summary}))
    print(_launch_report())
    print(f"{n_runs} replicas of N={cfg.n} x {cfg.total_steps} steps on {device} "
          f"({engine}, batched): "
          f"{int(ok.sum())} ok, {time.time() - t0:.1f}s; results in {out_dir}")
    return 0


def write_ensemble_artifacts(out_dir, cfg, out, n_runs) -> None:
    """Cross-run ensemble artifact set: means.txt, simulation_results.{txt,json},
    corrmean_runs_*.dat (the reference aggregator's output contract,
    simulation_results.f90 / run_many_md.f90:74-82), in the JAX package's
    text: the numbers go to numpy in their own dtype first."""
    import numpy as np

    from ljmd_tpu_torch.io.artifacts import CORR_OBS, write_corr_file
    from ljmd_tpu_torch.stats.moments import OBSERVABLES

    def host(x):
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)

    os.makedirs(out_dir, exist_ok=True)
    means = host(out.replica_means)
    mean_of_means, std_of_means = host(out.mean_of_means), host(out.std_of_means)
    thermo = {k: host(v) for k, v in out.thermo.as_dict().items()}
    lines = ["# run  " + "  ".join(OBSERVABLES)]
    for rmean in means:
        lines.append("  ".join(f"{v: .12e}" for v in rmean))
    with open(os.path.join(out_dir, "means.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

    results = {
        "n_runs": int(n_runs),
        "cross_run": {
            name: {"mean": float(mean_of_means[i]), "std": float(std_of_means[i])}
            for i, name in enumerate(OBSERVABLES)
        },
        "thermo_per_run": {k: v.tolist() for k, v in thermo.items()},
    }
    with open(os.path.join(out_dir, "simulation_results.json"), "w") as f:
        json.dump(results, f, indent=2)

    cm = host(out.corr_mean_runs)
    cnm = host(out.corr_norm_mean_runs)
    for i, obs in enumerate(CORR_OBS):
        write_corr_file(os.path.join(out_dir, f"corrmean_runs_{obs}.dat"), cm[i], cnm[i],
                        block_mean=True)

    with open(os.path.join(out_dir, "simulation_results.txt"), "w") as f:
        f.write(f"# cross-run statistics over {n_runs} runs\n")
        for i, name in enumerate(OBSERVABLES):
            f.write(f"<{name}>: {mean_of_means[i]: .12e}  std: {std_of_means[i]: .12e}\n")
        for k, arr in thermo.items():
            f.write(f"{k}: mean {arr.mean(): .12e}  std {arr.std(): .12e}\n")


def cmd_run_all(args) -> int:
    """simulate, then analyze the run directory with the default flags
    (run_all.sh:6-8; the kernels build at first use, inside simulate)."""
    rc = cmd_simulate(args)
    if rc:
        return rc
    args.run_dir = args.out_dir or "outputs/one_run"
    args.skip_rva = False
    args.msd_fit_frac = 0.5
    args.vacf_tmax_frac = 1.0
    args.rva_max_lag = None
    args.origin_stride = None
    return cmd_analyze(args)


def build_parser() -> argparse.ArgumentParser:
    from ljmd_tpu_torch.models.engine import BACKENDS

    p = argparse.ArgumentParser(prog="ljmd_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--config", help="reference block-text or JSON config file")
        sp.add_argument("--backend", default="auto",
                        choices=list(BACKENDS),
                        help="engine (default auto: on a CUDA device zsort where it "
                             "fits, cellpair for large N, rows otherwise)")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs "
                             "the kernels' plain PyTorch twins)")

    def stream_args(sp):
        sp.add_argument("--stream", action="store_true",
                        help="chunked streaming driver: incremental trajectory + "
                             "mid-run checkpoints, resumable after a crash")
        sp.add_argument("--chunk-samples", type=int, default=64)

    sp = sub.add_parser("init-config", help="build + warm up an initial configuration")
    common(sp)
    sp.add_argument("--out", help="rv_init.dat path (reference binary format)")
    sp.add_argument("--seed", type=int)
    sp.set_defaults(fn=cmd_init_config)

    sp = sub.add_parser("simulate", help="production run + artifacts")
    common(sp)
    sp.add_argument("--out-dir")
    sp.add_argument("--from-init", help="start from an rv_init.dat snapshot")
    sp.add_argument("--no-frames", action="store_true", help="skip rva.dat frames")
    stream_args(sp)
    sp.set_defaults(fn=cmd_simulate)

    sp = sub.add_parser("analyze", help="post-process a run directory")
    sp.add_argument("--run-dir", required=True)
    sp.add_argument("--skip-rva", action="store_true")
    sp.add_argument("--msd-fit-frac", type=float, default=0.5)
    sp.add_argument("--vacf-tmax-frac", type=float, default=1.0)
    sp.add_argument("--rva-max-lag", type=int)
    sp.add_argument("--origin-stride", type=int)
    sp.add_argument("--no-plots", action="store_true",
                    help="skip the PNGs (needed where matplotlib is not installed)")
    sp.add_argument("--device", default="cuda",
                    help="torch device of the trajectory analysis (default cuda)")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser("run-all", help="simulate + analyze pipeline")
    common(sp)
    sp.add_argument("--out-dir")
    sp.add_argument("--from-init", help="start from an rv_init.dat snapshot")
    sp.add_argument("--no-frames", action="store_true", help="skip rva.dat frames")
    sp.add_argument("--no-plots", action="store_true",
                    help="skip the PNGs (needed where matplotlib is not installed)")
    stream_args(sp)
    sp.set_defaults(fn=cmd_run_all)

    sp = sub.add_parser("ensemble", help="R replica runs + cross-run aggregation")
    common(sp)
    sp.add_argument("--out-dir")
    sp.add_argument("--n-runs", type=int, help="replicas (default the config's n_runs)")
    sp.add_argument("--per-run-dirs", action="store_true",
                    help="also write run_XXXX/ artifact directories per replica "
                         "(run_many_md parity)")
    sp.add_argument("--stream", action="store_true",
                    help="move the series to the host per chunk and run the "
                         "correlations over replica groups")
    sp.add_argument("--chunk-samples", type=int, default=32)
    sp.set_defaults(fn=cmd_ensemble)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
