"""Command-line interface of the PyTorch port (counterpart of
``ljmd_tpu/cli.py:40-116, 279-355``):

  python -m ljmd_tpu_torch init-config --config <file> [--out rv_init.dat]
                                       [--device cuda] [--backend auto]
  python -m ljmd_tpu_torch simulate    --config <file> --out-dir <dir>
                                       [--from-init rv_init.dat] [--no-frames]
                                       [--device cuda] [--backend auto]

``--backend``: auto (on a CUDA device zsort where it fits, cellpair for
large N, rows otherwise; rows on the CPU), rows (or pallas, the JAX
package's name for it), zsort, cellpair, neighbor or dense.
``simulate`` ends with a ``{"diagnostics": ...}`` line (``zsort_invalid``,
``pencil_overflow``, ``neighbor_overflow``), a ``{"kernel_launches": ...}``
line and a ``{"host_reads": ...}`` line (device flags the engines read on
the host, ``engine.HOST_READS``).

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
    """Fail fast on an unusable initial state: NaN velocities mean the
    target energy is below the lattice's potential energy (the reference
    stops there too, md_initial_config_program.f90:257)."""
    for name in ("r", "ru", "v", "a"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise SystemExit(
                f"error: initial state.{name} is not finite. Most common "
                f"cause: target_total_energy={cfg.target_total_energy} is "
                "below the potential energy of the initial lattice, so the "
                "velocity rescale has no solution. Raise target_total_energy."
            )
    r = state.r
    if bool((r < 0).any()) or bool((r >= cfg.box_length).any()):
        raise SystemExit("error: initial positions are not wrapped into [0, L)")


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
    out = run_production(cfg, state, backend=args.backend, record_frames=record,
                         device=device)
    _sync(device)
    t2 = time.time()
    out_dir = args.out_dir or "outputs/one_run"
    write_run_artifacts(out_dir, cfg, out, write_frames=record)
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
    print(_launch_report())
    print(_host_read_report())
    return 0


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
    sp.set_defaults(fn=cmd_simulate)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
