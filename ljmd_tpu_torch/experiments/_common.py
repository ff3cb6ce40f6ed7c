"""What the experiments share: the device, timing, the lattice fluids they
start from and the command line."""

from __future__ import annotations

import argparse
import math
import time

import torch

from ljmd_tpu_torch.config import SimConfig, config_from_density
from ljmd_tpu_torch.models.engine import _zsort_engine
from ljmd_tpu_torch.models.forces import resolve_device
from ljmd_tpu_torch.models.lattice import fcc_lattice, random_velocities, remove_com_velocity
from ljmd_tpu_torch.state import MDState

__all__ = ["best_of", "device_line", "elapsed_s", "lattice_state", "melted_zsort", "parser"]


def elapsed_s(fn, device: torch.device) -> float:
    """Seconds of ``fn()``: CUDA events on the card, the host clock on the
    CPU (where it times the plain versions: no device number)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return 1e-3 * start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def best_of(fn, device: torch.device, reps: int = 3) -> float:
    """The least of ``reps`` timings of ``fn()`` (the caller warms it up)."""
    return min(elapsed_s(fn, device) for _ in range(reps))


def device_line(device: torch.device) -> str:
    if device.type == "cuda":
        return (f"devices: [{torch.cuda.get_device_name(device)}] x "
                f"{torch.cuda.device_count()} (torch {torch.__version__}, CUDA "
                f"{torch.version.cuda})")
    return "devices: [cpu] (plain versions; times are not device times)"


def lattice_state(num_cells: int, device, seed: int = 0, temperature: float = 0.728,
                  **cfg_kw) -> tuple[SimConfig, MDState]:
    """The JAX experiments' start: an FCC lattice at density 0.8442 with
    velocities uniform in [-0.5, 0.5) (a seeded ``torch.Generator``; JAX
    draws other numbers from its key), the centre-of-mass motion removed and
    scaled to ``temperature``, a = 0."""
    cfg = config_from_density(num_cells=num_cells, density=0.8442, **cfg_kw)
    n = cfg.n
    r = fcc_lattice(num_cells, cfg.box_length, dtype=torch.float64)
    v = remove_com_velocity(random_velocities(torch.Generator().manual_seed(seed), n,
                                              dtype=torch.float64))
    v = v * math.sqrt(temperature / (float(torch.sum(v * v)) / (3 * n)))
    dtype = getattr(torch, cfg.dtype)
    state = MDState(r=r, ru=r.clone(), v=v, a=torch.zeros_like(r))
    return cfg, state.to(device=resolve_device(device), dtype=dtype)


def melted_zsort(device, num_cells: int = 10, melt: int = 512):
    """(cfg, engine, carry): the N = 4 num_cells^3 float32 lattice at
    dt 0.005 melted ``melt`` steps by the zsort engine (plain chunks)."""
    cfg, state = lattice_state(num_cells, device, dt=0.005, dtype="float32")
    eng = _zsort_engine(cfg, state.r.device, extended=False)
    c, _ = eng.init(state)
    c = eng.run_fast(c, melt)
    return cfg, eng, c


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu (the plain versions)")
    return p
