"""Force-backend dispatch (counterpart of ``ljmd_tpu/models/forces.py``).

Every backend is a function of (N, 3) positions returning an ``LJResult``
with the dense oracle's semantics, tail corrections included:

- ``dense``: the all-pairs ``ops/lj.py`` oracle; it also takes an (R, N, 3)
  stack of R replicas (the batched dense engine's), with (R,) sums;
- ``pallas``: the ordered N x N sweep (``ops/pair_sweep.py``,
  ``lj_force_energy_pallas``): in this package the name means the
  hand-written CUDA kernel ``csrc/pair_sweep.cu`` on the card (its plain twin
  on a CPU tensor);
- ``neighbor``: a Verlet list built on every call (``ops/neighbor.py``);
  correct but wasteful, the neighbor engine amortizes the builds;
- ``auto``: ``pallas`` on a CUDA device at n >= 512, else ``dense`` (the JAX
  package's accelerator rule).
"""

from __future__ import annotations

from typing import Callable

import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.ops.lj import LJResult, lj_force_energy_dense

__all__ = ["FORCE_BACKENDS", "make_force_fn", "resolve_device"]

FORCE_BACKENDS = ("auto", "dense", "pallas", "neighbor")


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; raises when CUDA is asked for and no
    CUDA device is present (nothing silently runs on another device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def _dense_fn(cfg: SimConfig) -> Callable[[torch.Tensor], LJResult]:
    def force(r: torch.Tensor) -> LJResult:
        return lj_force_energy_dense(r, box_length=cfg.box_length, rc_square=cfg.rc_square,
                                     use_tail_corrections=cfg.use_tail_corrections,
                                     volume=cfg.volume, rc=cfg.rc)

    return force


def _neighbor_fn(cfg: SimConfig) -> Callable[[torch.Tensor], LJResult]:
    from ljmd_tpu_torch.ops.neighbor import (
        build_neighbor_list_dense,
        estimate_capacity,
        lj_force_energy_neighbor,
    )

    r_list = cfg.rc + cfg.neighbor_skin
    capacity = cfg.neighbor_capacity or estimate_capacity(cfg.density, r_list)

    def force(r: torch.Tensor) -> LJResult:
        nbrs = build_neighbor_list_dense(r, cfg.box_length, r_list * r_list, capacity)
        return lj_force_energy_neighbor(r, nbrs.idx, box_length=cfg.box_length,
                                        rc_square=cfg.rc_square,
                                        use_tail_corrections=cfg.use_tail_corrections,
                                        volume=cfg.volume, rc=cfg.rc)

    return force


def make_force_fn(cfg: SimConfig, backend: str = "auto",
                  device="cuda") -> Callable[[torch.Tensor], LJResult]:
    """The force function of ``backend`` for positions on ``device`` (default
    the card; raises where there is none). ``auto`` takes the kernel path on
    a CUDA device at n >= 512 and the dense oracle otherwise."""
    if backend not in FORCE_BACKENDS:
        raise ValueError(f"unknown force backend {backend!r}; expected one of {FORCE_BACKENDS}")
    device = resolve_device(device)
    if backend == "auto":
        backend = "pallas" if device.type == "cuda" and cfg.n >= 512 else "dense"
    if backend == "dense":
        return _dense_fn(cfg)
    if backend == "pallas":
        from ljmd_tpu_torch.ops.pair_sweep import make_pallas_force_fn

        return make_pallas_force_fn(cfg)
    return _neighbor_fn(cfg)
