"""Velocity-Verlet step (counterpart of ``ljmd_tpu/models/integrators.py``;
rebuild of ``scripts/physics/verlet.f90:41-97`` plus the driver's unwrap
tracking, ``scripts/md_simulation_program.f90:339-353``). Used by the
``"dense"`` engine; the rows engine integrates in its own row layout."""

from __future__ import annotations

from typing import Callable

import torch

from ljmd_tpu_torch.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu_torch.ops.lj import LJResult
from ljmd_tpu_torch.state import MDState, StepObs, kinetic_energy

__all__ = ["velocity_verlet_step"]

ForceFn = Callable[[torch.Tensor], LJResult]


def velocity_verlet_step(state: MDState, force_fn: ForceFn, dt: float,
                         box_length: float) -> tuple[MDState, StepObs]:
    """One velocity-Verlet step:

      r'  = wrap(r + v dt + a dt^2/2)
      v_h = v + a dt/2
      a'  = F(r') / m
      v'  = v_h + a' dt/2
      ru' = ru + MIC(r' - r)
      K   = 1/2 sum |v'|^2

    Elementwise but for K, so an (R, N, 3) state with a force function of
    stacks steps R replicas, K each replica's own (``kinetic_energy``).
    """
    half_dt = 0.5 * dt
    half_dt_sq = 0.5 * dt * dt
    r_new = wrap_positions(state.r + state.v * dt + state.a * half_dt_sq, box_length)
    v_half = state.v + state.a * half_dt
    res = force_fn(r_new)
    v_new = v_half + res.a * half_dt
    ru_new = state.ru + minimum_image(r_new - state.r, box_length)
    obs = StepObs(epot=res.epot, ekin=kinetic_energy(v_new),
                  d_epot=res.d_epot, dd_epot=res.dd_epot)
    return MDState(r=r_new, ru=ru_new, v=v_new, a=res.a), obs
