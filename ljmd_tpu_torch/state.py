"""Simulation state as dataclasses of tensors (counterpart of
``ljmd_tpu/state.py``).

Rebuild of the reference's ``sim_state`` struct-of-arrays container
(``scripts/base/md_types.f90:56-60,175-230``) plus the unwrapped-coordinate
arrays its driver allocates (``scripts/md_simulation_program.f90:199-231``).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["MDState", "StepObs", "kinetic_energy", "replica_sum"]


@dataclasses.dataclass(frozen=True)
class MDState:
    """Full microscopic state at one instant. Fields (all ``(N, 3)``
    tensors, reduced units):

      r   wrapped positions in [0, L)
      ru  unwrapped positions (continuous across PBC; for MSD/diffusion)
      v   velocities
      a   accelerations (= forces, since m = 1)
    """

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.r.device

    def to(self, device=None, dtype=None) -> "MDState":
        return MDState(*(t.to(device=device, dtype=dtype)
                         for t in (self.r, self.ru, self.v, self.a)))


@dataclasses.dataclass(frozen=True)
class StepObs:
    """Instantaneous observables of one step, evaluated at t + dt (0-d
    tensors; reference ``verlet.f90:41-97``).

      epot     total LJ potential energy U (tail-corrected)
      ekin     kinetic energy K = 1/2 sum v^2
      d_epot   sum_{i<j} r_ij dU/dr_ij  (virial sum; W = -d_epot)
      dd_epot  sum_{i<j} r_ij^2 d2U/dr_ij^2
    """

    epot: torch.Tensor
    ekin: torch.Tensor
    d_epot: torch.Tensor
    dd_epot: torch.Tensor

    @property
    def etot(self) -> torch.Tensor:
        return self.epot + self.ekin


def kinetic_energy(v: torch.Tensor) -> torch.Tensor:
    """K = 1/2 sum_i |v_i|^2 (reference verlet.f90:93-95), in v's dtype.
    (R, N, 3) velocities give (R,) energies, each replica's own sum."""
    return 0.5 * replica_sum(v * v)


def replica_sum(x: torch.Tensor, dims: int = 2) -> torch.Tensor:
    """The sum over x's trailing ``dims`` dimensions: the whole sum where x
    has no more (one system), else one sum a replica of the leading axis.
    (The one-system call stays ``torch.sum(x)``: a reduction over fewer
    dimensions may split otherwise and round otherwise.)"""
    return torch.sum(x) if x.dim() == dims else torch.sum(x, dim=tuple(range(-dims, 0)))
