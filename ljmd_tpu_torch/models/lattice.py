"""Initial configuration: lattice and velocities (counterpart of
``ljmd_tpu/models/lattice.py``; rebuild of the init pipeline of
``scripts/md_initial_config_program.f90``).

- ``fcc_lattice``: k^3 cells x 4-atom basis, lattice constant a = L/k,
  cell-major ordering matching the reference's particle indexing
  (md_initial_config_program.f90:132-187); built in float64 numpy (exact
  multiples of a/2) then cast.
- ``random_velocities``: uniform in [-0.5, 0.5) per component from an
  explicit ``torch.Generator`` (the reference's SAVE-state ran3 stream is in
  ``utils/ran3.py`` for bit-exact parity).
- ``remove_com_velocity``: zero total momentum (:218-234).
- ``rescale_to_target_energy``: v *= sqrt((E_target - U) / K) (:244-266).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "fcc_lattice",
    "random_velocities",
    "remove_com_velocity",
    "rescale_to_target_energy",
]

_FCC_BASIS = np.array(
    [
        [0.0, 0.0, 0.0],
        [0.0, 0.5, 0.5],
        [0.5, 0.0, 0.5],
        [0.5, 0.5, 0.0],
    ]
)


def fcc_lattice(num_cells: int, box_length: float, dtype=torch.float32,
                device="cpu") -> torch.Tensor:
    """(4 k^3, 3) FCC positions in [0, L), reference ordering."""
    k = num_cells
    a = box_length / k
    ix, iy, iz = np.meshgrid(np.arange(k), np.arange(k), np.arange(k), indexing="ij")
    origins = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3) * a
    pos = origins[:, None, :] + _FCC_BASIS[None, :, :] * a
    return torch.as_tensor(pos.reshape(-1, 3), dtype=dtype, device=device)


def random_velocities(generator: torch.Generator, n: int, dtype=torch.float32,
                      device="cpu") -> torch.Tensor:
    """(N, 3) velocities uniform in [-0.5, 0.5), drawn in float64 on the
    generator's device (CPU), so every device gets the same numbers."""
    u = torch.rand((n, 3), generator=generator, dtype=torch.float64,
                   device=generator.device)
    return (u - 0.5).to(device=device, dtype=dtype)


def remove_com_velocity(v: torch.Tensor) -> torch.Tensor:
    """Subtract the center-of-mass velocity: sum_i v_i = 0 afterwards."""
    return v - torch.mean(v, dim=-2, keepdim=True)


def rescale_to_target_energy(v: torch.Tensor, epot, target_total_energy) -> torch.Tensor:
    """Rescale velocities so E_pot + E_kin = target; NaN velocities when the
    target is below the potential energy (the CLI checks for that). (R, N,
    3) velocities with (R,) energies rescale each replica on its own."""
    target = torch.as_tensor(target_total_energy, dtype=v.dtype, device=v.device)
    if v.dim() == 2:
        ekin_old = 0.5 * torch.sum(v * v)
        return v * torch.sqrt((target - epot) / ekin_old)
    ekin_old = 0.5 * torch.sum(v * v, dim=(-2, -1))
    return v * torch.sqrt((target - epot) / ekin_old)[..., None, None]
