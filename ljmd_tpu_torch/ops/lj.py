"""Dense Lennard-Jones force / energy / virial oracle (counterpart of
``ljmd_tpu/ops/lj.py``; rebuild of the reference kernel
``scripts/physics/lj_potential_energy.f90:46-225``).

Sweeps the full N x N pair matrix as (N, N) tensors with minimum image, a
sharp cutoff, and optional mean-field tail corrections; the symmetric scalar
sums are halved. This is the correctness oracle and the ``"dense"`` engine's
force; the rows engine uses the kernels of ``pair_sweep.py`` / ``fused.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ljmd_tpu_torch.ops.geometry import minimum_image
from ljmd_tpu_torch.state import replica_sum

__all__ = [
    "LJResult",
    "tail_corrections",
    "lj_force_energy_dense",
    "lj_potential_dense",
]

PI = 3.14159265358979323846


@dataclasses.dataclass(frozen=True)
class LJResult:
    a: torch.Tensor        # (N, 3) accelerations (a stack's (R, N, 3))
    epot: torch.Tensor     # scalar (a stack's (R,): each replica's own)
    d_epot: torch.Tensor   # scalar (R,)
    dd_epot: torch.Tensor  # scalar (R,)


def tail_corrections(n: int, volume: float, rc: float) -> Tuple[float, float, float]:
    """Mean-field tail corrections for (epot, d_epot, dd_epot), in Python
    floats (lj_potential_energy.f90:205-212):
      tail_factor = 8 pi N^2 / (V rc^3)
      epot_tail   = tail_factor * (1/(3 rc^6) - 1) / 3
      d_tail      = 2 tail_factor * (-2/(3 rc^6) + 1)
      dd_tail     = 2 tail_factor * (26/(3 rc^6) - 7)
    """
    rc3 = rc**3
    rc6 = rc3 * rc3
    tail_factor = 8.0 * PI * (n * n) / (volume * rc3)
    epot_tail = tail_factor * ((1.0 / (3.0 * rc6)) - 1.0) / 3.0
    d_tail = 2.0 * tail_factor * (-2.0 / (3.0 * rc6) + 1.0)
    dd_tail = 2.0 * tail_factor * (26.0 / (3.0 * rc6) - 7.0)
    return epot_tail, d_tail, dd_tail


def _pair_terms(r2: torch.Tensor, mask: torch.Tensor):
    """(pair_epot, dU_r, pair_ddU, inv_r2), zero outside ``mask``; the
    prefactors (4 energy, 24 derivatives) are restored by the caller."""
    one = torch.ones((), dtype=r2.dtype, device=r2.device)
    r2_safe = torch.where(mask, r2, one)
    inv_r2 = torch.where(mask, one / r2_safe, torch.zeros_like(one))
    inv_r6 = inv_r2 * inv_r2 * inv_r2
    inv_r12 = inv_r6 * inv_r6
    pair_epot = inv_r12 - inv_r6
    dU_r = -2.0 * inv_r12 + inv_r6
    pair_ddU = 26.0 * inv_r12 - 7.0 * inv_r6
    return pair_epot, dU_r, pair_ddU, inv_r2


def _pair_geometry(r: torch.Tensor, box_length: float, rc_square: float):
    n = r.shape[-2]
    inv_l = 1.0 / box_length
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    dx = minimum_image(x[..., :, None] - x[..., None, :], box_length, inv_l)
    dy = minimum_image(y[..., :, None] - y[..., None, :], box_length, inv_l)
    dz = minimum_image(z[..., :, None] - z[..., None, :], box_length, inv_l)
    r2 = dx * dx + dy * dy + dz * dz
    eye = torch.eye(n, dtype=torch.bool, device=r.device)
    mask = (r2 < rc_square) & ~eye
    return dx, dy, dz, r2, mask


def lj_force_energy_dense(
    r: torch.Tensor,
    box_length: float,
    rc_square: float,
    use_tail_corrections: bool = True,
    volume: float | None = None,
    rc: float | None = None,
) -> LJResult:
    """Dense all-pairs LJ forces + energy + virial sums of (N, 3) wrapped
    positions, or of an (R, N, 3) stack of R replicas: then (R,) sums, each
    replica's own, and each replica's forces those of its (N, 3) call (the
    rows reduce one by one either way)."""
    n = r.shape[-2]
    dx, dy, dz, r2, mask = _pair_geometry(r, box_length, rc_square)
    pair_epot, dU_r, pair_ddU, inv_r2 = _pair_terms(r2, mask)

    # Full-matrix sums double count i<j -> halve, then restore prefactors.
    epot = 2.0 * replica_sum(pair_epot)
    d_epot = 12.0 * replica_sum(dU_r)
    dd_epot = 12.0 * replica_sum(pair_ddU)

    coef = -dU_r * inv_r2
    ax = torch.sum(coef * dx, dim=-1)
    ay = torch.sum(coef * dy, dim=-1)
    az = torch.sum(coef * dz, dim=-1)
    a = 24.0 * torch.stack([ax, ay, az], dim=-1)

    if use_tail_corrections:
        if volume is None or rc is None:
            raise ValueError("tail corrections require volume and rc")
        e_t, d_t, dd_t = tail_corrections(n, volume, rc)
        epot = epot + e_t
        d_epot = d_epot + d_t
        dd_epot = dd_epot + dd_t
    return LJResult(a=a, epot=epot, d_epot=d_epot, dd_epot=dd_epot)


def lj_potential_dense(
    r: torch.Tensor,
    box_length: float,
    rc_square: float,
    use_tail_corrections: bool = True,
    volume: float | None = None,
    rc: float | None = None,
) -> torch.Tensor:
    """Potential energy only, differentiable with autograd: minus its
    gradient must equal the forces of ``lj_force_energy_dense``."""
    n = r.shape[-2]
    _, _, _, r2, mask = _pair_geometry(r, box_length, rc_square)
    pair_epot, _, _, _ = _pair_terms(r2, mask)
    epot = 2.0 * torch.sum(pair_epot)
    if use_tail_corrections:
        if volume is None or rc is None:
            raise ValueError("tail corrections require volume and rc")
        e_t, _, _ = tail_corrections(n, volume, rc)
        epot = epot + e_t
    return epot

