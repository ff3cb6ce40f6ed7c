"""Verlet neighbor lists with a skin and the O(N*K) force path (counterpart
of ``ljmd_tpu/ops/neighbor.py``).

A fixed-capacity list stores, per particle, up to K neighbor indices within
rc_list = rc + skin, ascending, padded with the sentinel index N (a phantom
row appended to the gathered positions). Both directions of a pair are
stored, so the scalar sums are halved as in the dense oracle. The list is
rebuilt when some particle has moved more than skin/2 since the build;
``overflow`` flags a particle with more than K in-range neighbors (the list
is then incomplete).

Plain PyTorch on every device: gathers and a sort, no kernel of its own (the
JAX module has no Pallas kernel either). The TPU avoided this path for want
of a lane gather; Hopper gathers in hardware.
"""

from __future__ import annotations

import dataclasses

import torch

from ljmd_tpu_torch.ops.geometry import minimum_image
from ljmd_tpu_torch.ops.lj import LJResult, _pair_terms, tail_corrections

__all__ = [
    "NeighborList",
    "estimate_capacity",
    "build_neighbor_list_dense",
    "needs_rebuild",
    "lj_force_energy_neighbor",
]


@dataclasses.dataclass(frozen=True)
class NeighborList:
    """idx: (N, K) int32 neighbor indices, sentinel N for empty entries;
    r_ref: (N, 3) positions at build time (the displacement criterion);
    overflow: 0-d bool, True if a particle had more than K neighbors."""

    idx: torch.Tensor
    r_ref: torch.Tensor
    overflow: torch.Tensor


def estimate_capacity(density: float, r_list: float, safety: float = 1.35) -> int:
    """Static neighbor capacity: the ideal-gas count in the r_list sphere
    times a safety factor, plus 8, rounded up to a multiple of 8."""
    mean_count = density * (4.0 / 3.0) * 3.141592653589793 * r_list**3
    k = int(mean_count * safety) + 8
    return ((k + 7) // 8) * 8


def build_neighbor_list_dense(r: torch.Tensor, box_length: float, r_list_square: float,
                              capacity: int) -> NeighborList:
    """O(N^2) build: the full minimum-image distance matrix, then each row's
    first K in-range indices in ascending order (the JAX stable partition:
    in-range columns keyed j, the others n + j, every key distinct)."""
    n = r.shape[0]
    dev = r.device
    d = minimum_image(r[:, None, :] - r[None, :, :], box_length)
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    mask = (r2 < r_list_square) & ~eye
    cols = torch.arange(n, dtype=torch.int32, device=dev).expand(n, n)
    key = torch.where(mask, cols, n + cols)
    idx = torch.sort(key, dim=1).values[:, :capacity]
    idx = torch.where(idx < n, idx, n).to(torch.int32)
    overflow = torch.any(mask.sum(dim=1) > capacity)
    return NeighborList(idx=idx, r_ref=r, overflow=overflow)


def needs_rebuild(nbrs: NeighborList, r: torch.Tensor, box_length: float,
                  skin: float) -> torch.Tensor:
    """0-d bool tensor: some particle moved more than skin/2 since the build
    (the Verlet-list criterion)."""
    d = minimum_image(r - nbrs.r_ref, box_length)
    return torch.max(torch.sum(d * d, dim=-1)) > (0.5 * skin) ** 2


def lj_force_energy_neighbor(r: torch.Tensor, idx: torch.Tensor, box_length: float,
                             rc_square: float, use_tail_corrections: bool = True,
                             volume: float | None = None, rc: float | None = None) -> LJResult:
    """LJ forces, energy and virial sums from a neighbor list: O(N*K)
    gathers. Equal to the dense oracle while the list is valid."""
    n = r.shape[0]
    r_pad = torch.cat([r, torch.zeros((1, 3), dtype=r.dtype, device=r.device)], dim=0)
    rj = r_pad[idx.long()]  # (N, K, 3)
    valid = idx < n
    d = minimum_image(r[:, None, :] - rj, box_length)
    r2 = torch.sum(d * d, dim=-1)
    mask = (r2 < rc_square) & valid
    pair_e, du_r, pair_ddu, inv_r2 = _pair_terms(r2, mask)
    coef = (-du_r * inv_r2)[..., None]
    a = 24.0 * torch.sum(coef * d, dim=1)
    # Each pair is in both lists: halve the scalar sums (4 / 24 prefactors).
    epot = 2.0 * torch.sum(pair_e)
    d_epot = 12.0 * torch.sum(du_r)
    dd_epot = 12.0 * torch.sum(pair_ddu)
    if use_tail_corrections:
        if volume is None or rc is None:
            raise ValueError("tail corrections require volume and rc")
        e_t, d_t, dd_t = tail_corrections(n, volume, rc)
        epot, d_epot, dd_epot = epot + e_t, d_epot + d_t, dd_epot + dd_t
    return LJResult(a=a, epot=epot, d_epot=d_epot, dd_epot=dd_epot)
