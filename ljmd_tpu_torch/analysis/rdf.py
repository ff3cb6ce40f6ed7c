"""Radial distribution function g(r) on the frames' device (counterpart of
``ljmd_tpu/analysis/rdf.py``; rebuild of
``scripts/md_one_run_analysis.py:537-595``): minimum-image pair histogram of
wrapped positions over (optionally subsampled) snapshots and particles,
nbins=200 and rmax=L/2 by default, shell-volume and ideal-gas normalization:

  g(b) = hist(b) / (n_snap_used * n_eff * rho_eff * V_shell(b))

where hist counts ordered pairs (the reference adds 2 per i<j pair) and
rho_eff = n_eff / L^3 uses the subsampled particle count; the evenly spaced
subsampling (<= 200 snapshots, <= 800 particles by default) is the
reference's.

Snapshots go in batches: each computes the (B, n_eff, n_eff) minimum-image
distances and bins them with one ``torch.bincount`` whose last slot
(``nbins``) takes the diagonal and the pairs at or past rmax.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ljmd_tpu_torch.ops.geometry import minimum_image

__all__ = ["compute_rdf", "rdf_bin_centers"]

# Bytes of one batch's (B, n_eff, n_eff) distance matrix.
_BATCH_BYTES = 1 << 27


def rdf_bin_centers(box_length: float, nbins: int = 200, rmax: float | None = None):
    if rmax is None:
        rmax = 0.5 * box_length
    edges = np.linspace(0.0, rmax, nbins + 1)
    return 0.5 * (edges[:-1] + edges[1:])


def _subsample_indices(total: int, cap: int) -> np.ndarray:
    """Evenly spaced indices, the reference's np.linspace subsampling
    (md_one_run_analysis.py:556-561)."""
    if total > cap:
        return np.linspace(0, total - 1, cap, dtype=np.int64)
    return np.arange(total, dtype=np.int64)


def compute_rdf(
    r_frames: torch.Tensor,
    box_length: float,
    nbins: int = 200,
    rmax: float | None = None,
    max_snapshots: int = 200,
    max_particles: int = 800,
) -> torch.Tensor:
    """g(r) from wrapped-position frames (n_snap, N, 3) -> (nbins,). Use
    ``rdf_bin_centers`` for the abscissa."""
    n_snap, n = r_frames.shape[0], r_frames.shape[1]
    if rmax is None:
        rmax = 0.5 * box_length
    dtype, device = r_frames.dtype, r_frames.device

    snap_idx = torch.as_tensor(_subsample_indices(n_snap, max_snapshots), device=device)
    part_idx = torch.as_tensor(_subsample_indices(n, max_particles), device=device)
    n_eff = int(part_idx.shape[0])
    if n_eff < 2:
        raise ValueError("not enough particles for RDF after subsampling")

    frames = r_frames[snap_idx][:, part_idx, :]  # (S, n_eff, 3)
    inv_dr = nbins / rmax
    eye = torch.eye(n_eff, dtype=torch.bool, device=device)
    batch = max(1, _BATCH_BYTES // (n_eff * n_eff * frames.element_size()))
    hist = torch.zeros((nbins + 1,), dtype=torch.int64, device=device)
    for s0 in range(0, frames.shape[0], batch):
        snap = frames[s0:s0 + batch]
        x, y, z = snap[..., 0], snap[..., 1], snap[..., 2]
        dx = minimum_image(x[:, :, None] - x[:, None, :], box_length)
        dy = minimum_image(y[:, :, None] - y[:, None, :], box_length)
        dz = minimum_image(z[:, :, None] - z[:, None, :], box_length)
        r = torch.sqrt(dx * dx + dy * dy + dz * dz)
        valid = (r < rmax) & ~eye
        bins = torch.where(valid, (r * inv_dr).to(torch.int64), nbins)
        hist += torch.bincount(bins.reshape(-1), minlength=nbins + 1)

    edges = torch.linspace(0.0, rmax, nbins + 1, dtype=dtype, device=device)
    shell_vol = (4.0 / 3.0) * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rho_eff = n_eff / box_length**3
    norm = snap_idx.shape[0] * n_eff * rho_eff * shell_vol
    return torch.where(norm > 0, hist[:nbins].to(dtype) / norm, 0.0)
