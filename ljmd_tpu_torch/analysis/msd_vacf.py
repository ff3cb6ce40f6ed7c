"""Time-origin-averaged MSD and VACF on the frames' device (counterpart of
``ljmd_tpu/analysis/msd_vacf.py``; rebuild of the reference's
post-processing loops, ``scripts/md_one_run_analysis.py:404-489``):

  MSD(tau)  = < |ru(t0+tau) - ru(t0)|^2 >_{particles, origins}
  VACF(tau) = < v(t0+tau) . v(t0) >_{particles, origins}

with origins t0 = 0, stride, 2*stride, ... < n_snap-1, per-lag origin counts
(origins whose window is clipped by the end of the trajectory contribute only
their valid lags), and the per-origin average taken over particles first:
the JAX package's estimator, normalization choices included.

The JAX ``lax.scan`` over origins becomes a loop over batches of origins.
Each batch's windows are one strided view, (B, max_lag+1, N, 3), into a
zero-padded (n_snap+max_lag, N, 3) copy of the frames: no window is copied,
and the batch is sized so its (B, max_lag+1, N, 3) difference or product
stays under ``_BATCH_BYTES``.
"""

from __future__ import annotations

import torch

__all__ = ["compute_msd", "compute_vacf", "default_origin_stride"]

# Bytes of the (B, window, N, 3) temporary of one batch of origins.
_BATCH_BYTES = 1 << 28


def _origin_average(frames: torch.Tensor, max_lag: int, origin_stride: int,
                    kind: str) -> torch.Tensor:
    """Shared origin averaging. frames: (n_snap, N, 3), unwrapped positions
    (msd) or velocities (vacf). Returns (max_lag+1,) in frames.dtype with
    per-lag count normalization."""
    n_snap = frames.shape[0]
    dtype, device = frames.dtype, frames.device
    if n_snap < 2:
        if kind == "msd":
            return torch.zeros((1,), dtype=dtype, device=device)
        return torch.mean(torch.sum(frames[0] * frames[0], dim=-1))[None]

    max_lag = int(min(max_lag, n_snap - 1))
    origin_stride = max(1, int(origin_stride))
    origins = torch.arange(0, n_snap - 1, origin_stride, device=device)
    window = max_lag + 1
    padded = torch.zeros((n_snap + max_lag,) + tuple(frames.shape[1:]), dtype=dtype,
                         device=device)
    padded[:n_snap] = frames
    s0, s1, s2 = padded.stride()
    lags = torch.arange(window, device=device)
    per_origin = window * frames[0].numel() * frames.element_size()
    batch = max(1, _BATCH_BYTES // per_origin)

    acc = torch.zeros((window,), dtype=dtype, device=device)
    counts = torch.zeros((window,), dtype=dtype, device=device)
    for b0 in range(0, origins.shape[0], batch):
        t0s = origins[b0:b0 + batch]
        nb = t0s.shape[0]
        first = b0 * origin_stride
        w = padded.as_strided((nb, window) + tuple(frames.shape[1:]),
                              (origin_stride * s0, s0, s1, s2), first * s0)
        ref = frames[first: first + (nb - 1) * origin_stride + 1: origin_stride]
        if kind == "msd":
            d = w - ref[:, None]
            per_lag = torch.mean(torch.sum(d * d, dim=-1), dim=-1)  # (nb, window)
        else:
            per_lag = torch.mean(torch.sum(w * ref[:, None], dim=-1), dim=-1)
        valid = lags[None, :] <= (n_snap - 1 - t0s)[:, None]
        acc = acc + torch.sum(torch.where(valid, per_lag, 0.0), dim=0)
        counts = counts + torch.sum(valid.to(dtype), dim=0)
    return torch.where(counts > 0, acc / torch.clamp(counts, min=1), 0.0)


def compute_msd(ru_frames: torch.Tensor, max_lag: int | None = None,
                origin_stride: int = 1) -> torch.Tensor:
    """MSD(tau) from unwrapped positions (n_snap, N, 3) -> (max_lag+1,)."""
    if max_lag is None:
        max_lag = ru_frames.shape[0] - 1
    return _origin_average(ru_frames, max_lag, origin_stride, "msd")


def compute_vacf(v_frames: torch.Tensor, max_lag: int | None = None,
                 origin_stride: int = 1) -> torch.Tensor:
    """VACF(tau) from velocities (n_snap, N, 3) -> (max_lag+1,)."""
    if max_lag is None:
        max_lag = v_frames.shape[0] - 1
    return _origin_average(v_frames, max_lag, origin_stride, "vacf")


def default_origin_stride(n_snap: int) -> int:
    """The reference's heuristic (md_one_run_analysis.py:762-769):
    1 / 5 / 20 for n_snap <= 5000 / <= 20000 / larger."""
    if n_snap <= 5000:
        return 1
    if n_snap <= 20000:
        return 5
    return 20
