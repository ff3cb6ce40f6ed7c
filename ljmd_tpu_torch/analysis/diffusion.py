"""Diffusion-coefficient estimators and ACF timescales (counterpart of
``ljmd_tpu/analysis/diffusion.py``; rebuild of
``scripts/md_one_run_analysis.py``):

- Einstein route (:492-513): least-squares slope of the MSD tail (last
  ``fit_frac`` of the points, clamped like the reference), D = slope / 6.
- Green-Kubo route (:516-534): D = (1/3) * trapezoid(VACF) up to
  ``tmax_frac`` of the time range.
- tau_int (:209-223): dt * (1 + 2 * sum cn[l]) truncated at the first
  non-positive cn.
- tau_1e (:226-239): first crossing of cn below 1/e with linear
  interpolation; NaN if it never crosses.

Plain tensor functions on the inputs' device, returning 0-d tensors; the
truncated sum and the first crossing are cumulative masks, not Python loops.
"""

from __future__ import annotations

import math

import torch

__all__ = ["diffusion_einstein", "diffusion_green_kubo", "tau_int", "tau_1e"]


def _nan_like(t: torch.Tensor) -> torch.Tensor:
    return torch.full((), math.nan, dtype=t.dtype, device=t.device)


def diffusion_einstein(t: torch.Tensor, msd: torch.Tensor, fit_frac: float = 0.5) -> torch.Tensor:
    """D from the linear tail fit of MSD(t): slope/6. NaN for fewer than 10
    points (reference guard)."""
    n = t.shape[0]
    if n < 10:
        return _nan_like(t)
    fit_frac = max(0.05, min(float(fit_frac), 1.0))
    i0 = int((1.0 - fit_frac) * n)
    i0 = max(0, min(i0, n - 5))
    x = t[i0:]
    y = msd[i0:]
    xm = torch.mean(x)
    ym = torch.mean(y)
    slope = torch.sum((x - xm) * (y - ym)) / torch.sum((x - xm) ** 2)
    return slope / 6.0


def diffusion_green_kubo(t: torch.Tensor, vacf: torch.Tensor,
                         tmax_frac: float = 1.0) -> torch.Tensor:
    """D = (1/3) * integral of VACF (trapezoid) up to tmax_frac of the
    range."""
    n = t.shape[0]
    if n < 2:
        return _nan_like(t)
    tmax_frac = max(0.05, min(float(tmax_frac), 1.0))
    imax = int(tmax_frac * (n - 1))
    imax = max(1, min(imax, n - 1))
    tt = t[: imax + 1]
    vv = vacf[: imax + 1]
    integral = torch.sum(0.5 * (vv[1:] + vv[:-1]) * (tt[1:] - tt[:-1]))
    return integral / 3.0


def tau_int(cn: torch.Tensor, dt_sample: float, max_lag: int | None = None) -> torch.Tensor:
    """Integrated autocorrelation time: dt*(1 + 2*sum cn[1..L*]) where the
    sum stops at the first non-positive cn (a cumulative positivity gate)."""
    n = cn.shape[0]
    if n < 2:
        return _nan_like(cn)
    L = n - 1 if max_lag is None else min(int(max_lag), n - 1)
    tail = cn[1 : L + 1]
    gate = torch.cumprod((tail > 0).to(cn.dtype), dim=0)
    return dt_sample * (1.0 + 2.0 * torch.sum(tail * gate))


def tau_1e(cn: torch.Tensor, dt_sample: float) -> torch.Tensor:
    """Time of the first crossing of cn below 1/e (linear interpolation
    between the bracketing lags); NaN when cn never crosses."""
    n = cn.shape[0]
    if n < 2:
        return _nan_like(cn)
    target = 1.0 / math.e
    below = cn[1:] <= target  # lags 1..n-1
    any_cross = torch.any(below)
    i = torch.argmax(below.to(torch.int32)) + 1  # first crossing lag
    y0 = cn[i - 1]
    y1 = cn[i]
    x0 = (i - 1).to(cn.dtype) * dt_sample
    x1 = i.to(cn.dtype) * dt_sample
    flat = y1 == y0
    one = torch.ones((), dtype=cn.dtype, device=cn.device)
    frac = torch.where(flat, one, (target - y0) / torch.where(flat, one, y1 - y0))
    t_cross = x0 + frac * (x1 - x0)
    t_cross = torch.where(flat, x1, t_cross)
    return torch.where(any_cross, t_cross, _nan_like(cn))
