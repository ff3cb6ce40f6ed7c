"""Autocorrelations (counterpart of ``ljmd_tpu/stats/correlations.py``;
rebuild of ``scripts/stats/stats_math.f90`` and the block machinery of
``scripts/stats/md_correlations.f90``).

- ``autocorr``: C(L) = (1/(n-L)) sum_{k=0}^{n-1-L} A(k) A(k+L), L = 0..max_lag
  (stats_math.f90:85-103); ``centered`` subtracts the series mean first.
- ``normalize_corr``: C(L)/C(0) with a zero-C(0) guard (stats_math.f90:168-190).
- ``block_corr_means``: split into ``n_blocks`` equal contiguous blocks
  (remainder dropped), per-block ACF and normalized ACF, averaged over blocks
  (md_correlations.f90:668-803).

Every function takes a batch of series along the leading dims; the lag sweep
is one batched product over an unfolded (max_lag+1, n) window view, in place
of the JAX package's ``vmap``. That product holds (max_lag+1) x n values a
series, so an ensemble's correlation stage runs over groups of replicas
(``grouped``, ``corr_group_size``): at most ``CORR_GROUP_BYTES`` of lag
products at once, each replica's result the same as in one batched call.
"""

from __future__ import annotations

import torch

__all__ = ["CORR_GROUP_BYTES", "autocorr", "normalize_corr", "block_corr_means", "autocorr_all",
           "corr_group_size", "grouped"]

# The lag products an ensemble's correlation stage holds at once, at most.
CORR_GROUP_BYTES = 64 << 20


def autocorr(series: torch.Tensor, max_lag: int, centered: bool = False) -> torch.Tensor:
    """(..., max_lag+1) autocorrelations of (..., n) series; max_lag < n."""
    n = series.shape[-1]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < series length {n}")
    if centered:
        series = series - torch.mean(series, dim=-1, keepdim=True)
    pad = torch.zeros(series.shape[:-1] + (max_lag,), dtype=series.dtype,
                      device=series.device)
    padded = torch.cat([series, pad], dim=-1)
    # windows[..., L, k] = padded[..., k + L]; zero padding makes products
    # beyond n-1-L vanish.
    windows = padded.unfold(-1, n, 1)
    lags = torch.arange(max_lag + 1, device=series.device)
    sums = torch.sum(series.unsqueeze(-2) * windows, dim=-1)
    return sums / (n - lags).to(series.dtype)


def normalize_corr(corr: torch.Tensor) -> torch.Tensor:
    """C(L)/C(0); zeros when |C(0)| is vanishingly small."""
    c0 = corr[..., :1]
    tiny = torch.abs(c0) < 1e-300
    safe = torch.where(tiny, torch.ones_like(c0), c0)
    return torch.where(tiny, torch.zeros_like(corr), corr / safe)


def autocorr_all(series_matrix: torch.Tensor, max_lag: int, centered: bool = True):
    """ACF + normalized ACF of a stack of observables: (n_obs, n) ->
    ((n_obs, max_lag+1), (n_obs, max_lag+1)) (md_correlations.f90:321-382)."""
    corr = autocorr(series_matrix, max_lag, centered=centered)
    return corr, normalize_corr(corr)


def block_corr_means(series: torch.Tensor, n_blocks: int, max_lag: int,
                     centered: bool = True):
    """Block-averaged (mean_corr, mean_corrn), each (..., max_lag+1);
    block_len = n // n_blocks (md_correlations.f90:692), max_lag < block_len."""
    n = series.shape[-1]
    if n_blocks <= 0:
        raise ValueError("n_blocks must be >= 1")
    block_len = n // n_blocks
    if block_len <= 0:
        raise ValueError("block_len <= 0 (too many blocks)")
    if max_lag >= block_len:
        raise ValueError("max_lag must be < block_len")
    blocks = series[..., : n_blocks * block_len].reshape(
        series.shape[:-1] + (n_blocks, block_len))
    corr_b = autocorr(blocks, max_lag, centered=centered)
    corrn_b = normalize_corr(corr_b)
    return torch.mean(corr_b, dim=-2), torch.mean(corrn_b, dim=-2)


def corr_group_size(replicas: int, n_samples: int, max_lag: int, itemsize: int,
                    budget: int = CORR_GROUP_BYTES) -> int:
    """Replicas a group of the correlation stage: as many as keep their lag
    products, 5 x (max_lag+1) x n_samples values of ``itemsize`` bytes a
    replica, within ``budget`` bytes (at least 1, at most ``replicas``)."""
    per = 5 * (max_lag + 1) * max(n_samples, 1) * itemsize
    return max(1, min(replicas, budget // per))


def grouped(fn, series, group: int):
    """``fn`` over the leading (replica) axis of ``series`` (a tensor or a
    host array) ``group`` replicas at a time, its outputs (a tuple of
    tensors) concatenated along that axis."""
    outs = [fn(series[g:g + group]) for g in range(0, series.shape[0], group)]
    return tuple(torch.cat(parts) for parts in zip(*outs))
