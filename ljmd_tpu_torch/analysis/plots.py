"""Host-side plotting (matplotlib, Agg backend): a copy of
``ljmd_tpu/analysis/plots.py``.

Rebuild of the figure set of ``scripts/md_one_run_analysis.py:601-827``:
time series + rolling means, histograms (T, P, Etot), scatter plots (P-T,
U-K, E-T), ACF overlays and per-observable curves, MSD/VACF/RDF panels.
Plotting stays on the host (SURVEY §7 design mapping) — everything numeric
arrives as plain arrays already computed on device.

matplotlib is imported by the plotting functions, not by this module, so the
analysis layer imports where matplotlib is absent (``require_matplotlib``
names the way round it).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "require_matplotlib",
    "plot_timeseries",
    "plot_histograms",
    "plot_scatters",
    "plot_corr",
    "plot_msd",
    "plot_vacf",
    "plot_rdf",
]

_SERIES_LABELS = ("epot", "ekin", "etot", "temp", "press")


def require_matplotlib():
    """pyplot on the Agg backend; an ImportError naming ``--no-plots`` where
    matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plots need matplotlib, which is not installed: install it, or pass "
            "--no-plots (make_plots=False) to analyze without plots"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_dir, name, paths):
    plt = require_matplotlib()
    p = os.path.join(out_dir, name)
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths.append(p)


def plot_timeseries(out_dir: str, times, series, rolling_frac: float = 0.02) -> list:
    """One PNG per observable: raw series + rolling mean (window = 2% of n,
    the reference's default, md_one_run_analysis.py:638-649)."""
    plt = require_matplotlib()
    times = np.asarray(times)
    series = np.asarray(series)
    paths = []
    n = len(times)
    w = max(1, int(rolling_frac * n))
    kernel = np.ones(w) / w
    for i, name in enumerate(_SERIES_LABELS):
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(times, series[i], lw=0.6, alpha=0.7, label=name)
        if n >= 2 * w > 1:
            roll = np.convolve(series[i], kernel, mode="valid")
            ax.plot(times[w - 1 :], roll, lw=1.5, label=f"rolling mean (w={w})")
        ax.set_xlabel("time")
        ax.set_ylabel(name)
        ax.legend(loc="best", fontsize=8)
        _save(fig, out_dir, f"timeseries_{name}.png", paths)
    return paths


def plot_histograms(out_dir: str, series, bins: int = 60) -> list:
    """Histograms of T, P, Etot (reference set)."""
    plt = require_matplotlib()
    series = np.asarray(series)
    paths = []
    for idx, name in ((3, "temp"), (4, "press"), (2, "etot")):
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.hist(series[idx], bins=bins, alpha=0.8)
        ax.set_xlabel(name)
        ax.set_ylabel("count")
        _save(fig, out_dir, f"hist_{name}.png", paths)
    return paths


def plot_scatters(out_dir: str, series) -> list:
    """P-T, U-K, E-T scatters (reference set)."""
    plt = require_matplotlib()
    series = np.asarray(series)
    pairs = [((3, "T"), (4, "P")), ((0, "U"), (1, "K")), ((3, "T"), (2, "E"))]
    paths = []
    for (xi, xl), (yi, yl) in pairs:
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.scatter(series[xi], series[yi], s=3, alpha=0.4)
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        _save(fig, out_dir, f"scatter_{yl}_{xl}.png", paths)
    return paths


def plot_corr(out_dir: str, corr_norm, corr_mean_norm=None, dt_sample: float = 1.0) -> list:
    """Overlay of all normalized ACFs + per-observable curves (with the
    block-averaged curve when available)."""
    plt = require_matplotlib()
    corr_norm = np.asarray(corr_norm)
    lags = np.arange(corr_norm.shape[1]) * dt_sample
    paths = []
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for i, name in enumerate(_SERIES_LABELS):
        ax.plot(lags, corr_norm[i], lw=1.0, label=name)
    ax.axhline(1 / np.e, color="k", ls=":", lw=0.8, label="1/e")
    ax.set_xlabel("lag time")
    ax.set_ylabel("C(lag)/C(0)")
    ax.legend(fontsize=8)
    _save(fig, out_dir, "corr_overlay.png", paths)

    for i, name in enumerate(_SERIES_LABELS):
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(lags, corr_norm[i], lw=1.0, label="full series")
        if corr_mean_norm is not None:
            ax.plot(lags, np.asarray(corr_mean_norm)[i], lw=1.0, ls="--", label="block mean")
        ax.axhline(0, color="k", lw=0.5)
        ax.set_xlabel("lag time")
        ax.set_ylabel(f"ACF {name}")
        ax.legend(fontsize=8)
        _save(fig, out_dir, f"corr_{name}.png", paths)
    return paths


def plot_msd(out_dir: str, t, msd, d_einstein=None, fit_frac: float = 0.5) -> list:
    plt = require_matplotlib()
    t = np.asarray(t)
    msd = np.asarray(msd)
    paths = []
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(t, msd, lw=1.2, label="MSD")
    if d_einstein is not None and np.isfinite(d_einstein):
        i0 = int((1 - fit_frac) * len(t))
        ax.plot(t[i0:], 6 * d_einstein * (t[i0:] - t[i0]) + msd[i0], "--",
                label=f"6Dt fit, D={d_einstein:.4g}")
    ax.set_xlabel("tau")
    ax.set_ylabel("MSD")
    ax.legend(fontsize=8)
    _save(fig, out_dir, "msd.png", paths)
    return paths


def plot_vacf(out_dir: str, t, vacf, d_gk=None) -> list:
    plt = require_matplotlib()
    t = np.asarray(t)
    vacf = np.asarray(vacf)
    paths = []
    fig, ax = plt.subplots(figsize=(6, 4))
    label = "VACF" if d_gk is None else f"VACF (D_GK={d_gk:.4g})"
    ax.plot(t, vacf, lw=1.2, label=label)
    ax.axhline(0, color="k", lw=0.5)
    ax.set_xlabel("tau")
    ax.set_ylabel("<v(0)·v(tau)>")
    ax.legend(fontsize=8)
    _save(fig, out_dir, "vacf.png", paths)
    return paths


def plot_rdf(out_dir: str, r_centers, g) -> list:
    plt = require_matplotlib()
    paths = []
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.asarray(r_centers), np.asarray(g), lw=1.2)
    ax.axhline(1.0, color="k", ls=":", lw=0.8)
    ax.set_xlabel("r")
    ax.set_ylabel("g(r)")
    _save(fig, out_dir, "rdf.png", paths)
    return paths
