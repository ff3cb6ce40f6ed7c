"""Run-directory analysis (counterpart of ``ljmd_tpu/analysis/report.py``;
the rebuild of ``scripts/md_one_run_analysis.py`` ``main()``, :849-1012).

Reads a run directory (written by ``write_run_artifacts`` and the streaming
driver of either package, or by the Fortran reference: the formats are the
same), computes the trajectory observables (MSD, VACF, RDF, Einstein and
Green-Kubo diffusion) on ``device`` in float64 and the ACF timescales
(tau_int, tau_1e per observable), optionally renders the PNG set, and writes
``analysis_summary.json`` + ``analysis_summary.txt``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ljmd_tpu_torch.analysis.diffusion import (
    diffusion_einstein,
    diffusion_green_kubo,
    tau_1e,
    tau_int,
)
from ljmd_tpu_torch.analysis.msd_vacf import compute_msd, compute_vacf, default_origin_stride
from ljmd_tpu_torch.analysis.rdf import compute_rdf, rdf_bin_centers
from ljmd_tpu_torch.io.artifacts import parse_final_results, read_instantaneous_series
from ljmd_tpu_torch.models.forces import resolve_device

__all__ = ["analyze_run"]

_SERIES_LABELS = ("epot", "ekin", "etot", "temp", "press")


def analyze_run(
    run_dir: str,
    skip_rva: bool = False,
    msd_fit_frac: float = 0.5,
    vacf_tmax_frac: float = 1.0,
    rva_max_lag: Optional[int] = None,
    origin_stride: Optional[int] = None,
    make_plots: bool = True,
    plots_dir: Optional[str] = None,
    device="cuda",
) -> dict:
    """Analyze one run directory on ``device`` (default the card; raises
    where there is none, ``device="cpu"`` runs on the host). Returns the
    summary dict (also written to analysis_summary.json/.txt in the run
    directory). The flags mirror the reference parser
    (md_one_run_analysis.py:850-891). With ``make_plots`` and no matplotlib
    it raises ImportError before computing anything."""
    device = resolve_device(device)
    if make_plots:
        from ljmd_tpu_torch.analysis.plots import require_matplotlib

        require_matplotlib()
    wide = torch.float64
    summary: dict = {"run_dir": os.path.abspath(run_dir)}
    plots_dir = plots_dir or os.path.join(run_dir, "plots")
    written: list = []

    # ---- instantaneous series -------------------------------------------
    series_path = os.path.join(run_dir, "instantaneous_energies.dat")
    times = series = None
    if os.path.exists(series_path):
        times, series = read_instantaneous_series(series_path)
        dt_sample = float(np.median(np.diff(times))) if len(times) > 1 else 1.0
        summary["n_samples"] = int(len(times))
        summary["dt_sample"] = dt_sample
        summary["series_means"] = {
            k: float(series[i].mean()) for i, k in enumerate(_SERIES_LABELS)
        }
        summary["series_stds"] = {
            k: float(series[i].std()) for i, k in enumerate(_SERIES_LABELS)
        }
    else:
        dt_sample = 1.0

    # ---- ACF timescales from corr files ---------------------------------
    acf = {}
    for obs in _SERIES_LABELS:
        p = os.path.join(run_dir, f"corr_{obs}.dat")
        if not os.path.exists(p):
            continue
        arr = np.atleast_2d(np.loadtxt(p))
        cn = torch.as_tensor(arr[:, 2], dtype=wide, device=device)
        acf[obs] = {
            "tau_int": float(tau_int(cn, dt_sample)),
            "tau_1e": float(tau_1e(cn, dt_sample)),
        }
    if acf:
        summary["acf"] = acf

    # ---- final-results block --------------------------------------------
    parsed = parse_final_results(os.path.join(run_dir, "md_final_results.txt"))
    if parsed:
        summary["final_results"] = parsed

    # ---- trajectory observables (rva) ------------------------------------
    msd = vacf = rdf = None
    tau_axis = None
    if not skip_rva and os.path.exists(os.path.join(run_dir, "rva.dat")):
        from ljmd_tpu_torch.utils.native import read_rva_native

        data = read_rva_native(os.path.join(run_dir, "rva.dat"))
        n_snap = data.n_snapshots
        max_lag = rva_max_lag if rva_max_lag is not None else min(n_snap - 1, 3000)
        stride = origin_stride if origin_stride is not None else default_origin_stride(n_snap)
        dt_frame = data.dt * data.output_interval

        ru = torch.as_tensor(data.ru, dtype=wide, device=device)
        v = torch.as_tensor(data.v, dtype=wide, device=device)
        r = torch.as_tensor(data.r, dtype=wide, device=device)

        msd_t = compute_msd(ru, max_lag=max_lag, origin_stride=stride)
        vacf_t = compute_vacf(v, max_lag=max_lag, origin_stride=stride)
        tau_t = torch.arange(msd_t.shape[0], dtype=wide, device=device) * dt_frame
        d_e = float(diffusion_einstein(tau_t, msd_t, msd_fit_frac))
        d_gk = float(diffusion_green_kubo(tau_t, vacf_t, vacf_tmax_frac))
        msd = msd_t.cpu().numpy()
        vacf = vacf_t.cpu().numpy()
        tau_axis = np.arange(len(msd)) * dt_frame
        g = compute_rdf(r, data.box_length).cpu().numpy()
        centers = rdf_bin_centers(data.box_length)
        rdf = (centers, g)

        summary["trajectory"] = {
            "n_snapshots": int(n_snap),
            "max_lag": int(max_lag),
            "origin_stride": int(stride),
            "D_einstein": d_e,
            "D_green_kubo": d_gk,
            "msd_fit_frac": msd_fit_frac,
            "vacf_tmax_frac": vacf_tmax_frac,
        }

    # ---- plots ------------------------------------------------------------
    if make_plots:
        os.makedirs(plots_dir, exist_ok=True)
        from ljmd_tpu_torch.analysis import plots as P

        if series is not None:
            written += P.plot_timeseries(plots_dir, times, series)
            written += P.plot_histograms(plots_dir, series)
            written += P.plot_scatters(plots_dir, series)
        corr_files = [os.path.join(run_dir, f"corr_{o}.dat") for o in _SERIES_LABELS]
        if all(os.path.exists(p) for p in corr_files):
            corr_norm = np.stack([np.atleast_2d(np.loadtxt(p))[:, 2] for p in corr_files])
            cm_files = [os.path.join(run_dir, f"corrmean_{o}.dat") for o in _SERIES_LABELS]
            cm = (
                np.stack([np.atleast_2d(np.loadtxt(p))[:, 2] for p in cm_files])
                if all(os.path.exists(p) for p in cm_files)
                else None
            )
            written += P.plot_corr(plots_dir, corr_norm, cm, dt_sample)
        if msd is not None:
            written += P.plot_msd(plots_dir, tau_axis, msd,
                                  summary["trajectory"]["D_einstein"], msd_fit_frac)
            written += P.plot_vacf(plots_dir, tau_axis, vacf,
                                   summary["trajectory"]["D_green_kubo"])
        if rdf is not None:
            written += P.plot_rdf(plots_dir, rdf[0], rdf[1])
        summary["plots"] = written

    # ---- summary artifacts --------------------------------------------------
    with open(os.path.join(run_dir, "analysis_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    with open(os.path.join(run_dir, "analysis_summary.txt"), "w") as f:
        for k, v in summary.items():
            f.write(f"{k}: {v}\n")
    return summary
