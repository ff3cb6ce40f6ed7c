"""The port's analysis layer (``ljmd_tpu_torch/analysis``) against the JAX
package's on the same seeded numpy inputs, float64, at
tests/test_analysis.py's tolerances; and ``analyze_run`` of both packages
on one run directory written by the port's CPU ``simulate``."""

import json
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.analysis import diffusion as jdiff
from ljmd_tpu.analysis import msd_vacf as jmv
from ljmd_tpu.analysis import rdf as jrdf
from ljmd_tpu.analysis.report import analyze_run as j_analyze_run
from ljmd_tpu_torch.analysis import diffusion as pdiff
from ljmd_tpu_torch.analysis import msd_vacf as pmv
from ljmd_tpu_torch.analysis import rdf as prdf
from ljmd_tpu_torch.analysis.report import analyze_run as p_analyze_run

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _walk(n_snap=41, n=24, seed=0):
    """A random walk (unwrapped positions) and random velocities."""
    rng = np.random.default_rng(seed)
    ru = np.cumsum(rng.normal(scale=0.1, size=(n_snap, n, 3)), axis=0)
    v = rng.normal(size=(n_snap, n, 3))
    return ru, v


@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("max_lag", [None, 12])
def test_msd_vacf_match_jax(stride, max_lag):
    ru, v = _walk()
    kw = dict(max_lag=max_lag, origin_stride=stride)
    np.testing.assert_allclose(pmv.compute_msd(_t(ru), **kw).numpy(),
                               np.asarray(jmv.compute_msd(jnp.asarray(ru), **kw)), rtol=1e-12)
    np.testing.assert_allclose(pmv.compute_vacf(_t(v), **kw).numpy(),
                               np.asarray(jmv.compute_vacf(jnp.asarray(v), **kw)), rtol=1e-12)


def test_msd_vacf_batches_and_edge_cases(monkeypatch):
    """One origin a batch gives the one-batch result; a single snapshot
    gives JAX's special cases; a max_lag past the run is clipped."""
    ru, v = _walk(n_snap=17, seed=1)
    whole = pmv.compute_msd(_t(ru), origin_stride=2)
    monkeypatch.setattr(pmv, "_BATCH_BYTES", 1)
    np.testing.assert_allclose(pmv.compute_msd(_t(ru), origin_stride=2).numpy(), whole.numpy(),
                               rtol=1e-13)
    np.testing.assert_allclose(pmv.compute_vacf(_t(v), max_lag=100).numpy(),
                               np.asarray(jmv.compute_vacf(jnp.asarray(v), max_lag=100)),
                               rtol=1e-12)
    one = v[:1]
    np.testing.assert_allclose(pmv.compute_vacf(_t(one)).numpy(),
                               np.asarray(jmv.compute_vacf(jnp.asarray(one))), rtol=1e-12)
    assert pmv.compute_msd(_t(ru[:1])).tolist() == [0.0]
    for n in (1, 5000, 5001, 20000, 20001):
        assert pmv.default_origin_stride(n) == jmv.default_origin_stride(n)


@pytest.mark.parametrize("caps", [(200, 800), (3, 17)])
def test_rdf_matches_jax(caps):
    """Every snapshot and particle, and subsampled to 3 snapshots of 17
    particles (the reference's evenly spaced pick)."""
    rng = np.random.default_rng(2)
    L = 5.0
    r = rng.uniform(0.0, L, size=(6, 40, 3))
    kw = dict(nbins=50, max_snapshots=caps[0], max_particles=caps[1])
    got = prdf.compute_rdf(_t(r), L, **kw).numpy()
    want = np.asarray(jrdf.compute_rdf(jnp.asarray(r), L, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert got.sum() > 0
    np.testing.assert_array_equal(prdf.rdf_bin_centers(L, 50), jrdf.rdf_bin_centers(L, 50))
    np.testing.assert_array_equal(prdf._subsample_indices(100, 7),
                                  jrdf._subsample_indices(100, 7))


def test_rdf_batches_and_refusal(monkeypatch):
    rng = np.random.default_rng(3)
    r = _t(rng.uniform(0.0, 4.0, size=(5, 30, 3)))
    whole = prdf.compute_rdf(r, 4.0, nbins=40)
    monkeypatch.setattr(prdf, "_BATCH_BYTES", 1)
    assert torch.equal(prdf.compute_rdf(r, 4.0, nbins=40), whole)
    with pytest.raises(ValueError, match="not enough particles"):
        prdf.compute_rdf(r[:, :1], 4.0)


def _same(a, b, rtol):
    a, b = float(a), float(b)
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= rtol * max(abs(b), 1e-300)


@pytest.mark.parametrize("fit_frac", [0.5, 0.01, 2.0])
def test_diffusion_matches_jax(fit_frac):
    """Einstein and Green-Kubo, fractions clamped on both sides, and the
    under-10 / under-2 point guards."""
    rng = np.random.default_rng(4)
    t = np.linspace(0.0, 3.0, 40)
    msd = 6 * 0.3 * t + rng.normal(scale=0.01, size=t.shape)
    vacf = np.exp(-t / 0.4) * (1 + rng.normal(scale=0.01, size=t.shape))
    assert _same(pdiff.diffusion_einstein(_t(t), _t(msd), fit_frac),
                 jdiff.diffusion_einstein(jnp.asarray(t), jnp.asarray(msd), fit_frac), 1e-10)
    assert _same(pdiff.diffusion_green_kubo(_t(t), _t(vacf), fit_frac),
                 jdiff.diffusion_green_kubo(jnp.asarray(t), jnp.asarray(vacf), fit_frac), 1e-10)
    assert math.isnan(float(pdiff.diffusion_einstein(_t(t[:9]), _t(msd[:9]))))
    assert math.isnan(float(pdiff.diffusion_green_kubo(_t(t[:1]), _t(vacf[:1]))))


@pytest.mark.parametrize("case", ["decay", "negative_tail", "no_crossing", "flat_step", "short"])
def test_acf_timescales_match_jax(case):
    """tau_int (with and without max_lag: the positivity gate) and tau_1e
    (interpolation, the y1 == y0 branch, NaN without a crossing)."""
    lags = np.arange(30)
    cn = {"decay": np.exp(-lags / 4.0),
          "negative_tail": np.cos(lags / 5.0) * np.exp(-lags / 30.0),
          "no_crossing": 1.0 - 0.001 * lags,
          "flat_step": np.where(lags < 3, 1.0, 1.0 / np.e),
          "short": np.array([1.0])}[case]
    for ml in (None, 7):
        assert _same(pdiff.tau_int(_t(cn), 0.25, ml), jdiff.tau_int(jnp.asarray(cn), 0.25, ml),
                     1e-10)
    assert _same(pdiff.tau_1e(_t(cn), 0.25), jdiff.tau_1e(jnp.asarray(cn), 0.25), 1e-10)
    if case == "no_crossing":
        assert math.isnan(float(pdiff.tau_1e(_t(cn), 0.25)))


def _close_dicts(got, want, path=""):
    assert type(got) is type(want) or isinstance(got, (int, float)), path
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _close_dicts(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float):
        assert _same(got, want, 1e-10), (path, got, want)
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory written by the port's CLI on the CPU, with frames."""
    d = tmp_path_factory.mktemp("analysis_run")
    cfg = d / "cfg.json"
    cfg.write_text(json.dumps({
        "num_cells": 2, "box_length": 3.8, "rc_over_box": 0.45, "total_steps": 330,
        "output_interval": 10, "warmup_steps": 30, "dt": 0.002, "dtype": "float64",
        "target_total_energy": -60.0}))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "ljmd_tpu_torch", "simulate", "--config",
                           str(cfg), "--out-dir", str(d / "run"), "--device", "cpu"],
                          cwd=str(d), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return str(d / "run")


def test_analyze_run_matches_jax(run_dir):
    """Both packages' analyze_run on one run directory: the summaries agree
    to 1e-10 and the plot files are the same list."""
    want = j_analyze_run(run_dir, make_plots=True)
    got = p_analyze_run(run_dir, make_plots=True, device="cpu")
    assert got["trajectory"]["n_snapshots"] == 30
    assert got["plots"] == want["plots"] and len(got["plots"]) == 20
    _close_dicts(got, want)
    with open(os.path.join(run_dir, "analysis_summary.json")) as f:
        _close_dicts(json.load(f), want)


def test_analyze_run_options_match_jax(run_dir, tmp_path):
    kw = dict(msd_fit_frac=0.3, vacf_tmax_frac=0.6, rva_max_lag=11, origin_stride=2,
              make_plots=False)
    _close_dicts(p_analyze_run(run_dir, device="cpu", **kw), j_analyze_run(run_dir, **kw))
    skip = p_analyze_run(run_dir, skip_rva=True, make_plots=False, device="cpu")
    assert "trajectory" not in skip and "acf" in skip


def test_analyze_run_refuses_cuda_without_a_card(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        p_analyze_run(run_dir, make_plots=False)


def test_plots_without_matplotlib_name_no_plots(run_dir):
    """Where matplotlib is missing: report.py imports, make_plots=False
    runs, and make_plots=True raises an ImportError naming --no-plots before
    any computation (subprocess with matplotlib hidden)."""
    code = (
        "import sys, os\n"
        "sys.modules['matplotlib'] = None\n"
        "from ljmd_tpu_torch.analysis.report import analyze_run\n"
        f"d = {run_dir!r}\n"
        "os.remove(os.path.join(d, 'analysis_summary.json'))\n"
        "try:\n"
        "    analyze_run(d, device='cpu')\n"
        "except ImportError as e:\n"
        "    assert '--no-plots' in str(e), e\n"
        "    assert not os.path.exists(os.path.join(d, 'analysis_summary.json'))\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
        "s = analyze_run(d, device='cpu', make_plots=False)\n"
        "assert 'plots' not in s and 'trajectory' in s\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
