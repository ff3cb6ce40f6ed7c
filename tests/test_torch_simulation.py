"""PyTorch port drivers and statistics (``ljmd_tpu_torch/models/simulation.py``,
``ljmd_tpu_torch/stats``) against the JAX package and the golden driver
fixture, float64 on the CPU. The JAX side runs its rows engine
(``backend="pallas"``, Pallas in interpret mode off the TPU)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models import simulation as jsim
from ljmd_tpu.state import StepObs as JStepObs
from ljmd_tpu.stats import correlations as jcorr
from ljmd_tpu.stats import moments as jmom
from ljmd_tpu.stats import thermo as jthermo
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.models.lattice import fcc_lattice, remove_com_velocity
from ljmd_tpu_torch.state import MDState, StepObs
from ljmd_tpu_torch.stats import correlations as pcorr
from ljmd_tpu_torch.stats import moments as pmom
from ljmd_tpu_torch.stats import thermo as pthermo
from ljmd_tpu_torch.utils import convert
from ljmd_tpu_torch.utils.ran3 import reference_initial_velocities

# Small tensors: one intra-op thread per test worker (the suite runs in
# several worker processes at once).
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


@pytest.mark.parametrize("total,interval,warmup", [
    (200, 20, 100), (200, 20, 130), (215, 20, 130), (90, 100, 85), (75, 10, 13), (1, 1, 0),
])
def test_sample_steps_and_cadence_match_jax(total, interval, warmup):
    kw = dict(num_cells=2, box_length=4.0, rc_over_box=0.45, total_steps=total,
              output_interval=interval, warmup_steps=warmup)
    jcfg = config_from_density(num_cells=2, density=0.5).replace(**kw)
    pcfg = SimConfig(**kw)
    np.testing.assert_array_equal(psim.sample_steps(pcfg), jsim.sample_steps(jcfg))
    assert psim._cadence(pcfg) == jsim._cadence(jcfg)
    assert len(psim.sample_steps(pcfg)) == pcfg.n_samples


def test_initialize_ran3_matches_jax():
    """Full init pipeline (lattice, ran3 velocities, COM removal, rescale,
    40 fused warmup steps) through both packages' rows engines."""
    jcfg = config_from_density(num_cells=3, density=0.7, dt=0.003, dtype="float64",
                               total_steps=10, warmup_steps=40, target_total_energy=-500.0,
                               seed=-12345)
    want = jsim.initialize(jcfg, backend="pallas", velocity_init="ran3")
    got = psim.initialize(_port_cfg(jcfg), backend="rows", velocity_init="ran3", device="cpu")
    for k in ("r", "ru", "v", "a"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-9, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("k", [2, 3])
def test_initialize_ran3_matches_golden(k):
    with open(os.path.join(GOLDEN_DIR, f"golden_k{k}.json")) as f:
        g = json.load(f)
    cfg = SimConfig(num_cells=g["num_cells"], box_length=g["box_length"],
                    rc_over_box=g["rc_over_box"], dt=g["dt"], total_steps=10,
                    output_interval=1, warmup_steps=0,
                    target_total_energy=g["target_total_energy"], dtype="float64", seed=-12345)
    state = psim.initialize(cfg, backend="dense", velocity_init="ran3", device="cpu")
    gl = g["lattice"]
    np.testing.assert_array_equal(state.r.numpy(),
                                  fcc_lattice(cfg.num_cells, cfg.box_length, torch.float64).numpy())
    v = state.v.numpy()
    np.testing.assert_allclose(v[:3], np.asarray(gl["v_first3"]), rtol=1e-12, atol=1e-12)
    assert abs(float(np.sum(np.abs(v))) - gl["v_abs_sum"]) < 1e-9
    assert abs(0.5 * float(np.sum(v * v)) - gl["ekin_after_rescale"]) < 1e-9


def test_run_production_matches_jax_with_offset_warmup():
    """run_production with warmup % interval != 0 (prologue 10 steps past a
    13-step warmup, 6 sample cycles, 5-step epilogue), frames recorded:
    series, means, stds, correlations, thermo and frames against JAX."""
    jcfg = config_from_density(num_cells=3, density=0.7, dt=0.003, dtype="float64",
                               total_steps=75, output_interval=10, warmup_steps=13,
                               target_total_energy=-500.0, corr_max_lag_cap=2,
                               corr_max_blocks=2)
    jstate = jsim.initialize(jcfg, backend="dense")
    want = jsim.run_production(jcfg, jstate, backend="pallas", record_frames=True)
    pstate = convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in convert.STATE_FIELDS})
    pcfg = _port_cfg(jcfg)
    got = psim.run_production(pcfg, pstate, backend="rows", record_frames=True)

    assert got.series.shape == (5, 6)
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    np.testing.assert_allclose(got.series.numpy(), np.asarray(want.series), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got.means.means.numpy(), np.asarray(want.means.means),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.means.stds.numpy(), np.asarray(want.means.stds),
                               rtol=1e-6, atol=1e-9)
    for k in ("corr", "corr_norm", "corr_mean", "corr_mean_norm"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    for k, v in want.thermo(jcfg).as_dict().items():
        assert float(getattr(got.thermo(pcfg), k)) == pytest.approx(float(v), rel=1e-7), k
    for k in convert.STATE_FIELDS:
        np.testing.assert_allclose(getattr(got.frames, k).numpy(),
                                   np.asarray(getattr(want.frames, k)),
                                   rtol=1e-9, atol=1e-9, err_msg=f"frames.{k}")
        np.testing.assert_allclose(getattr(got.final_state, k).numpy(),
                                   np.asarray(getattr(want.final_state, k)),
                                   rtol=1e-9, atol=1e-9, err_msg=f"final_state.{k}")


@pytest.mark.parametrize("backend", ["dense", "rows"])
def test_production_driver_matches_golden_mirror(backend):
    """tests/test_golden_parity.py's driver check through the port: cadence,
    11 streaming means/stds, centered ACF + normalization, block-averaged
    ACF and thermodynamic coefficients against the scalar float64 mirror."""
    with open(os.path.join(GOLDEN_DIR, "golden_driver_k2.json")) as f:
        g = json.load(f)
    cfg = SimConfig(num_cells=g["num_cells"], box_length=g["box_length"],
                    rc_over_box=g["rc_over_box"], dt=g["dt"], total_steps=g["total_steps"],
                    output_interval=g["output_interval"], warmup_steps=g["warmup_steps"],
                    target_total_energy=g["target_total_energy"], dtype="float64",
                    corr_max_lag_cap=g["corr_max_lag"], corr_max_blocks=g["corr_n_blocks"])
    assert cfg.corr_max_lag == g["corr_max_lag"]
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64)
    v = remove_com_velocity(torch.as_tensor(reference_initial_velocities(cfg.n)))
    v = v * np.sqrt(g["ekin_after_rescale"] / (0.5 * float(torch.sum(v * v))))
    out = psim.run_production(cfg, MDState(r=r, ru=r.clone(), v=v, a=torch.zeros_like(r)),
                              backend=backend)

    series = out.series.numpy()
    assert series.shape == (5, g["n_samples"])
    for i, key in enumerate(psim.SERIES_OBSERVABLES):
        np.testing.assert_allclose(series[i], np.asarray(g["series"][key]), rtol=1e-9,
                                   atol=1e-11, err_msg=f"series {key}")
    assert list(pmom.OBSERVABLES) == g["observables"]
    np.testing.assert_allclose(out.means.means.numpy(), np.asarray(g["means"]),
                               rtol=1e-9, atol=1e-12, err_msg="means")
    np.testing.assert_allclose(out.means.stds.numpy(), np.asarray(g["stds"]),
                               rtol=1e-7, atol=1e-9, err_msg="stds")
    for i, key in enumerate(psim.SERIES_OBSERVABLES):
        np.testing.assert_allclose(out.corr[i].numpy(), np.asarray(g["corr"][key]),
                                   rtol=1e-8, atol=1e-11, err_msg=f"corr {key}")
        np.testing.assert_allclose(out.corr_norm[i].numpy(), np.asarray(g["corr_norm"][key]),
                                   rtol=1e-8, atol=1e-9, err_msg=f"corr_norm {key}")
        np.testing.assert_allclose(out.corr_mean[i].numpy(), np.asarray(g["corr_mean"][key]),
                                   rtol=1e-8, atol=1e-11, err_msg=f"corr_mean {key}")
        np.testing.assert_allclose(out.corr_mean_norm[i].numpy(),
                                   np.asarray(g["corr_mean_norm"][key]),
                                   rtol=1e-8, atol=1e-9, err_msg=f"corr_mean_norm {key}")
    thermo = out.thermo(cfg)
    for key, want in g["thermo"].items():
        assert float(getattr(thermo, key)) == pytest.approx(want, rel=1e-8), key


def test_simulate_is_seeded_and_finite():
    cfg = SimConfig(num_cells=2, box_length=3.8, rc_over_box=0.45, total_steps=60,
                    output_interval=10, warmup_steps=20, dt=0.002, dtype="float64",
                    target_total_energy=-60.0, seed=7)
    a = psim.simulate(cfg, device="cpu")
    b = psim.simulate(cfg, torch.Generator().manual_seed(7), device="cpu")
    np.testing.assert_array_equal(a.series.numpy(), b.series.numpy())
    c = psim.simulate(cfg.replace(seed=8), device="cpu")
    assert not np.array_equal(a.series.numpy(), c.series.numpy())
    assert np.isfinite(a.series.numpy()).all()
    a.thermo(cfg).check_finite()
    with pytest.raises(ValueError, match="no samples"):
        psim.run_production(cfg.replace(total_steps=15, warmup_steps=12), a.final_state)
    with pytest.raises(ValueError, match="velocity_init"):
        psim.initialize(cfg, velocity_init="threefry", device="cpu")


# ---------------------------------------------------------------- stats
def test_correlations_match_jax():
    rng = np.random.default_rng(11)
    series = np.cumsum(rng.normal(size=(5, 97)), axis=1)
    for centered in (False, True):
        want = jcorr.autocorr_all(jnp.asarray(series), 20, centered=centered)
        got = pcorr.autocorr_all(torch.as_tensor(series), 20, centered=centered)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
        want = jcorr.block_corr_means(jnp.asarray(series[2]), n_blocks=4, max_lag=10,
                                      centered=centered)
        got = pcorr.block_corr_means(torch.as_tensor(series), n_blocks=4, max_lag=10,
                                     centered=centered)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[2].numpy(), np.asarray(w), rtol=1e-12, atol=1e-12)
    zero = np.zeros((1, 8))
    np.testing.assert_array_equal(pcorr.normalize_corr(torch.as_tensor(zero)).numpy(), 0.0)
    with pytest.raises(ValueError):
        pcorr.autocorr(torch.as_tensor(series[0]), 97)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_moments_and_thermo_match_jax(dtype):
    rng = np.random.default_rng(12)
    n, volume = 108, 150.0
    samples = np.stack([rng.normal(-500, 2, 40), rng.normal(160, 3, 40),
                        rng.normal(800, 20, 40), rng.normal(9000, 50, 40)], axis=1).astype(dtype)
    jacc = jmom.means_init(dtype=jnp.dtype(dtype))
    pacc = pmom.means_init(dtype=getattr(torch, dtype))
    for e, k, du, ddu in samples:
        jacc = jmom.means_update(jacc, JStepObs(*(jnp.asarray(x) for x in (e, k, du, ddu))),
                                 n, volume)
        pacc = pmom.means_update(pacc, StepObs(*(torch.as_tensor(x) for x in (e, k, du, ddu))),
                                 n, volume)
    want, got = jmom.means_finalize(jacc), pmom.means_finalize(pacc)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(got.means.numpy(), np.asarray(want.means), rtol=rtol)
    np.testing.assert_allclose(got.stds.numpy(), np.asarray(want.stds), rtol=100 * rtol)
    jt = jthermo.thermo_coefs_from_report(n, volume, want).as_dict()
    pt = pthermo.thermo_coefs_from_report(n, volume, got).as_dict()
    for k, w in jt.items():
        assert float(pt[k]) == pytest.approx(float(w), rel=100 * rtol), k
    with pytest.raises(FloatingPointError):
        pthermo.thermo_coefs(n, volume, *([0.0] * 7)).check_finite()
