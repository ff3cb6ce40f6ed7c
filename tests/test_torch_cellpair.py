"""The port's cell-pair pencil engine (``ljmd_tpu_torch/models/engine.py``
``_cellpair_engine``) and its routing, against the JAX package's cellpair
engine, float64 on the CPU.

Both packages start from one numpy state, and the fused stretches from one
``PencilCarry`` (``ljmd_tpu_torch.utils.convert``); the JAX engine runs its
Pallas kernels in interpret mode. The geometry is tests/test_cellpair.py's
(N=500, rho 0.66, 3x3 pencils, skin 0.3 so that rebins happen). Tolerances
are those of tests/test_cellpair.py and tests/test_pencil_fused.py:
observables at init rel 1e-12 (the same sweep, summed in another order),
trajectories rtol 1e-9 / atol 1e-10, accelerations 1e-8, the production
series rtol 1e-9 / atol 1e-12.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _cellpair_engine as j_cellpair_engine
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.models.simulation import run_production as j_run_production
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.simulation import run_production
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

OBS = ("epot", "ekin", "d_epot", "dd_epot")
FIELDS = ("r", "ru", "v", "a")


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _np_state(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _close_states(got, want, rtol=1e-9, atol=1e-10):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=rtol, atol=1e-8 if k == "a" else atol, err_msg=k)


def _close_obs(got, want, rel):
    for k in OBS:
        assert float(getattr(got, k)) == pytest.approx(float(getattr(want, k)), rel=rel), k


@pytest.fixture(scope="module")
def small():
    """tests/test_cellpair.py's N=500 config (skin 0.3), dense-initialized
    by the JAX package."""
    jcfg = config_from_density(num_cells=5, density=0.66, dt=0.002, dtype="float64",
                               neighbor_skin=0.3, total_steps=60, output_interval=10,
                               warmup_steps=10, target_total_energy=-2000.0)
    jstate = j_initialize(jcfg, backend="dense")
    return jcfg, jstate, convert.state_from_numpy(_np_state(jstate))


CASES = {
    # plain defaults: fused static chunk, a rebin before every chunk
    "fused_always": {},
    "fused_width_always": dict(width_lists=True),
    # the compensated default: extended chunk, predictive trigger
    "fused_compensated_predictive": dict(compensated=True),
    "fused_never": dict(rebin_trigger="never"),
    # JAX's unfused chunk of 12 (the port's default sizes it from the fluid)
    "unfused_always": dict(use_fused=False, inner_chunk=12),
    "unfused_predictive": dict(use_fused=False, rebin_trigger="predictive", inner_chunk=12),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cellpair_engine_matches_jax(small, case):
    """init, run_fast (fused: a chunk of 8 and one of 4; unfused: one chunk
    of 12), step and get_state against the JAX engine."""
    jcfg, jstate, pstate = small
    kw = CASES[case]
    je = j_cellpair_engine(jcfg, interpret=True, **kw)
    peng = pe._cellpair_engine(_port_cfg(jcfg), "cpu", **kw)
    assert peng.run_fast.__name__ == ("run_fast_unfused" if kw.get("use_fused") is False
                                      else "run_fast")

    jc, jo = jax.jit(je.init)(jstate)
    pc, po = peng.init(pstate)
    # the kernels refuse strided rows: every slot matrix is contiguous
    assert all(getattr(pc, f.name).is_contiguous() for f in dataclasses.fields(pc))
    _close_obs(po, jo, 1e-12)
    np.testing.assert_array_equal(pc.counts.numpy(), np.asarray(jc.counts))
    np.testing.assert_array_equal(pc.r[3:5].numpy(), np.asarray(jc.r[3:5]))
    _close_states(peng.get_state(pc), je.get_state(jc))

    pc = convert.pencil_carry_from_numpy(jax.device_get(jc))
    jc = jax.jit(lambda c: je.run_fast(c, 12))(jc)
    pc = peng.run_fast(pc, 12)
    _close_states(peng.get_state(pc), je.get_state(jc))
    np.testing.assert_array_equal(pc.counts.numpy(), np.asarray(jc.counts))
    for k in ("wl_self", "wl_self_cnt", "wl_nbr_i", "wl_nbr_j", "wl_nbr_off"):
        np.testing.assert_array_equal(getattr(pc, k).numpy(), np.asarray(getattr(jc, k)))
    assert bool(pc.overflow) == bool(jax.device_get(jc.overflow))
    assert not bool(peng.diagnostics(pc)["pencil_overflow"])

    jc, jo = jax.jit(je.step)(jc)
    pc, po = peng.step(pc)
    _close_obs(po, jo, 1e-10)
    _close_states(peng.get_state(pc), je.get_state(jc))


def test_cellpair_unfused_default_chunk_keeps_drift_check_clear(small):
    """JAX's unfused chunk of 12 lets particles at a config-5-like top speed
    outrun half the xy coverage slack between rebins (``pencil_overflow``
    set); the default chunk, sized from the top speed of the state each
    ``run_fast`` starts from, keeps it clear over the same 24 steps. The
    rule at BASELINE config 5 (dt 0.005, half the slack 0.25) gives 7 steps
    at a top speed of 4.5."""
    assert pe.chunk_from_speed(0.005, 0.25, 4.5, pe.UNFUSED_MAX_CHUNK) == 7
    assert pe.chunk_from_speed(0.005, 0.25, 0.0, pe.UNFUSED_MAX_CHUNK) == 12
    jcfg, _, pstate = small
    cfg = _port_cfg(jcfg).replace(dt=0.005)
    # A uniform drift on the fluid: the same forces, a top speed near 7.
    st = dataclasses.replace(pstate, v=pstate.v + torch.tensor([4.0, 0.0, 0.0],
                                                                dtype=torch.float64))
    flags = {}
    for chunk in (12, None):
        eng = pe._cellpair_engine(cfg, "cpu", use_fused=False, inner_chunk=chunk)
        c = eng.run_fast(eng.init(st)[0], 24)
        flags[chunk] = bool(eng.diagnostics(c)["pencil_overflow"])
    assert flags == {12: True, None: False}


def test_cellpair_production_matches_jax(small):
    """run_production(backend="cellpair") in both packages: JAX's
    run_production sizes the capacity from the state's census, as the
    port's make_engine does."""
    jcfg, jstate, pstate = small
    want = j_run_production(jcfg, jstate, backend="cellpair")
    got = run_production(_port_cfg(jcfg), pstate, backend="cellpair", device="cpu")
    np.testing.assert_allclose(got.series.numpy(), np.asarray(want.series), rtol=1e-9,
                               atol=1e-12)
    _close_states(got.final_state, want.final_state)
    assert not bool(got.diagnostics["pencil_overflow"])


def test_cellpair_routing_and_refusals():
    """auto on a card: N=32000 -> cellpair, N=16384 -> zsort (the JAX
    package's accelerator branch); the CPU stays on rows. The full and
    z-banded sweeps run unfused, the z-band falls back to the half shell
    where its window reaches the capacity (as in JAX); the fused path
    without the half shell, an unknown trigger and width lists without the
    fused path raise."""
    n32000 = config_from_density(num_cells=20, density=0.8442)
    n16384 = config_from_density(num_cells=16, density=0.8442)
    assert pe.auto_backend(_port_cfg(n32000), on_accelerator=True) == "cellpair"
    assert pe.auto_backend(_port_cfg(n16384), on_accelerator=True) == "zsort"
    assert pe.auto_backend(_port_cfg(n32000), on_accelerator=False) == "rows"
    cfg = _port_cfg(config_from_density(num_cells=5, density=0.66, neighbor_skin=0.3))
    # capacity 128: window 384 >= 128, the band degenerates to the half shell
    assert pe._cellpair_engine(cfg, "cpu", z_band=True).run_fast.__name__ == "run_fast"
    assert pe._cellpair_engine(cfg, "cpu", half_shell=False).run_fast.__name__ == \
        "run_fast_unfused"
    wide = cfg.replace(neighbor_capacity=512)
    assert pe._cellpair_engine(wide, "cpu", z_band=True).run_fast.__name__ == "run_fast_unfused"
    for kw in (dict(z_band=True), dict(half_shell=False)):
        with pytest.raises(ValueError, match="fused pencil path"):
            pe._cellpair_engine(wide, "cpu", use_fused=True, **kw)
    with pytest.raises(ValueError, match="rebin trigger"):
        pe._cellpair_engine(cfg, "cpu", rebin_trigger="sometimes")
    with pytest.raises(ValueError, match="width_lists"):
        pe._cellpair_engine(cfg, "cpu", use_fused=False, width_lists=True)
    # make_engine sizes the capacity from a state's census, unless the
    # config sets one
    r = torch.full((cfg.n, 3), 0.5, dtype=torch.float64)
    from ljmd_tpu_torch.state import MDState

    state = MDState(r=r, ru=r, v=torch.zeros_like(r), a=torch.zeros_like(r))
    eng = pe.make_engine(cfg, "cellpair", "cpu", state=state)
    assert eng.init(state)[0].r.shape[1] == 9 * 640  # 500 in one pencil: 516 -> 640
    eng = pe.make_engine(cfg.replace(neighbor_capacity=768), "cellpair", "cpu", state=state)
    assert eng.init(state)[0].r.shape[1] == 9 * 768
