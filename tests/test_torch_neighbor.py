"""The port's neighbor lists (``ljmd_tpu_torch/ops/neighbor.py``) and
neighbor engine (``models/engine.py`` ``_neighbor_engine``) against the JAX
package, float64 on the CPU.

The list indices, the overflow flag and the rebuild criterion must equal
JAX's exactly; forces, totals and trajectories agree at
tests/test_neighbor.py's tolerances (forces rtol 1e-9 / atol 1e-9, totals
rel 1e-10, the production series rtol 1e-9 / atol 1e-12, final positions
rtol 1e-9 / atol 1e-10).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import make_engine as j_make_engine
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.models.simulation import run_production as j_run_production
from ljmd_tpu.ops import neighbor as jnb
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.simulation import run_production
from ljmd_tpu_torch.ops import neighbor as pnb
from ljmd_tpu_torch.ops.lj import lj_force_energy_dense
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

FIELDS = ("r", "ru", "v", "a")


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _fluid(n, L, seed):
    return np.random.default_rng(seed).uniform(0, L, size=(n, 3))


@pytest.mark.parametrize("n,L,r_list,capacity", [(50, 10.0, 2.0, 32), (200, 7.0, 2.9, 96),
                                                 (40, 4.0, 1.9, 4)])
def test_build_indices_equal_jax(n, L, r_list, capacity):
    """The (N, K) indices (ascending, sentinel N), the overflow flag (the
    last case overflows) and the reference positions, exactly."""
    r = _fluid(n, L, n)
    want = jnb.build_neighbor_list_dense(jnp.asarray(r), L, r_list**2, capacity)
    got = pnb.build_neighbor_list_dense(torch.as_tensor(r), L, r_list**2, capacity)
    assert got.idx.dtype == torch.int32 and got.idx.shape == (n, capacity)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert bool(got.overflow) == bool(want.overflow) == (capacity == 4)
    np.testing.assert_array_equal(got.r_ref.numpy(), r)
    conv = convert.neighbor_list_from_numpy(jax.device_get(want))
    assert torch.equal(conv.idx, got.idx) and bool(conv.overflow) == bool(got.overflow)


def test_estimate_capacity_equals_jax():
    for density, r_list in ((0.8442, 2.9), (0.5, 2.8), (0.05, 4.0)):
        assert pnb.estimate_capacity(density, r_list) == jnb.estimate_capacity(density, r_list)


def test_needs_rebuild_criterion():
    """tests/test_neighbor.py's moves, each against JAX's answer."""
    L, skin = 8.0, 0.4
    r = _fluid(20, L, 4)
    jn = jnb.build_neighbor_list_dense(jnp.asarray(r), L, 4.0, 24)
    pn = pnb.build_neighbor_list_dense(torch.as_tensor(r), L, 4.0, 24)
    moves = [(None, 0.0, False), ((3, 0), 0.19, False), ((3, 0), 0.21, True)]
    for where, by, expect in moves:
        moved = r.copy()
        if where is not None:
            moved[where] += by
        got = bool(pnb.needs_rebuild(pn, torch.as_tensor(moved), L, skin))
        assert got == bool(jnb.needs_rebuild(jn, jnp.asarray(moved), L, skin)) == expect
    moved = r.copy()
    moved[5, 1] = (r[5, 1] + L - 0.3) % L  # a true move of 0.3 across the boundary
    assert bool(pnb.needs_rebuild(pn, torch.as_tensor(moved), L, skin))


def test_neighbor_force_matches_jax_and_dense():
    cfg = config_from_density(num_cells=3, density=0.8, dtype="float64")
    r = _fluid(cfg.n, cfg.box_length, 3)
    r_list = cfg.rc + cfg.neighbor_skin
    k = jnb.estimate_capacity(cfg.density, r_list)
    jn = jnb.build_neighbor_list_dense(jnp.asarray(r), cfg.box_length, r_list**2, k)
    args = (cfg.box_length, cfg.rc_square, True, cfg.volume, cfg.rc)
    want = jnb.lj_force_energy_neighbor(jnp.asarray(r), jn.idx, *args)
    pn = pnb.build_neighbor_list_dense(torch.as_tensor(r), cfg.box_length, r_list**2, k)
    assert not bool(pn.overflow)
    got = pnb.lj_force_energy_neighbor(torch.as_tensor(r), pn.idx, *args)
    dense = lj_force_energy_dense(torch.as_tensor(r), *args)
    for ref in (want, dense):
        np.testing.assert_allclose(got.a.numpy(), np.asarray(ref.a), rtol=1e-9, atol=1e-9)
        for name in ("epot", "d_epot", "dd_epot"):
            assert float(getattr(got, name)) == pytest.approx(float(getattr(ref, name)),
                                                              rel=1e-10), name


@pytest.fixture(scope="module")
def n256():
    """tests/test_neighbor.py's engine config: N=256, L=6.84, rc + skin =
    2.8 < L/2 (skin 0.3, so the list rebuilds within the run)."""
    jcfg = config_from_density(num_cells=4, density=0.8, total_steps=150, output_interval=10,
                               warmup_steps=30, dt=0.002, dtype="float64",
                               target_total_energy=-500.0, neighbor_skin=0.3)
    jstate = j_initialize(jcfg, backend="dense")
    pstate = convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS})
    return jcfg, jstate, pstate


def test_neighbor_engine_matches_jax(n256):
    """init, 40 steps (rebuilds included, one host read per step) and
    get_state against the JAX engine; the lists after a conversion of JAX's
    carry stay equal."""
    jcfg, jstate, pstate = n256
    je = j_make_engine(jcfg, "neighbor")
    peng = pe.make_engine(_port_cfg(jcfg), "neighbor", device="cpu")
    jc, jo = je.init(jstate)
    pc, po = peng.init(pstate)
    np.testing.assert_array_equal(pc[1].idx.numpy(), np.asarray(jc[1].idx))
    assert float(po.epot) == pytest.approx(float(jo.epot), rel=1e-12)

    jc, jobs = jax.jit(lambda c: jax.lax.scan(lambda c, _: je.step(c), c, None, length=40))(jc)
    pe.HOST_READS["neighbor_rebuild"] = 0
    pobs, builds = [], 0
    for _ in range(40):
        r_ref = pc[1].r_ref
        pc, ob = peng.step(pc)
        builds += pc[1].r_ref is not r_ref
        pobs.append(float(ob.etot))
    assert pe.HOST_READS["neighbor_rebuild"] == 40 and builds >= 1
    np.testing.assert_allclose(pobs, np.asarray(jobs.epot + jobs.ekin), rtol=1e-9, atol=1e-12)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(peng.get_state(pc), k).numpy(),
                                   np.asarray(getattr(je.get_state(jc), k)), rtol=1e-9,
                                   atol=1e-10, err_msg=k)
    np.testing.assert_array_equal(pc[1].idx.numpy(), np.asarray(jc[1].idx))
    assert not bool(peng.diagnostics(pc)["neighbor_overflow"])
    # continue both from JAX's carry, converted
    pc = convert.neighbor_carry_from_numpy(jax.device_get(jc))
    jc, jo = jax.jit(je.step)(jc)
    pc, po = peng.step(pc)
    assert float(po.etot) == pytest.approx(float(jo.etot), rel=1e-12)


def test_neighbor_production_matches_jax(n256):
    """run_production(backend="neighbor") in both packages: the series and
    the final state (tests/test_neighbor.py's parity against the dense
    engine, held here against JAX's neighbor engine and the port's dense
    one)."""
    jcfg, jstate, pstate = n256
    cfg = _port_cfg(jcfg)
    want = j_run_production(jcfg, jstate, backend="neighbor")
    got = run_production(cfg, pstate, backend="neighbor", device="cpu")
    dense = run_production(cfg, pstate, backend="dense", device="cpu")
    assert not bool(got.diagnostics["neighbor_overflow"])
    for ref in (np.asarray(want.series), dense.series.numpy()):
        np.testing.assert_allclose(got.series.numpy(), ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.final_state.r.numpy(), np.asarray(want.final_state.r),
                               rtol=1e-9, atol=1e-10)


def test_neighbor_engine_overflow_is_sticky_and_refusals(n256):
    jcfg, _, pstate = n256
    cfg = _port_cfg(jcfg)
    eng = pe._neighbor_engine(cfg.replace(neighbor_capacity=8), "cpu")
    c, _ = eng.init(pstate)
    assert bool(eng.diagnostics(c)["neighbor_overflow"])
    for _ in range(3):
        c, _ = eng.step(c)
    assert bool(eng.diagnostics(c)["neighbor_overflow"])
    with pytest.raises(ValueError, match="below L/2"):
        pe.make_engine(cfg.replace(neighbor_skin=1.0), "neighbor", device="cpu")
