"""The port's full 9-neighbour and z-banded pencil sweeps, their tables, the
z-ordered rebin and the cell-pair engine's ``half_shell=False`` /
``z_band=True`` paths, against the JAX package, float64 on the CPU (the
JAX kernels in interpret mode).

Tolerances are the JAX tests': the sweeps rtol 1e-10 / atol 1e-12 relative
to each array's scale (tests/test_zband.py:79; the per-pair arithmetic is
the same and only the summation order differs), the tables, the rebin order
and the window tables exactly, the engines rtol 1e-9 / atol 1e-11
(tests/test_cellpair.py:238) and their observables rel 1e-11 at init.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _cellpair_engine as j_cellpair_engine
from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_pencil as jpp
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import pencil_sweep as pps
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

RC2 = 6.25
SWEEP_RTOL, SWEEP_ATOL = 1e-10, 1e-12
FIELDS = ("r", "ru", "v", "a")
OBS = ("epot", "ekin", "d_epot", "dd_epot")


def _t(x):
    return torch.as_tensor(np.array(x))


def _close_scaled(got, want, rtol=SWEEP_RTOL, atol=SWEEP_ATOL):
    """|got - want| <= atol + rtol * max|want| (the arrays' own scale)."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= atol + rtol * float(np.abs(want).max()), err


def _slot_state(r, jgrid, sentinels):
    """JAX slot rows (validity in row 3, sentinels or zeros in empty slots)
    and counts of (N, 3) positions binned by ``bin_to_slots``."""
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns = jgrid.n_slots
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    r8 = r8.at[3].set(valid)
    if sentinels:
        r8 = jp2.sentinel_fill(r8, valid, jgrid.capacity)
    counts = valid.reshape(jgrid.n_pencils, jgrid.capacity).sum(1).astype(jnp.int32)
    return r8, counts


@pytest.fixture(scope="module")
def lattice():
    """tests/test_pencil_fused.py's jittered lattice: N=2048, L=13.4, 4x4
    pencils of capacity 256 (counts straddle 128)."""
    n, L, r_list = 2048, 13.4, 2.9
    rng = np.random.default_rng(3)
    r = (np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64)) + rng.normal(0, 0.05, (n, 3))) % L
    jgrid = jcl.make_pencil_grid(n, L, r_list, n / L**3)
    pgrid = pcl.make_pencil_grid(n, L, r_list, n / L**3)
    assert (pgrid.m_xy, pgrid.capacity) == (4, 256)
    return r, jgrid, pgrid


@pytest.fixture(scope="module")
def tall_box():
    """A tall box where the z-band is live: N=1600 uniform in L=60, 3x3
    pencils (r_list 20) of capacity 512, ~178 a pencil, windows of 384
    for r_extend = 2.9, some crossing z = 0 or z = L."""
    n, L = 1600, 60.0
    r = np.random.default_rng(0).uniform(0, L, size=(n, 3))
    jgrid = jcl.make_pencil_grid(n, L, 20.0, n / L**3, capacity=512)
    pgrid = pcl.make_pencil_grid(n, L, 20.0, n / L**3, 512)
    window = jcl.default_z_window(jgrid, n, 2.9)
    assert window == pcl.default_z_window(pgrid, n, 2.9) == 384 < pgrid.capacity
    r8, counts = _slot_state(r, jgrid, sentinels=False)
    return n, jgrid, pgrid, window, r8, counts


def test_tables_equal_jax(lattice, tall_box):
    for jgrid, pgrid in ((lattice[1], lattice[2]), (tall_box[1], tall_box[2])):
        np.testing.assert_array_equal(pgrid.neighbor_table(), jgrid.neighbor_table())
        np.testing.assert_array_equal(pps.build_tile_table(pgrid), jpp.build_tile_table(jgrid))
        np.testing.assert_array_equal(pps.build_shift_table(pgrid),
                                      jpp.build_shift_table(jgrid))
    assert pps.build_tile_table(lattice[2]).dtype == np.int32
    for n, cap in ((62500, 512), (62500, 384), (3200, 512), (500, 128)):
        jg = jcl.PencilGrid(m_xy=14, capacity=cap, box_length=42.0)
        pg = pcl.PencilGrid(m_xy=14, capacity=cap, box_length=42.0)
        assert pcl.default_z_window(pg, n, 2.9) == jcl.default_z_window(jg, n, 2.9)


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("sentinels", [True, False])
def test_full_sweep_twin_matches_pallas(lattice, sentinels, want_obs):
    """The full 9-neighbour twin against ``pallas_pencil_sweep`` (interpret),
    every output row; empty slots hold sentinels or sit at the origin (the
    validity mask must keep them out)."""
    r, jgrid, pgrid = lattice
    r8, counts = _slot_state(r, jgrid, sentinels)
    want = jpp.pallas_pencil_sweep(r8, jnp.asarray(jpp.build_tile_table(jgrid)), counts, jgrid,
                                   RC2, interpret=True, want_observables=want_obs)
    p = _t(r8)
    got = pps.pencil_sweep(p, torch.as_tensor(pps.build_tile_table(pgrid)), _t(counts),
                           torch.as_tensor(pps.build_shift_table(pgrid)), pgrid, RC2, want_obs)
    assert got.shape == p.shape and got.dtype == torch.float64
    for row in range(8):
        _close_scaled(got[row].numpy(), want[row])
    assert bool((got[:, p[3] == 0] == 0).all()), "invalid slots must be exactly zero"
    if not want_obs:
        assert bool((got[3:] == 0).all())


def test_z_ordered_rebin_matches_jax(lattice):
    """``rebin_gather_parts(z_order=True)`` against JAX's on a scattered slot
    state (positions moved, some slots emptied): the order, the target map,
    the validity and the flag exactly; the composed form too."""
    r, jgrid, pgrid = lattice
    r8, _ = _slot_state(r, jgrid, sentinels=True)
    rng = np.random.default_rng(7)
    rows = np.array(r8)
    valid = rows[3].copy()
    valid[rng.random(valid.shape) < 0.05] = 0.0
    rows[0:3] = np.mod(rows[0:3] + rng.normal(0, 0.4, rows[0:3].shape), 13.4)
    want = jcl.rebin_gather_parts(jnp.asarray(rows), jnp.asarray(valid), jgrid, z_order=True)
    got = pcl.rebin_gather_parts(_t(rows), _t(valid), pgrid, z_order=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jcl.rebin_gather(jnp.asarray(rows), jnp.asarray(valid), jgrid, z_order=True)
    got = pcl.rebin_gather(_t(rows), _t(valid), pgrid, z_order=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window,r_extend", [(None, 2.9), (128, 15.0)])
def test_z_windows_equal_jax(tall_box, window, r_extend):
    """``compute_z_windows``: start_a, start_b, use_b and the overflow flag
    exactly JAX's, at the default window (wrap windows occur) and at one
    too small for its margin (the flag must rise in both)."""
    n, jgrid, pgrid, w_default, r8, counts = tall_box
    window = window or w_default
    want = jcl.compute_z_windows(r8, r8[3], counts, jgrid, window, r_extend, 128)
    p = _t(r8)
    got = pcl.compute_z_windows(p, p[3], _t(counts), pgrid, window, r_extend)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == bool(want[3]) == (window == 128)
    if window == w_default:
        assert bool((got[2] > 0).any()), "uniform z should produce wrap windows"
        assert bool((got[0] % 128 == 0).all()) and int(got[0].max()) <= pgrid.capacity - window


def test_zband_twin_matches_jax_and_full(tall_box):
    """The z-band twin against ``pallas_pencil_sweep_zband`` (interpret) and
    against the full 9-neighbour twin (tests/test_zband.py's check)."""
    n, jgrid, pgrid, window, r8, counts = tall_box
    wa, wb, ub, ovf = jcl.compute_z_windows(r8, r8[3], counts, jgrid, window, 2.9, 128)
    assert not bool(ovf)
    tbl = jnp.asarray(jpp.build_tile_table(jgrid))
    want = jpp.pallas_pencil_sweep_zband(r8, tbl, counts, wa, wb, ub, jgrid, RC2, window,
                                         interpret=True)
    p, ptbl = _t(r8), torch.as_tensor(pps.build_tile_table(pgrid))
    got = pps.pencil_sweep_zband(p, ptbl, _t(counts), _t(wa), _t(wb), _t(ub), pgrid, RC2, window)
    full = pps.pencil_sweep(p, ptbl, _t(counts), torch.as_tensor(pps.build_shift_table(pgrid)),
                            pgrid, RC2)
    for row in range(8):
        _close_scaled(got[row].numpy(), want[row])
        _close_scaled(got[row].numpy(), full[row].numpy())


# ---------------------------------------------------------------- engines
def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _close_states(got, want, rtol=1e-9, atol=1e-11):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def small():
    """tests/test_cellpair.py's N=500 fluid (3x3 pencils, skin 0.3). At its
    default capacity 128 the z-band's window (384) would cover the pencil
    and the band turn itself off; at capacity 512 it is live."""
    jcfg = config_from_density(num_cells=5, density=0.66, dt=0.002, dtype="float64",
                               neighbor_skin=0.3, total_steps=60, output_interval=10,
                               warmup_steps=10, target_total_energy=-2000.0)
    jstate = j_initialize(jcfg, backend="dense")
    pstate = convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS})
    return jcfg, jstate, pstate


# (engine options, capacity, inner chunk, run_fast steps). The JAX engines
# run interpreted Pallas sweeps, which compile slowly at capacity 512 (~14 s
# each on one CPU core), so the z-band case runs init and two 1-step chunks
# (a z-ordered rebin and new windows before each) and leaves the per-step
# path to the full-9 case.
ENGINE_CASES = {
    "full9": (dict(half_shell=False), 0, 2, 5),
    "zband": (dict(z_band=True), 512, 1, 2),
}


@pytest.mark.parametrize("mode", list(ENGINE_CASES))
def test_cellpair_full_sweeps_match_jax(small, mode):
    """init, run_fast (unfused chunks, a rebin folded into the first step of
    each) and, for full9, step against the JAX engine; counts and window
    tables exactly."""
    jcfg, jstate, pstate = small
    kw, cap, chunk, n_steps = ENGINE_CASES[mode]
    jcfg = dataclasses.replace(jcfg, neighbor_capacity=cap)
    je = j_cellpair_engine(jcfg, interpret=True, inner_chunk=chunk, **kw)
    peng = pe._cellpair_engine(_port_cfg(jcfg), "cpu", inner_chunk=chunk, **kw)
    assert peng.run_fast.__name__ == "run_fast_unfused"

    jc, jo = jax.jit(je.init)(jstate)
    pc, po = peng.init(pstate)
    for k in OBS:
        assert float(getattr(po, k)) == pytest.approx(float(getattr(jo, k)), rel=1e-11), k
    for k in ("counts", "win_a", "win_b", "use_b"):
        np.testing.assert_array_equal(getattr(pc, k).numpy(), np.asarray(getattr(jc, k)), k)
    assert bool((pc.use_b > 0).any()) == (mode == "zband")
    _close_states(peng.get_state(pc), je.get_state(jc))

    pc = convert.pencil_carry_from_numpy(jax.device_get(jc))
    jc = jax.jit(lambda c: je.run_fast(c, n_steps))(jc)
    pc = peng.run_fast(pc, n_steps)
    _close_states(peng.get_state(pc), je.get_state(jc))
    for k in ("counts", "win_a", "win_b", "use_b"):
        np.testing.assert_array_equal(getattr(pc, k).numpy(), np.asarray(getattr(jc, k)), k)
    # In this short box a slice's z margin wraps at both faces, which
    # compute_z_windows flags (window A still covers the whole pencil).
    assert bool(pc.overflow) == bool(jc.overflow) == (mode == "zband")
    if mode == "zband":
        return

    jc, jo = jax.jit(je.step)(jc)
    pc, po = peng.step(pc)
    for k in OBS:
        assert float(getattr(po, k)) == pytest.approx(float(getattr(jo, k)), rel=1e-9), k
    _close_states(peng.get_state(pc), je.get_state(jc))


def test_cellpair_full_sweeps_match_half_shell(small):
    """The three sweeps from one state over 3 per-step steps
    (tests/test_cellpair.py:206's check, here in the port alone)."""
    jcfg, _, pstate = small
    cfg = _port_cfg(jcfg).replace(neighbor_capacity=512)
    ends = {}
    for mode, kw in (("hs", {}), ("full9", {"half_shell": False}), ("zband", {"z_band": True})):
        eng = pe._cellpair_engine(cfg, "cpu", **kw)
        c, ob0 = eng.init(pstate)
        for _ in range(3):
            c, ob = eng.step(c)
        ends[mode] = (eng.get_state(c), ob0, ob)
    s_h, ob0_h, ob_h = ends["hs"]
    for mode in ("full9", "zband"):
        s, ob0, ob = ends[mode]
        for k in OBS:
            assert float(getattr(ob0, k)) == pytest.approx(float(getattr(ob0_h, k)), rel=1e-11)
        assert float(ob.epot) == pytest.approx(float(ob_h.epot), rel=1e-9)
        for k in ("r", "v", "a"):
            np.testing.assert_allclose(getattr(s, k).numpy(), getattr(s_h, k).numpy(),
                                       rtol=1e-9, atol=1e-11, err_msg=f"{mode} {k}")
