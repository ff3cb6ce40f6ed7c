"""The port's ordered N x N sweep, the (N, 3) force API, ``make_force_fn``'s
backends, the rows engine's ``triangular=False`` mode and the flagship
``entry()`` step, against the JAX package, float64 on the CPU (the JAX
Pallas kernels in interpret mode).

Tolerances are the JAX tests': the sweep rtol 1e-10 / atol 1e-12
(tests/test_engine_pallas.py:26), forces and totals 1e-9
(tests/test_pallas_lj.py:31), the rows engine's observables rel 1e-12 at
init and rtol 1e-9 after 20 steps (tests/test_engine_pallas.py:42-62). The
flagship step is float32 (its config's dtype) on the FCC lattice: each
site's force sums ~80 pair terms of order 1 that cancel to at most 0.2, and
JAX and the port sum them in other orders, so the accelerations agree to
1e-4 absolute (~80 x eps32 x the terms' scale) and the velocities to
dt/2 of that; the positions see a = 0 and agree to one float32 ulp at L
(2e-6: XLA may fuse the drift's multiply-add); the energy sums (16e6
float32 terms) to 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _pallas_rows_engine
from ljmd_tpu.models.forces import make_force_fn as j_make_force_fn
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.ops.pallas_lj import lj_force_energy_pallas as j_lj_force_energy_pallas
from ljmd_tpu.ops.pallas_lj import pallas_pair_sweep
from ljmd_tpu_torch import entry as pentry
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.forces import FORCE_BACKENDS, make_force_fn
from ljmd_tpu_torch.ops import pair_sweep as pps
from ljmd_tpu_torch.ops.lj import lj_force_energy_dense
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

FIELDS = ("r", "ru", "v", "a")
OBS = ("epot", "ekin", "d_epot", "dd_epot")


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _fluid(cfg, seed):
    """(N, 3) float64 jittered FCC positions of ``cfg``, wrapped."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice

    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64).numpy()
    rng = np.random.default_rng(seed)
    return np.mod(r + rng.normal(0, 0.08, r.shape), cfg.box_length)


def _close_result(got, want, rtol=1e-9, atol=1e-9):
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), rtol=rtol, atol=atol)
    for k in ("epot", "d_epot", "dd_epot"):
        assert float(getattr(got, k)) == pytest.approx(float(getattr(want, k)), rel=rtol), k


@pytest.mark.parametrize("n", [300, 384])
@pytest.mark.parametrize("want_obs", [True, False])
def test_ordered_sweep_twin_matches_pallas(n, want_obs):
    """Every row of the (8, n_pad) output against ``pallas_pair_sweep``, at
    n < n_pad (padding columns exactly 0) and n = n_pad."""
    rng = np.random.default_rng(n)
    L, rc2 = 7.0, 6.25
    pos = np.zeros((8, 384))
    pos[0:3, :n] = rng.uniform(0, L, (3, n))
    want = pallas_pair_sweep(jnp.asarray(pos), n, L, rc2, tile_i=128, tile_j=128,
                             interpret=True, want_observables=want_obs)
    got = pps.pair_sweep(torch.as_tensor(pos), n, L, rc2, want_obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    assert bool((got[:, n:] == 0).all()) and bool((got[6:] == 0).all())
    # the tri twin's rows 3..5 count each pair once: half the ordered totals
    tri = pps.pair_sweep_tri(torch.as_tensor(pos), n, L, rc2, want_obs)
    np.testing.assert_allclose(tri[0:3].numpy(), got[0:3].numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(2 * tri[3:6].sum(1).numpy(), got[3:6].sum(1).numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def n256():
    """N=256 at rho*=0.8 (tests/test_neighbor.py's config), float64: rc 2.5,
    rc + skin = 2.9 < L/2."""
    jcfg = config_from_density(num_cells=4, density=0.8, dtype="float64")
    r = _fluid(_port_cfg(jcfg), 5)
    return jcfg, r


def test_lj_force_energy_pallas_matches_jax(n256):
    """(N, 3) API with tail corrections against JAX's, and against the
    port's dense oracle; totals are cast back to the positions' dtype."""
    jcfg, r = n256
    args = (jcfg.box_length, jcfg.rc_square, True, jcfg.volume, jcfg.rc)
    want = j_lj_force_energy_pallas(jnp.asarray(r), *args, tile_i=128, tile_j=128,
                                    interpret=True)
    got = pps.lj_force_energy_pallas(torch.as_tensor(r), *args)
    _close_result(got, want)
    _close_result(got, lj_force_energy_dense(torch.as_tensor(r), *args))
    got32 = pps.lj_force_energy_pallas(torch.as_tensor(r, dtype=torch.float32), *args)
    assert got32.a.dtype == got32.epot.dtype == torch.float32
    with pytest.raises(ValueError, match="tail corrections"):
        pps.lj_force_energy_pallas(torch.as_tensor(r), jcfg.box_length, jcfg.rc_square)


@pytest.mark.parametrize("backend", FORCE_BACKENDS)
def test_make_force_fn_matches_jax(n256, backend):
    """Each backend of ``make_force_fn`` against the JAX package's (on the
    CPU ``auto`` is the dense oracle in both, ``pallas`` the interpreted
    kernel there and the twin here)."""
    jcfg, r = n256
    want = j_make_force_fn(jcfg, backend)(jnp.asarray(r))
    got = make_force_fn(_port_cfg(jcfg), backend, device="cpu")(torch.as_tensor(r))
    _close_result(got, want)


def test_make_force_fn_routing_and_refusals(n256):
    jcfg, _ = n256
    cfg = _port_cfg(jcfg)
    assert FORCE_BACKENDS == ("auto", "dense", "pallas", "neighbor")
    with pytest.raises(ValueError, match="unknown force backend"):
        make_force_fn(cfg, "rows", device="cpu")
    if not torch.cuda.is_available():
        # the card is the default and nothing falls back to the CPU
        for call in (lambda: make_force_fn(cfg, "pallas"), lambda: make_force_fn(cfg),
                     lambda: pe.make_engine(cfg, "neighbor"), lambda: pentry.entry()):
            with pytest.raises(RuntimeError, match="cuda"):
                call()


@pytest.fixture(scope="module")
def small():
    """N=108 at rho*=0.7 (tests/test_fused.py's config), one state."""
    jcfg = config_from_density(num_cells=3, density=0.7, dt=0.003, dtype="float64",
                               total_steps=10, warmup_steps=0, target_total_energy=-500.0)
    jstate = j_initialize(jcfg, backend="dense")
    pstate = convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS})
    return jcfg, jstate, pstate


def test_rows_ordered_sweep_matches_jax(small):
    """The rows engine with ``triangular=False`` (the ordered sweep on
    sampled steps, prefactors 2 / 12) against JAX's: init, 20 steps, and a
    fused stretch (its run_fast does not depend on the sweep)."""
    jcfg, jstate, pstate = small
    jeng = _pallas_rows_engine(jcfg, interpret=True, triangular=False)
    peng = pe._rows_engine(_port_cfg(jcfg), "cpu", triangular=False)
    jc, jo = jeng.init(jstate)
    pc, po = peng.init(pstate)
    for k in OBS:
        assert float(getattr(po, k)) == pytest.approx(float(getattr(jo, k)), rel=1e-12), k
    jc, jobs = jax.jit(lambda c: jax.lax.scan(lambda c, _: jeng.step(c), c, None, length=20))(jc)
    pobs = []
    for _ in range(20):
        pc, ob = peng.step(pc)
        pobs.append(ob)
    for k in OBS:
        np.testing.assert_allclose([float(getattr(o, k)) for o in pobs],
                                   np.asarray(getattr(jobs, k)), rtol=1e-9, err_msg=k)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(peng.get_state(pc), k).numpy(),
                                   np.asarray(getattr(jeng.get_state(jc), k)), rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    # the same trajectory as the tri sweep's engine, and the same totals
    tri = pe._rows_engine(_port_cfg(jcfg), "cpu")
    tc, to = tri.init(pstate)
    oc, oo = peng.init(pstate)
    for k in OBS:
        assert float(getattr(oo, k)) == pytest.approx(float(getattr(to, k)), rel=1e-12), k
    np.testing.assert_allclose(peng.get_state(peng.run_fast(oc, 30)).r.numpy(),
                               tri.get_state(tri.run_fast(tc, 30)).r.numpy(), rtol=1e-12)


def test_make_engine_pallas_is_rows(small):
    jcfg, _, pstate = small
    cfg = _port_cfg(jcfg)
    a = pe.make_engine(cfg, "pallas", device="cpu")
    b = pe.make_engine(cfg, "rows", device="cpu")
    assert a.run_fast.__name__ == b.run_fast.__name__ == "run_fast"
    (ca, oa), (cb, ob) = a.init(pstate), b.init(pstate)
    assert float(oa.epot) == float(ob.epot)


def test_entry_matches_graft_entry():
    """``entry(device="cpu")``'s step fed JAX's own example args (N=4000,
    float32) against ``__graft_entry__.entry()``'s, both through the dense
    oracle (``auto`` off the card); the port's own example args are the
    same lattice."""
    jfn, jargs = __graft_entry__.entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = pentry.entry(device="cpu")
    assert [tuple(t.shape) for t in args] == [tuple(a.shape) for a in jargs] == [(4000, 3)] * 4
    assert all(t.dtype == torch.float32 for t in args) and not bool(args[3].any())
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    got = fn(*(torch.as_tensor(np.array(a)) for a in jargs))
    assert len(got) == len(want) == 8
    for g, w, name, atol in zip(got[:4], want[:4], ("r", "ru", "v", "a"),
                                (2e-6, 2e-6, 2.5e-7, 1e-4)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=name)
    for g, w in zip(got[4:], want[4:]):
        assert float(g) == pytest.approx(float(w), rel=1e-5)
