"""The batched cell-pair engine (``models/engine.py``
``_cellpair_engine(..., replicas=R)``), float64 on the CPU:

- kernels 13, 15 and 16's replica launches through their twins on the flat
  stack of R grids (``replica_tables``) against ``jax.vmap`` of the JAX
  package's Pallas calls in interpret mode, and each replica against the
  one-grid twin bit for bit;
- replica q of every call of the batched engine (plain ``always``, the
  width chunk, the compensated ``predictive`` trigger, the sampled step's
  "moved" rebin firing for one replica only) against the one-system engine
  at the same capacity, bit for bit; a NaN in one replica stays there;
- ``run_production`` of the batched engine from JAX's initial states
  against JAX's vmapped ``ensemble_simulate(backend="cellpair")`` with
  ``neighbor_capacity`` pinned (JAX takes no census under vmap);
- the routing, the one capacity, the other sweeps built over the stack
  (tests/test_torch_cellpair_sweeps_replicas.py runs them), ``replicas=0``
  refused, and the conversions.

The geometry is tests/test_torch_cellpair.py's (N=500, rho 0.66, 3x3
pencils, skin 0.3) and so are the tolerances: trajectories rtol 1e-9 / atol
1e-10, accelerations (and sweep forces) 1e-8, the production series rtol
1e-9 / atol 1e-12.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu.ops import pallas_pencil_fused as jpf
from ljmd_tpu.parallel import ensemble as jens
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.ops import fused_pencil as pfp
from ljmd_tpu_torch.ops import pencil_sweep as pps
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

R = 2
FIELDS = ("r", "ru", "v", "a")
OBS = ("epot", "ekin", "d_epot", "dd_epot")
STEPS = 3


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _jcfg(**kw):
    base = dict(num_cells=5, density=0.66, dt=0.002, dtype="float64", neighbor_skin=0.3,
                total_steps=60, output_interval=10, warmup_steps=10,
                target_total_energy=-2000.0)
    base.update(kw)
    return config_from_density(**base)


@pytest.fixture(scope="module")
def small():
    """The config, R=2 post-warmup states (the dense engine's warmup), the
    second replica 1.5x hotter so that the replicas' decisions part, and
    the one capacity of both (the larger census)."""
    cfg = _port_cfg(_jcfg())
    states = psim.initialize_replicas(cfg, psim.replica_generators(4, R), backend="dense",
                                      device="cpu")
    hotter = torch.tensor([1.0, 1.5], dtype=states.v.dtype)[:, None, None]
    states = dataclasses.replace(states, v=states.v * hotter)
    cap = pe.replica_capacity(cfg, states)
    return cfg.replace(neighbor_capacity=cap), states


@pytest.fixture(scope="module")
def stack(small):
    """The batched engine's initial stack and both packages' tables."""
    cfg, states = small
    eng = pe._cellpair_engine(cfg, "cpu", replicas=R, width_lists=True)
    c, _ = eng.init(states)
    r_list = cfg.rc + cfg.neighbor_skin
    jgrid = jcl.make_pencil_grid(cfg.n, cfg.box_length, r_list, cfg.density,
                                 cfg.neighbor_capacity)
    pgrid = pe.make_pencil_grid(cfg.n, cfg.box_length, r_list, cfg.density,
                                cfg.neighbor_capacity)
    tbl, shf = (torch.as_tensor(x) for x in pps.build_half_shell_tables(pgrid))
    return cfg, c, jgrid, pgrid, tbl, shf


def _per_replica(x):
    """(8, R * ns) -> (R, 8, ns) numpy; (R * P,) -> (R, P)."""
    x = x.detach()
    return (x.reshape(R, -1) if x.dim() == 1 else x.reshape(8, R, -1).transpose(0, 1)).numpy()


@pytest.mark.parametrize("want_obs", [True, False])
def test_sweep_replica_twin_matches_vmapped_jax(stack, want_obs):
    """Kernel 13 over the stack against the vmapped TPU sweep (times the
    validity row) on each replica, and each replica bit for bit against
    the sweep of its grid alone."""
    cfg, c, jgrid, pgrid, tbl, shf = stack
    tbl_r, shf_r = pps.replica_tables(tbl, shf, pgrid.n_pencils, R)
    got = pps.pencil_sweep_hs(c.r, tbl_r, c.counts, shf_r, pgrid, cfg.rc_square, want_obs,
                              replicas=R)
    rows, counts = _per_replica(c.r), _per_replica(c.counts)
    want = jax.vmap(lambda r, n: jp2.pallas_pencil_sweep_hs(
        r, jnp.asarray(tbl.numpy()), n, jnp.asarray(shf.numpy()), jgrid, cfg.rc_square,
        interpret=True, want_observables=want_obs, approx_reciprocal=False) * r[3:4])(
        jnp.asarray(rows), jnp.asarray(counts))
    np.testing.assert_allclose(_per_replica(got), np.asarray(want), rtol=1e-9, atol=1e-8)
    for q in range(R):
        one = pps.pencil_sweep_hs(torch.as_tensor(rows[q]), tbl, torch.as_tensor(counts[q]),
                                  shf, pgrid, cfg.rc_square, want_obs)
        assert torch.equal(torch.as_tensor(_per_replica(got)[q]), one)


@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
@pytest.mark.parametrize("kind", ["static", "width"])
def test_chunk_replica_twins_match_vmapped_jax(stack, kind, extended):
    """Kernels 15 and 16 over the stack (STEPS steps) against the vmapped
    TPU chunks on each replica (the width lists: the stack's over R * P
    pencils, JAX's per replica), on the valid slots; each replica bit for
    bit against the chunk over its grid alone."""
    cfg, c, jgrid, pgrid, tbl, shf = stack
    P, cap, L = pgrid.n_pencils, pgrid.capacity, cfg.box_length
    tbl_r, shf_r = pps.replica_tables(tbl, shf, P, R)
    ext = dict(r_lo=torch.zeros_like(c.r), vc=torch.zeros_like(c.r)) if extended else {}
    if kind == "static":
        def port(r, v, a, tb, sh, counts, n_p, **kw):
            return pfp.fused_pencil_chunk(r, v, a, tb, sh, n_p, cap, L, cfg.rc_square,
                                          cfg.dt, STEPS, **kw)
    else:
        def port(r, v, a, tb, sh, counts, n_p, **kw):
            lists = pfp.build_width_lists(counts, tb, sh, n_p * kw.get("replicas", 1), cap)
            return pfp.fused_pencil_width_chunk(r, v, a, *lists, n_p, cap, L, cfg.rc_square,
                                                cfg.dt, STEPS, **kw)
    got = port(c.r, c.v, c.a, tbl_r, shf_r, c.counts, P, replicas=R, **ext)
    jt, js = jnp.asarray(tbl.numpy()), jnp.asarray(shf.numpy())
    jkw = dict(interpret=True, approx_reciprocal=False)

    def one_jax(r, v, a, counts):
        jext = dict(r_lo=jnp.zeros_like(r), vc=jnp.zeros_like(r)) if extended else {}
        if kind == "static":
            return jpf.fused_pencil_chunk(r, v, a, jt, js, P, cap, L, cfg.rc_square, cfg.dt,
                                          STEPS, **jkw, **jext)
        lists = jpf.build_width_lists(counts, jt, js, P, cap)
        return jpf.fused_pencil_width_chunk(r, v, a, *lists, P, cap, L, cfg.rc_square,
                                            cfg.dt, STEPS, **jkw, **jext)

    inputs = [_per_replica(x) for x in (c.r, c.v, c.a)] + [_per_replica(c.counts)]
    want = jax.vmap(one_jax)(*(jnp.asarray(x) for x in inputs))
    valid = inputs[0][:, 3:4, :]
    for i, (g, w) in enumerate(zip(got, want)):
        atol = 1e-8 if i == len(got) - 1 else 1e-10
        np.testing.assert_allclose(_per_replica(g) * valid, np.asarray(w) * valid, rtol=1e-9,
                                   atol=atol, err_msg=str(i))
    for q in range(R):
        ext_q = dict(r_lo=torch.zeros_like(c.r[:, :pgrid.n_slots]),
                     vc=torch.zeros_like(c.r[:, :pgrid.n_slots])) if extended else {}
        one = port(*(torch.as_tensor(x[q]) for x in inputs[:3]), tbl, shf,
                   torch.as_tensor(inputs[3][q]), P, **ext_q)
        for g, w in zip(got, one):
            assert torch.equal(torch.as_tensor(_per_replica(g)[q]), w)


def _same(eng_carry, ones, obs=None, one_obs=None):
    got = convert.pencil_replicas_to_numpy(eng_carry, R)
    for q, cq in enumerate(ones):
        for k in convert.PENCIL_REPLICA_FIELDS:
            assert np.array_equal(got[k][q], getattr(cq, k).numpy()), (q, k)
    if obs is not None:
        for q, oq in enumerate(one_obs):
            for k in OBS:
                assert torch.equal(getattr(obs, k)[q], getattr(oq, k)), (q, k)


CASES = {
    "always": {},
    "width_always": dict(width_lists=True),
    "compensated_predictive": dict(compensated=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_engine_replicas_equal_one_system(small, case):
    """init, run_fast (a chunk of 8 and one of 4), step, run_fast again,
    step: replica q's slot rows, counts, flag and observables are the
    one-system engine's bit for bit, and its state too; the predictive
    trigger reads one any-replica flag a chunk."""
    cfg, states = small
    kw = CASES[case]
    eng = pe._cellpair_engine(cfg, "cpu", replicas=R, **kw)
    one = pe._cellpair_engine(cfg, "cpu", **kw)
    c, obs = eng.init(states)
    pairs = [one.init(pe.replica_state(states, q)) for q in range(R)]
    ones = [p[0] for p in pairs]
    _same(c, ones, obs, [p[1] for p in pairs])
    assert obs.epot.shape == (R,) and eng.diagnostics(c)["pencil_overflow"].shape == (R,)
    reads = pe.HOST_READS["cellpair_will_exceed"]
    c = eng.run_fast(c, 12)
    ones = [one.run_fast(cq, 12) for cq in ones]
    assert pe.HOST_READS["cellpair_will_exceed"] - reads == (6 if case.endswith("predictive")
                                                             else 0)
    _same(c, ones)
    for n_fast in (0, 8):
        c = eng.run_fast(c, n_fast)
        ones = [one.run_fast(cq, n_fast) for cq in ones]
        c, obs = eng.step(c)
        pairs = [one.step(cq) for cq in ones]
        ones = [p[0] for p in pairs]
        _same(c, ones, obs, [p[1] for p in pairs])
    got = eng.get_state(c)
    for q in range(R):
        want = one.get_state(ones[q])
        for k in FIELDS:
            assert torch.equal(getattr(got, k)[q], getattr(want, k)), (q, k)
    assert not bool(eng.diagnostics(c)["pencil_overflow"].any())


def test_moved_rebin_for_one_replica(small):
    """The sampled step's "moved" check fires for replica 1 alone (moved by
    a uniform 0.3 in x, past half the xy slack): the host reads one flag,
    replica 1 is rebinned and replica 0 keeps its bins, each bit for bit as
    its one-system engine; a NaN in replica 1 stays in replica 1."""
    cfg, states = small
    eng = pe._cellpair_engine(cfg, "cpu", replicas=R)
    one = pe._cellpair_engine(cfg, "cpu")
    c, _ = eng.init(states)
    ones = [one.init(pe.replica_state(states, q))[0] for q in range(R)]
    ns = ones[0].r.shape[1]
    shift = torch.zeros_like(c.r)
    shift[0, ns:] = 0.3 * c.r[3, ns:]
    c = dataclasses.replace(c, r=c.r + shift)
    ones[1] = dataclasses.replace(ones[1], r=ones[1].r + shift[:, ns:])
    reads = pe.HOST_READS["cellpair_moved"]
    c2, _ = eng.step(c)
    assert pe.HOST_READS["cellpair_moved"] == reads + 1
    ones2 = [one.step(cq)[0] for cq in ones]
    _same(c2, ones2)
    assert torch.equal(c2.r_ref[:, :ns], c.r_ref[:, :ns])       # replica 0: no rebin
    assert not torch.equal(c2.r_ref[:, ns:], c.r_ref[:, ns:])   # replica 1: rebinned
    # a NaN in replica 1's velocities: replica 0 runs on as alone
    v = c2.v.clone()
    v[0, ns + 5] = float("nan")
    c3 = eng.run_fast(dataclasses.replace(c2, v=v), 12)
    c3, obs = eng.step(c3)
    o0, oo = one.step(one.run_fast(ones2[0], 12))
    _same_one = convert.pencil_replicas_to_numpy(c3, R)
    for k in convert.PENCIL_REPLICA_FIELDS:
        assert np.array_equal(_same_one[k][0], getattr(o0, k).numpy()), k
    assert torch.equal(obs.epot[0], oo.epot) and not bool(torch.isfinite(obs.ekin[1]))


def test_batched_ensemble_matches_jax_cellpair_ensemble():
    """run_production of the batched engine from JAX's initial states
    against JAX's vmapped ensemble_simulate(backend="cellpair") with the
    capacity pinned: series, means and final states within rtol 1e-9; each
    replica against its one-replica run_production bit for bit."""
    jcfg = _jcfg(total_steps=30, warmup_steps=10, neighbor_capacity=128, seed=2)
    want, wres = jens.ensemble_simulate(jcfg, n_replicas=R, backend="cellpair", jit=True,
                                        keep_per_replica=True)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed), R)
    jstates = jax.jit(jax.vmap(lambda k: j_initialize(jcfg, k, backend="cellpair")))(keys)
    pcfg = _port_cfg(jcfg)
    states = convert.state_from_numpy({k: np.asarray(getattr(jstates, k)) for k in FIELDS})
    res = psim.run_production(pcfg, states, backend="cellpair", device="cpu")
    np.testing.assert_allclose(res.series.numpy(), np.asarray(wres.series), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(res.means.means.numpy(), np.asarray(wres.means.means),
                               rtol=1e-9, atol=1e-12)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(res.final_state, k).numpy(),
                                   np.asarray(getattr(wres.final_state, k)), rtol=1e-9,
                                   atol=1e-8 if k == "a" else 1e-10, err_msg=k)
    assert not bool(res.diagnostics["pencil_overflow"].any())
    assert not bool(np.asarray(wres.diagnostics["pencil_overflow"]).any())
    for q in range(R):
        one = psim.run_production(pcfg, pe.replica_state(states, q), backend="cellpair")
        assert torch.equal(res.series[q], one.series)
        for k in FIELDS:
            assert torch.equal(getattr(res.final_state, k)[q], getattr(one.final_state, k)), k


def test_replica_routing_capacity_and_refusals(small):
    """resolve_backend names cellpair; make_replica_engine takes one
    capacity for all replicas (the config's, else the largest census, else
    the lattice bound); initialize_replicas warms up batched at the lattice
    bound, replica q equal to initialize alone; the z-band, the full sweep
    and the unfused chunk build over the stack (tests/
    test_torch_cellpair_sweeps_replicas.py runs them); replicas=0 raises."""
    cfg, states = small
    base = cfg.replace(neighbor_capacity=0)
    assert pe.resolve_backend(base, "cellpair", "cpu") == "cellpair"
    r_list = base.rc + base.neighbor_skin
    census = [pe.capacity_from_state(base.box_length, r_list, states.r[q]) for q in range(R)]
    assert pe.replica_capacity(base, states) == max(census)
    assert pe.replica_capacity(base.replace(neighbor_capacity=256), states) == 256
    assert pe.replica_capacity(base, None) == 0
    eng = pe.make_replica_engine(base, R, "cellpair", "cpu", states=states)
    assert eng.init(states)[0].r.shape == (8, R * 9 * max(census))
    for kw in (dict(z_band=True), dict(half_shell=False), dict(use_fused=False)):
        c, obs = pe._cellpair_engine(cfg, "cpu", replicas=R, **kw).init(states)
        assert c.r.shape == (8, R * 9 * cfg.neighbor_capacity) and obs.epot.shape == (R,)
    with pytest.raises(ValueError, match="replicas >= 1"):
        pe._cellpair_engine(cfg, "cpu", replicas=0)
    short = base.replace(warmup_steps=12)
    gens = psim.replica_generators(6, R)
    got = psim.initialize_replicas(short, gens, backend="cellpair", device="cpu")
    for q, g in enumerate(psim.replica_generators(6, R)):
        want = psim.initialize(short, g, backend="cellpair", device="cpu")
        for k in FIELDS:
            assert torch.equal(getattr(got, k)[q], getattr(want, k)), (q, k)


def test_capacity_rule_counts_one_state_as_one_replica(small):
    """One capacity rule for both factories: an (N, 3) state is one
    replica, so ``replica_capacity`` of replica q alone is its census, and
    ``make_engine`` from that state and ``make_replica_engine`` of the
    one-replica stack build the grid at it; the config's capacity wins over
    either."""
    cfg, states = small
    base = cfg.replace(neighbor_capacity=0)
    r_list = base.rc + base.neighbor_skin
    for q in range(R):
        one = pe.replica_state(states, q)
        census = pe.capacity_from_state(base.box_length, r_list, one.r)
        assert pe.replica_capacity(base, one) == census
        c, _ = pe.make_engine(base, "cellpair", "cpu", state=one).init(one)
        assert c.r.shape == (8, 9 * census)
        stack = pe.stack_states([one])
        c, _ = pe.make_replica_engine(base, 1, "cellpair", "cpu", states=stack).init(stack)
        assert c.r.shape == (8, 9 * census)
    assert pe.replica_capacity(base.replace(neighbor_capacity=256),
                               pe.replica_state(states, 0)) == 256


def test_pencil_replica_conversion_round_trip(stack):
    """The batched carry's per-replica fields to the vmapped layout and
    back (width lists rebuilt from the counts over the stack's tables)."""
    cfg, c, _, pgrid, tbl, shf = stack
    arrays = convert.pencil_replicas_to_numpy(c, R)
    assert arrays["r"].shape == (R, 8, pgrid.n_slots) and arrays["counts"].shape == (R, 9)
    back = convert.pencil_replicas_from_numpy(
        arrays, pps.replica_tables(tbl, shf, pgrid.n_pencils, R))
    for f in dataclasses.fields(c):
        if not f.name.startswith("win"):
            assert torch.equal(getattr(back, f.name), getattr(c, f.name)), f.name
