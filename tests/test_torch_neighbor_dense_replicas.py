"""The batched neighbor and dense engines (``models/engine.py``
``_neighbor_engine(..., replicas=R)`` and the dense ``_force_engine``
given an (R, N, 3) state), float64 on the CPU with one thread:

- the dense force and the neighbor build, rebuild check and force over an
  (R, N, 3) stack against ``jax.vmap`` of the JAX package's functions, and
  each replica bit for bit against the port's one-system call;
- replica q of the batched engines against the one-system engine bit for
  bit, states and observables (with one thread the (R,) sums round as the
  one-system sums do), with the second replica 1.5x hotter so that its
  rebuilds fire alone; a NaN stays in its replica;
- ``run_production`` from JAX's vmapped initial states against JAX's
  vmapped ``ensemble_simulate(backend="neighbor" | "dense")``, at
  tests/test_neighbor.py's tolerances (series rtol 1e-9 / atol 1e-12,
  positions rtol 1e-9 / atol 1e-10, accelerations 1e-9);
- the batched ``initialize_replicas`` against ``initialize`` of each
  replica's generator (bit for bit here; held at 1e-12) and the routing.

The geometry is tests/test_torch_cellpair_replicas.py's: N=500 at rho 0.66,
skin 0.3 (rc + skin below L/2, as the neighbor engine needs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.ops import lj as jlj
from ljmd_tpu.ops import neighbor as jnb
from ljmd_tpu.parallel import ensemble as jens
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.ops import lj as plj
from ljmd_tpu_torch.ops import neighbor as pnb
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

R = 2
FIELDS = ("r", "ru", "v", "a")
OBS = ("epot", "ekin", "d_epot", "dd_epot")
BACKENDS = ("neighbor", "dense")


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
    """The config and R=2 post-warmup states (the batched dense warmup), the
    second replica 1.5x hotter so that the replicas' rebuilds part."""
    cfg = _port_cfg(_jcfg())
    states = psim.initialize_replicas(cfg, psim.replica_generators(4, R), backend="dense",
                                      device="cpu")
    hotter = torch.tensor([1.0, 1.5], dtype=states.v.dtype)[:, None, None]
    return cfg, dataclasses.replace(states, v=states.v * hotter)


def _engine(cfg, backend, replicas=None):
    if backend == "neighbor":
        return pe._neighbor_engine(cfg, "cpu", replicas=replicas)
    return pe._force_engine(cfg, "cpu")


def test_dense_force_matches_vmapped_jax(small):
    """The dense force over the stack: (R, N, 3) accelerations and (R,)
    sums against the vmapped JAX oracle; each replica bit for bit its
    (N, 3) call."""
    cfg, states = small
    kw = dict(use_tail_corrections=True, volume=cfg.volume, rc=cfg.rc)
    got = plj.lj_force_energy_dense(states.r, cfg.box_length, cfg.rc_square, **kw)
    want = jax.vmap(lambda r: jlj.lj_force_energy_dense(r, cfg.box_length, cfg.rc_square,
                                                        **kw))(jnp.asarray(states.r.numpy()))
    assert got.a.shape == states.r.shape and got.epot.shape == (R,)
    np.testing.assert_allclose(got.a.numpy(), np.asarray(want.a), rtol=1e-9, atol=1e-9)
    for k in OBS[:1] + OBS[2:]:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-10, err_msg=k)
    for q in range(R):
        one = plj.lj_force_energy_dense(states.r[q], cfg.box_length, cfg.rc_square, **kw)
        for f in dataclasses.fields(one):
            assert torch.equal(getattr(got, f.name)[q], getattr(one, f.name)), (q, f.name)


def test_neighbor_ops_match_vmapped_jax(small):
    """The neighbor build (indices, overflow, reference positions), the
    rebuild check and the force over the stack against ``jax.vmap`` of
    JAX's, the indices exactly; each replica bit for bit its one-system
    call. A small capacity makes one replica's list overflow alone."""
    cfg, states = small
    r_list = cfg.rc + cfg.neighbor_skin
    cap = pnb.estimate_capacity(cfg.density, r_list)
    jr = jnp.asarray(states.r.numpy())
    got = pnb.build_neighbor_list_dense(states.r, cfg.box_length, r_list**2, cap)
    want = jax.vmap(lambda r: jnb.build_neighbor_list_dense(r, cfg.box_length, r_list**2,
                                                            cap))(jr)
    assert got.idx.shape == (R, cfg.n, cap) and got.overflow.shape == (R,)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.overflow.numpy(), np.asarray(want.overflow))

    moved = states.r.clone()
    moved[1, 7, 0] = (moved[1, 7, 0] + 0.2) % cfg.box_length
    fire = pnb.needs_rebuild(got, moved, cfg.box_length, cfg.neighbor_skin)
    jfire = jax.vmap(lambda n, r: jnb.needs_rebuild(n, r, cfg.box_length, cfg.neighbor_skin))(
        want, jnp.asarray(moved.numpy()))
    assert fire.tolist() == np.asarray(jfire).tolist() == [False, True]

    kw = dict(use_tail_corrections=True, volume=cfg.volume, rc=cfg.rc)
    res = pnb.lj_force_energy_neighbor(states.r, got.idx, cfg.box_length, cfg.rc_square, **kw)
    jres = jax.vmap(lambda r, i: jnb.lj_force_energy_neighbor(r, i, cfg.box_length,
                                                              cfg.rc_square, **kw))(jr, want.idx)
    np.testing.assert_allclose(res.a.numpy(), np.asarray(jres.a), rtol=1e-9, atol=1e-9)
    for k in OBS[:1] + OBS[2:]:
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(jres, k)),
                                   rtol=1e-10, err_msg=k)
    for q in range(R):
        one = pnb.build_neighbor_list_dense(states.r[q], cfg.box_length, r_list**2, cap)
        assert torch.equal(got.idx[q], one.idx) and bool(got.overflow[q]) == bool(one.overflow)
        assert bool(fire[q]) == bool(pnb.needs_rebuild(one, moved[q], cfg.box_length,
                                                       cfg.neighbor_skin))
        f1 = pnb.lj_force_energy_neighbor(states.r[q], one.idx, cfg.box_length, cfg.rc_square,
                                          **kw)
        for f in dataclasses.fields(f1):
            assert torch.equal(getattr(res, f.name)[q], getattr(f1, f.name)), (q, f.name)

    tight = pnb.build_neighbor_list_dense(states.r, cfg.box_length, r_list**2, 40)
    jtight = jax.vmap(lambda r: jnb.build_neighbor_list_dense(r, cfg.box_length, r_list**2,
                                                              40))(jr)
    np.testing.assert_array_equal(tight.overflow.numpy(), np.asarray(jtight.overflow))
    np.testing.assert_array_equal(tight.idx.numpy(), np.asarray(jtight.idx))


def _same(got_state, got_obs, ones, one_obs, eng_one):
    for q, cq in enumerate(ones):
        want = eng_one.get_state(cq)
        for k in FIELDS:
            assert torch.equal(getattr(got_state, k)[q], getattr(want, k)), (q, k)
        for k in OBS:
            assert torch.equal(getattr(got_obs, k)[q], getattr(one_obs[q], k)), (q, k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_engine_replicas_equal_one_system(small, backend):
    """init and 40 steps: replica q's state and observables are the
    one-system engine's bit for bit. Neighbor: one host read a step for
    the stack, the lists each replica's own, and on some step the hotter
    replica rebuilds while the other keeps its list."""
    cfg, states = small
    eng, one = _engine(cfg, backend, R), _engine(cfg, backend)
    c, obs = eng.init(states)
    pairs = [one.init(pe.replica_state(states, q)) for q in range(R)]
    ones = [p[0] for p in pairs]
    _same(eng.get_state(c), obs, ones, [p[1] for p in pairs], one)
    assert obs.epot.shape == (R,)
    alone = 0
    reads = pe.HOST_READS["neighbor_rebuild"]
    for _ in range(40):
        before = c[1].r_ref if backend == "neighbor" else None
        c, obs = eng.step(c)
        pairs = [one.step(cq) for cq in ones]
        ones = [p[0] for p in pairs]
        _same(eng.get_state(c), obs, ones, [p[1] for p in pairs], one)
        if backend == "neighbor":
            fired = [not torch.equal(c[1].r_ref[q], before[q]) for q in range(R)]
            alone += fired == [False, True]
            for q in range(R):
                assert torch.equal(c[1].idx[q], ones[q][1].idx)
                assert torch.equal(c[1].r_ref[q], ones[q][1].r_ref)
    if backend == "neighbor":
        # the stack's reads (one a step) and the R one-system engines' own
        assert pe.HOST_READS["neighbor_rebuild"] - reads == 40 * (1 + R)
        assert alone > 0, "the hotter replica never rebuilt alone"
        assert eng.diagnostics(c)["neighbor_overflow"].tolist() == [False] * R


@pytest.mark.parametrize("backend", BACKENDS)
def test_nan_stays_in_its_replica(small, backend):
    """A NaN velocity in replica 1: replica 0 runs on bit for bit as alone
    (neighbor: replica 1's rebuild check reads NaN and stays False, as in
    the one-system engine)."""
    cfg, states = small
    eng, one = _engine(cfg, backend, R), _engine(cfg, backend)
    v = states.v.clone()
    v[1, 5, 0] = float("nan")
    c, _ = eng.init(dataclasses.replace(states, v=v))
    c0, _ = one.init(pe.replica_state(states, 0))
    for _ in range(12):
        c, obs = eng.step(c)
        c0, o0 = one.step(c0)
    got, want = eng.get_state(c), one.get_state(c0)
    for k in FIELDS:
        assert torch.equal(getattr(got, k)[0], getattr(want, k)), k
    for k in OBS:
        assert torch.equal(getattr(obs, k)[0], getattr(o0, k)), k
    assert not bool(torch.isfinite(obs.ekin[1]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_batched_ensemble_matches_jax_ensemble(backend):
    """run_production of the batched engine from JAX's vmapped initial
    states against JAX's vmapped ensemble_simulate: series, means, final
    states at tests/test_neighbor.py's tolerances; each replica bit for bit
    its one-replica run_production."""
    jcfg = _jcfg(total_steps=40, warmup_steps=10, seed=2)
    _, wres = jens.ensemble_simulate(jcfg, n_replicas=R, backend=backend, jit=True,
                                     keep_per_replica=True)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed), R)
    jstates = jax.jit(jax.vmap(lambda k: j_initialize(jcfg, k, backend=backend)))(keys)
    pcfg = _port_cfg(jcfg)
    states = convert.state_from_numpy({k: np.asarray(getattr(jstates, k)) for k in FIELDS})
    res = psim.run_production(pcfg, states, backend=backend, device="cpu")
    np.testing.assert_allclose(res.series.numpy(), np.asarray(wres.series), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(res.means.means.numpy(), np.asarray(wres.means.means),
                               rtol=1e-9, atol=1e-12)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(res.final_state, k).numpy(),
                                   np.asarray(getattr(wres.final_state, k)), rtol=1e-9,
                                   atol=1e-9 if k == "a" else 1e-10, err_msg=k)
    if backend == "neighbor":
        assert res.diagnostics["neighbor_overflow"].shape == (R,)
        np.testing.assert_array_equal(res.diagnostics["neighbor_overflow"].numpy(),
                                      np.asarray(wres.diagnostics["neighbor_overflow"]))
    for q in range(R):
        one = psim.run_production(pcfg, pe.replica_state(states, q), backend=backend)
        assert torch.equal(res.series[q], one.series)
        for k in FIELDS:
            assert torch.equal(getattr(res.final_state, k)[q], getattr(one.final_state, k)), k


@pytest.mark.parametrize("backend", BACKENDS)
def test_initialize_replicas_batched(backend):
    """initialize_replicas takes the batched engine: replica q equals
    initialize(cfg, generator_q) within 1e-12 (here bit for bit: one
    thread, and every sum the rescale reads rounds as alone)."""
    cfg = _port_cfg(_jcfg(warmup_steps=20))
    got = psim.initialize_replicas(cfg, psim.replica_generators(6, R), backend=backend,
                                   device="cpu")
    for q, g in enumerate(psim.replica_generators(6, R)):
        want = psim.initialize(cfg, g, backend=backend, device="cpu")
        for k in FIELDS:
            torch.testing.assert_close(getattr(got, k)[q], getattr(want, k), rtol=1e-12,
                                       atol=1e-12)
            assert torch.equal(getattr(got, k)[q], getattr(want, k)), (q, k)


def test_routing_every_backend_batched(small):
    """resolve_backend names every backend (auto: rows on the CPU);
    make_replica_engine builds the batched neighbor and dense engines (one
    carry for the stack), the loop engine stays; replicas=0 raises."""
    cfg, states = small
    for b in pe.BACKENDS:
        if b == "auto":
            assert pe.resolve_backend(cfg, b, "cpu") == "rows"
        else:
            assert pe.resolve_backend(cfg, b, "cpu") == b
    nb = pe.make_replica_engine(cfg, R, "neighbor", "cpu")
    (state, lists), _ = nb.init(states)
    assert state.r.shape == (R, cfg.n, 3) and lists.idx.dim() == 3
    dense = pe.make_replica_engine(cfg, R, "dense", "cpu")
    c, obs = dense.init(states)
    assert isinstance(c, pe.MDState) and obs.ekin.shape == (R,)
    loop = pe._replica_loop_engine([pe.make_engine(cfg, "dense", "cpu") for _ in range(R)])
    lc, lobs = loop.init(states)
    assert len(lc) == R and torch.equal(lobs.epot, obs.epot)
    with pytest.raises(ValueError, match="replicas >= 1"):
        pe._neighbor_engine(cfg, "cpu", replicas=0)
