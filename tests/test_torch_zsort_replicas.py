"""The batched zsort engine (``models/engine.py`` ``_zsort_engine(...,
replicas=R)``) and the replica dimension of kernels 9 and 10 on the CPU,
float64 unless named, at small sizes:

- the tile flags, the visit-list pack (kernel 9) and the list chunk (kernel
  10, plain, extended and ``obs_last``) over (R, ...) stacks against the JAX
  package's ``vmap``ped Pallas kernels (interpret mode), at
  tests/test_torch_window_lists.py's tolerances (lists exact, chunk rows
  1e-10), and replica q of each against the one-replica call bit for bit;
- replica q of the batched engine against the one-system zsort engine from
  replica q's state, bit for bit: init, run_fast, step, run_sample, the
  sorted ids and the lists, plain and extended; and chunk by chunk for
  replicas at two temperatures;
- the batched ensemble (``run_production`` of (R, N, 3) states, ``auto`` on
  the CPU does not pick zsort, so ``backend="zsort"``) against the JAX
  package's ``ensemble_simulate(backend="zsort")`` from its own initial
  states, at tests/test_torch_zsort.py's tolerance (series and states rtol
  1e-8), and against one-replica runs bit for bit;
- the routing: ``resolve_backend`` names zsort (and every other backend)
  for ``make_replica_engine``, which batches it, and the replica loop stays
  reachable (``_replica_loop_engine``) and equal to the batched engine.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.ops import pallas_fused as pf
from ljmd_tpu.parallel import ensemble as jens
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import fused_list, window_lists
from ljmd_tpu_torch.ops.pair_sweep import pair_forces_plain
from ljmd_tpu_torch.parallel import ensemble as pens
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

R = 3
RC = 2.5
WINDOW = RC + 1.2 * 0.6
FIELDS = ("r", "ru", "v", "a")
# N=500 at rho* = 0.8 (tests/test_torch_zsort.py's production config): n_pad 512
BOX, N_PAD = (500 / 0.8) ** (1.0 / 3.0), 512


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _sorted_fluids(seed, replicas=R):
    """(n, (R, 8, n_pad) rows, velocities) of perturbed N=500 lattices, each
    in ascending-z order."""
    rng = np.random.default_rng(seed)
    lattice = fcc_lattice(5, BOX, dtype=torch.float64).numpy()
    n = len(lattice)
    rows = np.zeros((replicas, 8, N_PAD))
    v = np.zeros_like(rows)
    for q in range(replicas):
        r = np.mod(lattice + rng.normal(scale=0.05, size=lattice.shape), BOX)
        rows[q, 0:3, :n] = r[np.argsort(r[:, 2])].T
        v[q, 0:3, :n] = rng.uniform(-1.0, 1.0, (3, n))
    return n, rows, v


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("x_window", [None, WINDOW], ids=["pure_z", "x_window"])
def test_replica_flags_and_pack_match_vmapped_pallas(x_window):
    """(R, 8, n_pad) rows -> (R, n_b^2) flags -> (R, ...) lists: each
    replica's equal to JAX's vmapped flags and pack kernel (zero_fill, so
    past the counts too), and to the one-replica calls."""
    n, rows, _ = _sorted_fluids(3)
    kw = dict(x_window=x_window, cross_margin=0.36)
    want_flags = np.asarray(jax.vmap(lambda r: pf.compute_tile_flags(
        r, n, 128, 128, BOX, WINDOW, **kw))(jnp.asarray(rows)))
    flags = window_lists.compute_tile_flags(torch.tensor(rows), n, 128, 128, BOX, WINDOW, **kw)
    assert flags.shape == (R, (N_PAD // 128) ** 2) and flags.dtype == torch.int32
    np.testing.assert_array_equal(flags.numpy(), want_flags)
    for tj in (256, 512):
        jt, jc = jax.vmap(lambda f: pf.build_window_lists_pallas(
            f, n, N_PAD, 128, tj, interpret=True, zero_fill=True, tail_tiles=True))(
            jnp.asarray(want_flags))
        tiles, counts = window_lists.build_window_lists(flags, n, N_PAD, 128, tj,
                                                        zero_fill=True)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tiles.numpy(), np.asarray(jt))
        for q in range(R):
            one_flags = window_lists.compute_tile_flags(torch.tensor(rows[q]), n, 128, 128, BOX,
                                                        WINDOW, **kw)
            assert torch.equal(flags[q], one_flags)
            one = window_lists.build_window_lists(one_flags, n, N_PAD, 128, tj, zero_fill=True)
            assert torch.equal(tiles[q], one[0]) and torch.equal(counts[q], one[1])


@pytest.fixture(scope="module")
def chunk_inputs():
    """R sorted N=500 fluids with tile_j 256 and random block flags of their
    own, so that every category (free / x-only / full, masked with jmin, and
    width-1 tails) occurs across the replicas."""
    n, rows, v = _sorted_fluids(5)
    a = 24.0 * pair_forces_plain(torch.tensor(rows), n, BOX, RC * RC).numpy()
    flags = np.random.default_rng(6).choice([0, 1, 3, 5, 7], p=[0.2, 0.4, 0.1, 0.2, 0.1],
                                            size=(R, 16)).astype(np.int32)
    # Block row 0 of each replica: one window past the diagonal and inside
    # n, free / x-only / full (the random rows give masked visits and tails).
    flags[:, 0:4] = [[0, 1, 1, 0], [0, 5, 1, 0], [0, 3, 5, 0]]
    tiles, counts = jax.vmap(lambda f: pf.build_window_lists_pallas(
        f, n, N_PAD, 128, 256, interpret=True, zero_fill=True, tail_tiles=True))(
        jnp.asarray(flags))
    counts = np.asarray(counts)
    assert (counts.sum(axis=0) > 0).all(), counts
    return n, rows, v, a, np.asarray(tiles), counts


@pytest.mark.parametrize("mode", ["plain", "extended", "obs_last"])
def test_replica_list_chunk_matches_vmapped_pallas(chunk_inputs, mode):
    n, rows, v, a, tiles, counts = chunk_inputs
    extended, obs_last = mode == "extended", mode == "obs_last"
    rng = np.random.default_rng(17)
    live = (np.arange(N_PAD) < n) * (np.arange(8) < 3)[:, None]
    lo = rng.uniform(-1e-9, 1e-9, rows.shape) * live
    vc = rng.uniform(-1e-9, 1e-9, rows.shape) * live
    args = dict(n=n, box_length=BOX, rc_square=RC * RC, dt=0.004, n_steps=2, tile_i=128,
                tile_j=256, obs_last=obs_last)

    def jax_one(r_, v_, a_, t_, c_, lo_, vc_):
        kw = dict(r_lo=lo_, vc=vc_) if extended else {}
        return pf.fused_dense_chunk_list(r_, v_, a_, t_, c_, interpret=True, j_granule=128,
                                         **args, **kw)

    want = jax.vmap(jax_one)(*(jnp.asarray(x) for x in (rows, v, a, tiles, counts, lo, vc)))
    pkw = dict(r_lo=torch.tensor(lo), vc=torch.tensor(vc)) if extended else {}
    ins = (torch.tensor(rows), torch.tensor(v), torch.tensor(a), torch.tensor(tiles),
           torch.tensor(counts))
    got = fused_list.fused_dense_chunk_list(*ins, **args, **pkw)
    assert len(got) == len(want) == (5 if extended else 3) + int(obs_last)
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape == (R, 8, N_PAD)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * max(1.0, np.abs(w).max()), err_msg=f"output {k}")
    for q in range(R):
        qkw = {k: x[q] for k, x in pkw.items()}
        alone = fused_list.fused_dense_chunk_list(*(x[q] for x in ins), **args, **qkw)
        for g, w in zip(got, alone):
            assert torch.equal(g[q], w)


# ---------------------------------------------------------------- engine
def _states(cfg, seed, replicas=R):
    """(R, N, 3) post-warmup states of ``cfg`` (the dense engine's warmup)."""
    return psim.initialize_replicas(cfg, psim.replica_generators(seed, replicas),
                                    backend="dense", device="cpu")


def _same_carry(c, q, one):
    for f in dataclasses.fields(pe.ZSortCarry):
        got, want = getattr(c, f.name)[q], getattr(one, f.name)
        if f.name == "tiles":  # entries past the counts are unspecified
            continue
        assert torch.equal(got, want), f.name


@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
def test_batched_engine_replicas_equal_one_system_engine(extended):
    """Replica q of every call of the batched engine is the one-system
    engine's call on replica q's carry, bit for bit (observables included:
    on the CPU the batched sums round as the one-system ones)."""
    cfg = _port_cfg(config_from_density(
        num_cells=5, density=0.8, dt=0.003, dtype="float32" if extended else "float64",
        total_steps=20, output_interval=5, warmup_steps=10, target_total_energy=-2300.0,
        compensated_sum=extended))
    states = _states(cfg, 7)
    kw = dict(inner_chunk=8, extended=extended)
    eng = pe._zsort_engine(cfg, "cpu", replicas=R, **kw)
    one = pe._zsort_engine(cfg, "cpu", **kw)
    c, obs = eng.init(states)
    assert c.r.shape == (R, 8, N_PAD) and c.invalid.shape == (R,) and obs.epot.shape == (R,)
    calls = [lambda e, x: e.run_fast(x, 12), lambda e, x: e.step(x)[0],
             lambda e, x: e.run_sample(x, 8)[0]]
    for q in range(R):
        cq, oq = one.init(pe.replica_state(states, q))
        _same_carry(c, q, cq)
        assert all(torch.equal(getattr(obs, k)[q], getattr(oq, k)) for k in ("epot", "ekin"))
    carries = [c] + [None] * len(calls)
    for i, call in enumerate(calls):
        carries[i + 1] = call(eng, carries[i])
    _, sobs = eng.run_sample(carries[-1], 8)
    for q in range(R):
        cq, _ = one.init(pe.replica_state(states, q))
        for i, call in enumerate(calls):
            cq = call(one, cq)
            _same_carry(carries[i + 1], q, cq)
            k = int(cq.tcounts.sum())
            assert k > 0
        _, oq = one.run_sample(cq, 8)
        assert torch.equal(sobs.epot[q], oq.epot) and torch.equal(sobs.d_epot[q], oq.d_epot)
        got = eng.get_state(carries[-1])
        want = one.get_state(cq)
        for k in FIELDS:
            assert torch.equal(getattr(got, k)[q], getattr(want, k)), k
    assert not bool(eng.diagnostics(carries[-1])["zsort_invalid"].any())


def test_batched_replicas_apart_equal_one_system_chunk_by_chunk():
    """R=2 replicas, the second 1.6x hotter (N=500 at rho* 0.8, dt 0.004):
    after every one of 6 chunks of 8 (and a run_sample) replica q's carry,
    its resort count included, is the one-system engine's bit for bit, and
    neither flag is set."""
    reps, chunk = 2, 8
    cfg = _port_cfg(config_from_density(num_cells=5, density=0.8, dt=0.004, dtype="float64",
                                        total_steps=10, warmup_steps=30,
                                        target_total_energy=-2300.0))
    states = _states(cfg, 11, replicas=reps)
    hotter = torch.tensor([1.0, 1.6], dtype=states.v.dtype)[:, None, None]
    states = dataclasses.replace(states, v=states.v * hotter)
    eng = pe._zsort_engine(cfg, "cpu", inner_chunk=chunk, extended=False, replicas=reps)
    one = pe._zsort_engine(cfg, "cpu", inner_chunk=chunk, extended=False)
    c, _ = eng.init(states)
    ones = [one.init(pe.replica_state(states, q))[0] for q in range(reps)]
    for k in range(6):
        c = eng.run_fast(c, chunk)
        ones = [one.run_fast(cq, chunk) for cq in ones]
        for q in range(reps):
            _same_carry(c, q, ones[q])
        assert c.resorts.tolist() == [k + 1] * reps
    c, obs = eng.run_sample(c, chunk)
    for q in range(reps):
        cq, oq = one.run_sample(ones[q], chunk)
        _same_carry(c, q, cq)
        assert torch.equal(obs.epot[q], oq.epot) and torch.equal(obs.ekin[q], oq.ekin)
        got, want = eng.get_state(c), one.get_state(cq)
        for k in FIELDS:
            assert torch.equal(getattr(got, k)[q], getattr(want, k)), k
    assert not bool(eng.diagnostics(c)["zsort_invalid"].any())


def test_batched_ensemble_matches_jax_zsort_ensemble():
    """``run_production`` of the batched engine from JAX's initial states
    against JAX's ``ensemble_simulate(backend="zsort")``: series, means and
    final states rtol 1e-8 (tests/test_torch_zsort.py's production
    tolerance); the aggregates; each replica against its one-replica run
    bit for bit."""
    jcfg = config_from_density(num_cells=5, density=0.8, dt=0.003, dtype="float64",
                               total_steps=10, output_interval=5, warmup_steps=0,
                               target_total_energy=-2300.0, seed=2)
    reps = 2
    want, wres = jens.ensemble_simulate(jcfg, n_replicas=reps, backend="zsort", jit=True,
                                        keep_per_replica=True)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed), reps)
    jstates = jax.jit(jax.vmap(lambda k: j_initialize(jcfg, k, backend="zsort")))(keys)
    pcfg = _port_cfg(jcfg)
    states = convert.state_from_numpy({k: np.asarray(getattr(jstates, k)) for k in FIELDS})
    assert pe.resolve_backend(pcfg, "zsort", "cpu") == "zsort"
    res = psim.run_production(pcfg, states, backend="zsort", device="cpu")
    got = pens.ensemble_aggregate(pcfg, res)
    np.testing.assert_allclose(res.series.numpy(), np.asarray(wres.series), rtol=1e-8,
                               atol=1e-9)
    np.testing.assert_allclose(got.replica_means.numpy(), np.asarray(want.replica_means),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(got.mean_of_means.numpy(), np.asarray(want.mean_of_means),
                               rtol=1e-8, atol=1e-9)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(res.final_state, k).numpy(),
                                   np.asarray(getattr(wres.final_state, k)), rtol=1e-8,
                                   atol=1e-9, err_msg=k)
    assert int(got.n_ok) == reps and not bool(res.diagnostics["zsort_invalid"].any())
    # one-replica runs on an engine built for the stack's temperature (the
    # batched engine's skin is the hottest replica's)
    one_engine = pe.make_engine(pcfg, "zsort", "cpu", state=states,
                                sample_interval=pcfg.output_interval)
    for q in range(reps):
        one = psim.run_production(pcfg, pe.replica_state(states, q), engine=one_engine)
        assert torch.equal(res.series[q], one.series)
        for k in FIELDS:
            assert torch.equal(getattr(res.final_state, k)[q], getattr(one.final_state, k)), k


def test_replica_loop_stays_and_equals_the_batched_engine():
    """The loop over one-system engines (the yardstick) and the batched
    engine give one production bit for bit; cellpair, neighbor and dense
    are batched too."""
    cfg = _port_cfg(config_from_density(num_cells=5, density=0.8, dt=0.003, dtype="float64",
                                        total_steps=15, output_interval=5, warmup_steps=5,
                                        target_total_energy=-2300.0))
    states = _states(cfg, 9, replicas=2)
    batched = pe.make_replica_engine(cfg, 2, "zsort", "cpu", sample_interval=5)
    loop = pe._replica_loop_engine([pe.make_engine(cfg, "zsort", "cpu", sample_interval=5)
                                    for _ in range(2)])
    a = psim.run_production(cfg, states, engine=batched)
    b = psim.run_production(cfg, states, engine=loop)
    assert torch.equal(a.series, b.series)
    for k in FIELDS:
        assert torch.equal(getattr(a.final_state, k), getattr(b.final_state, k)), k
    assert pe.resolve_backend(cfg, "cellpair", "cpu") == "cellpair"
    for backend in ("neighbor", "dense"):
        assert pe.resolve_backend(cfg, backend, "cpu") == backend
    assert pe.resolve_backend(cfg, "rows", "cpu") == "rows"
    with pytest.raises(ValueError, match="replicas >= 1"):
        pe._zsort_engine(cfg, "cpu", replicas=0)
