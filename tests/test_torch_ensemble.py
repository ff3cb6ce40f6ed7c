"""The port's replica ensemble (``ljmd_tpu_torch/parallel/ensemble.py``) and
the replica dimension of kernels 2, 3 and 4 against the JAX package, float64
on the CPU at small sizes.

The JAX package ``vmap``s its kernels and its pipeline; its Pallas kernels
run in interpret mode here (tests/test_torch_ops.py's tiles). The port's
replica launches take (R, 8, n_pad) stacks, whose plain twins run batched on
a CPU tensor; its ensemble starts from JAX's vmapped initial states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.ops.pallas_fused import fused_dense_chunk as j_fused
from ljmd_tpu.ops.pallas_fused import fused_dense_chunk_ext as j_fused_ext
from ljmd_tpu.ops.pallas_lj import pallas_pair_sweep_tri
from ljmd_tpu.parallel import ensemble as jens
from ljmd_tpu.stats.moments import MeansReport as JMeansReport
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.models.engine import replica_state
from ljmd_tpu_torch.ops import fused, pair_sweep
from ljmd_tpu_torch.parallel import ensemble as pens
from ljmd_tpu_torch.state import StepObs
from ljmd_tpu_torch.stats import moments as pmom
from ljmd_tpu_torch.utils import convert

# Small tensors: one intra-op thread per test worker (the suite runs in
# several worker processes at once).
torch.set_num_threads(1)

TILES = dict(tile_i=8, tile_j=128)
R = 3


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _replica_rows(seed, replicas=R, num_cells=3, box=5.13, n_pad=128):
    """R perturbed FCC boxes with velocities as (R, 8, n_pad) numpy rows."""
    rng = np.random.default_rng(seed)
    a = box / num_cells
    grid = np.stack(np.meshgrid(*(np.arange(num_cells),) * 3, indexing="ij"), -1).reshape(-1, 3)
    basis = np.array([[0, 0, 0], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]])
    lattice = ((grid[:, None, :] + basis[None]) * a).reshape(-1, 3)
    n = lattice.shape[0]
    r = np.zeros((replicas, 8, n_pad))
    v = np.zeros((replicas, 8, n_pad))
    for q in range(replicas):
        r[q, 0:3, :n] = np.mod(lattice + rng.normal(scale=0.05 * a, size=lattice.shape), box).T
        vq = rng.uniform(-0.5, 0.5, size=lattice.shape)
        v[q, 0:3, :n] = (vq - vq.mean(axis=0)).T
    return n, box, r, v


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


@pytest.mark.parametrize("want_obs", [True, False])
def test_replica_tri_sweep_matches_vmapped_pallas(want_obs):
    n, box, r, _ = _replica_rows(11)
    rc2 = 6.25
    want = np.asarray(jax.vmap(lambda p: pallas_pair_sweep_tri(
        p, n, box, rc2, interpret=True, want_observables=want_obs, **TILES))(jnp.asarray(r)))
    got = pair_sweep.pair_sweep_tri(_t(r), n, box, rc2, want_observables=want_obs).numpy()
    assert got.shape == r.shape
    for row in range(6):
        np.testing.assert_allclose(got[:, row], want[:, row], rtol=1e-10, atol=1e-12,
                                   err_msg=f"row {row}")
    np.testing.assert_array_equal(got[:, 6:], 0.0)
    np.testing.assert_array_equal(got[:, :, n:], 0.0)


@pytest.mark.parametrize("extended", [False, True])
def test_replica_chunks_match_vmapped_pallas(extended):
    n, box, r, v = _replica_rows(12)
    rc2, dt, steps = 6.25, 0.004, 25
    a = 24.0 * pair_sweep.pair_forces_plain(_t(r), n, box, rc2).numpy()
    if not extended:
        want = jax.vmap(lambda r_, v_, a_: j_fused(r_, v_, a_, n, box, rc2, dt, steps,
                                                  interpret=True, **TILES))(
            *(jnp.asarray(x) for x in (r, v, a)))
        got = fused.fused_dense_chunk(_t(r), _t(v), _t(a), n, box, rc2, dt, steps)
        for name, g, w in zip(("r", "v", "a"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10,
                                       err_msg=name)
            np.testing.assert_array_equal(g.numpy()[:, 3:], 0.0)
        return
    rng = np.random.default_rng(13)
    lo, vc = np.zeros_like(r), np.zeros_like(v)
    lo[:, 0:3, :n] = rng.normal(scale=1e-9, size=(R, 3, n))
    vc[:, 0:3, :n] = rng.normal(scale=1e-9, size=(R, 3, n))
    want = jax.vmap(lambda *x: j_fused_ext(*x, n, box, rc2, dt, steps, interpret=True, **TILES))(
        *(jnp.asarray(x) for x in (r, lo, v, vc, a)))
    got = fused.fused_dense_chunk_ext(*(_t(x) for x in (r, lo, v, vc, a)), n, box, rc2, dt, steps)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    for name, (hi, low) in (("r + r_lo", (0, 1)), ("v + vc", (2, 3))):
        np.testing.assert_allclose(got[hi] + got[low], want[hi] + want[low],
                                   rtol=1e-10, atol=1e-10, err_msg=name)
        np.testing.assert_allclose(got[low], want[low], rtol=0, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-10, atol=1e-10, err_msg="a")


def test_replica_twins_equal_one_replica_twins():
    """Replica q of a batched twin is the one-replica twin on replica q."""
    n, box, r, v = _replica_rows(14)
    r, v = _t(r), _t(v)
    a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, 6.25)
    batched = (pair_sweep.pair_sweep_tri(r, n, box, 6.25),
               *fused.fused_dense_chunk(r, v, a, n, box, 6.25, 0.004, 5))
    for q in range(R):
        alone = (pair_sweep.pair_sweep_tri(r[q], n, box, 6.25),
                 *fused.fused_dense_chunk(r[q], v[q], a[q], n, box, 6.25, 0.004, 5))
        for g, w in zip(batched, alone):
            torch.testing.assert_close(g[q], w, rtol=1e-14, atol=1e-14)


def _jax_cfg(**kw):
    base = dict(num_cells=2, density=0.7, dt=0.003, dtype="float64", total_steps=200,
                output_interval=10, warmup_steps=40, target_total_energy=-60.0,
                corr_max_lag_cap=4, corr_max_blocks=2, seed=4)
    base.update(kw)
    return config_from_density(**base)


def test_ensemble_matches_jax_from_its_initial_states():
    """The port's ensemble production (the rows engine batched over 3
    replicas) from JAX's vmapped initial states against JAX's
    ensemble_simulate on the rows engine (Pallas in interpret mode), at
    tests/test_torch_simulation.py's tolerances."""
    jcfg = _jax_cfg()
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed), R)
    jstates = jax.vmap(lambda k: j_initialize(jcfg, k, backend="pallas"))(keys)
    want, wres = jens.ensemble_simulate(jcfg, n_replicas=R, backend="pallas", jit=False,
                                        keep_per_replica=True)
    pcfg = _port_cfg(jcfg)
    states = convert.state_from_numpy({k: np.asarray(getattr(jstates, k))
                                       for k in convert.STATE_FIELDS})
    assert states.r.shape == (R, pcfg.n, 3)
    res = psim.run_production(pcfg, states, backend="rows", device="cpu")
    got = pens.ensemble_aggregate(pcfg, res)

    np.testing.assert_allclose(res.series.numpy(), np.asarray(wres.series), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got.replica_means.numpy(), np.asarray(want.replica_means),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.replica_stds.numpy(), np.asarray(want.replica_stds),
                               rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got.mean_of_means.numpy(), np.asarray(want.mean_of_means),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.std_of_means.numpy(), np.asarray(want.std_of_means),
                               rtol=1e-6, atol=1e-9)
    for k in ("corr", "corr_norm", "corr_mean", "corr_mean_norm"):
        np.testing.assert_allclose(getattr(res, k).numpy(), np.asarray(getattr(wres, k)),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    for k in ("corr_mean_runs", "corr_norm_mean_runs"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    for k, v in want.thermo.as_dict().items():
        np.testing.assert_allclose(getattr(got.thermo, k).numpy(), np.asarray(v), rtol=1e-7,
                                   err_msg=k)
    assert int(got.n_ok) == int(want.n_ok) == R
    for k in convert.STATE_FIELDS:
        np.testing.assert_allclose(getattr(res.final_state, k).numpy(),
                                   np.asarray(getattr(wres.final_state, k)),
                                   rtol=1e-9, atol=1e-9, err_msg=f"final_state.{k}")


def test_aggregate_matches_jax_with_a_poisoned_replica():
    """ensemble_aggregate on the same numbers as JAX's (tests/test_examples.py's
    divergence check): replica 1's means poisoned with NaN, excluded from
    the cross-run statistics and the averaged ACFs."""
    rng = np.random.default_rng(7)
    means = rng.normal(size=(4, 11)) + np.arange(1.0, 12.0)
    stds = np.abs(rng.normal(size=(4, 11)))
    means[1, 3] = np.nan
    corr, corr_norm = rng.normal(size=(2, 4, 5, 6))
    corr[2, 1, 4] = np.inf
    series = rng.normal(size=(4, 5, 12))
    cfg = _jax_cfg()
    count = np.full((4,), 12.0)
    want = jens.ensemble_aggregate(cfg, jens.ReplicaStats(
        means=JMeansReport(count=jnp.asarray(count), means=jnp.asarray(means),
                           stds=jnp.asarray(stds)),
        corr=jnp.asarray(corr), corr_norm=jnp.asarray(corr_norm), series=series))
    got = pens.ensemble_aggregate(_port_cfg(cfg), pens.ReplicaStats(
        means=pmom.MeansReport(count=_t(count), means=_t(means), stds=_t(stds)),
        corr=_t(corr), corr_norm=_t(corr_norm), series=pens.HostSeries(series)))
    np.testing.assert_array_equal(got.replica_ok.numpy(), np.asarray(want.replica_ok))
    assert int(got.n_ok) == 3
    for k in ("mean_of_means", "std_of_means", "corr_mean_runs", "corr_norm_mean_runs"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-12, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(got.mean_of_means.numpy(), means[[0, 2, 3]].mean(axis=0),
                               rtol=1e-12)
    for k, v in want.thermo.as_dict().items():
        np.testing.assert_allclose(getattr(got.thermo, k).numpy(), np.asarray(v), rtol=1e-12,
                                   err_msg=k)
    named = got.named_cross_run()
    assert list(named) == list(pmom.OBSERVABLES)
    assert float(named["epot"][0]) == float(got.mean_of_means[0])
    assert np.asarray(got.series).shape == (4, 5, 12) and len(got.series) == 4


def _small_cfg(**kw):
    base = dict(num_cells=2, box_length=3.6, rc_over_box=0.45, total_steps=200,
                output_interval=10, warmup_steps=50, dt=0.003, dtype="float64",
                target_total_energy=-60.0, seed=5, n_runs=R)
    base.update(kw)
    return SimConfig(**base)


def test_replica_generators_give_initialize_states():
    """The per-replica rule: replica i of the batched initialize is
    initialize(cfg, generator_i), and generator_i does not depend on R."""
    cfg = _small_cfg()
    gens = psim.replica_generators(cfg.seed, R)
    states = psim.initialize_replicas(cfg, gens, backend="rows", device="cpu")
    for i in range(R):
        one = psim.initialize(cfg, psim.replica_generators(cfg.seed, R + 2)[i], backend="rows",
                              device="cpu")
        for k in convert.STATE_FIELDS:
            torch.testing.assert_close(getattr(states, k)[i], getattr(one, k), rtol=1e-12,
                                       atol=1e-12)
    a, b = (torch.rand(4, generator=g) for g in psim.replica_generators(-12345, 2))
    assert not torch.equal(a, b)
    loop = psim.initialize_replicas(cfg, psim.replica_generators(cfg.seed, R), backend="dense",
                                    device="cpu")
    torch.testing.assert_close(loop.v, states.v, rtol=1e-9, atol=1e-9)


def _old_moments(obs_list, n, volume):
    """The unbatched statistics as they stood before the replica axis."""
    acc = (torch.zeros((), dtype=torch.float64), torch.zeros((2, 11), dtype=torch.float64),
           torch.zeros((11,), dtype=torch.float64))
    for ob in obs_list:
        temp, press = pmom.instantaneous_temp_press(ob, n, volume)
        ekin_inv = 1.0 / ob.ekin
        du, ddu = ob.d_epot, ob.dd_epot
        x = torch.stack([ob.epot, ob.ekin, ob.epot + ob.ekin, temp, press, ekin_inv, du, ddu,
                         du * ekin_inv, du * du * ekin_inv, ddu * ekin_inv])
        count, moments, shift = acc
        shift = torch.where(count == 0, x, shift)
        dx = x - shift
        acc = (count + 1, moments + torch.stack([dx, dx * dx]), shift)
    count, moments, shift = acc
    inv_n = 1.0 / count
    dmean = moments[0] * inv_n
    var = torch.clamp(moments[1] * inv_n - dmean * dmean, min=0.0)
    return shift + dmean, torch.sqrt(var)


def test_single_run_statistics_keep_their_bits():
    """One system's statistics (0-d observables) give the bits they gave
    before the replica axis; a replica batch gives each replica's."""
    rng = np.random.default_rng(9)
    obs = [StepObs(*(torch.tensor(x) for x in (rng.normal(-300, 5), rng.uniform(150, 160),
                                              rng.normal(300, 20), rng.normal(2e4, 300))))
           for _ in range(25)]
    acc = pmom.means_init(dtype=torch.float64)
    for ob in obs:
        acc = pmom.means_update(acc, ob, 108, 216.0)
    report = pmom.means_finalize(acc)
    want_means, want_stds = _old_moments(obs, 108, 216.0)
    assert report.means.shape == (11,)
    assert torch.equal(report.means, want_means) and torch.equal(report.stds, want_stds)
    batch = pmom.means_init(dtype=torch.float64, batch=(2,))
    for ob in obs:
        pair = StepObs(*(torch.stack([x, 2 * x]) for x in (ob.epot, ob.ekin, ob.d_epot,
                                                            ob.dd_epot)))
        batch = pmom.means_update(batch, pair, 108, 216.0)
    both = pmom.means_finalize(batch)
    assert both.means.shape == (2, 11)
    torch.testing.assert_close(both.means[0], want_means, rtol=1e-15, atol=0)


def test_replica_states_convert_both_ways():
    rng = np.random.default_rng(10)
    arrays = {k: rng.normal(size=(R, 32, 3)) for k in convert.STATE_FIELDS}
    states = convert.state_from_numpy(arrays)
    assert states.r.shape == (R, 32, 3)
    back = convert.state_to_numpy(states)
    for k in convert.STATE_FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])
        np.testing.assert_array_equal(getattr(replica_state(states, 1), k).numpy(), arrays[k][1])
    with pytest.raises(ValueError, match="3"):
        convert.state_from_numpy({k: v[..., :2] for k, v in arrays.items()})
