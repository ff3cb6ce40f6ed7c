"""The port's replica ensemble runs (``ljmd_tpu_torch/parallel/ensemble.py``)
on the CPU, float64 unless named, at small sizes: the batched rows engine
against one-replica runs, the batched zsort engine and the replica loop of
the other engines (cellpair, neighbor, dense) against one-replica runs, the
streaming ensemble against the in-memory one, and the grouped correlation
stage against the ungrouped one.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.models.engine import (
    _replica_loop_engine,
    make_engine,
    make_replica_engine,
    replica_state,
)
from ljmd_tpu_torch.parallel import ensemble as pens
from ljmd_tpu_torch.stats import correlations as pcorr
from ljmd_tpu_torch.utils import convert

# Small tensors: one intra-op thread per test worker (the suite runs in
# several worker processes at once).
torch.set_num_threads(1)

R = 3


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _small_cfg(**kw):
    base = dict(num_cells=2, box_length=3.6, rc_over_box=0.45, total_steps=200,
                output_interval=10, warmup_steps=50, dt=0.003, dtype="float64",
                target_total_energy=-60.0, seed=5, n_runs=R)
    base.update(kw)
    return SimConfig(**base)


@pytest.mark.parametrize("compensated", [False, True])
def test_batched_engine_equals_one_replica_runs(compensated):
    """Replica i of the batched rows engine's production equals
    run_production of replica i alone: final state bit for bit, the series
    and statistics to the rounding of the batched sums."""
    cfg = _small_cfg(dtype="float32", compensated_sum=True) if compensated else _small_cfg()
    states = psim.initialize_replicas(cfg, psim.replica_generators(cfg.seed, R), backend="rows",
                                      device="cpu")
    res = psim.run_production(cfg, states, backend="rows", device="cpu")
    assert res.series.shape == (R, 5, cfg.n_samples)
    tol = 1e-6 if compensated else 1e-12
    for i in range(R):
        one = psim.run_production(cfg, replica_state(states, i), backend="rows")
        for k in convert.STATE_FIELDS:
            assert torch.equal(getattr(res.final_state, k)[i], getattr(one.final_state, k)), k
        torch.testing.assert_close(res.series[i], one.series, rtol=tol, atol=tol)
        torch.testing.assert_close(res.means.means[i], one.means.means, rtol=tol, atol=tol)
        torch.testing.assert_close(res.corr[i], one.corr, rtol=tol, atol=tol)
        torch.testing.assert_close(res.corr_mean[i], one.corr_mean, rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", ["zsort", "cellpair", "neighbor", "dense"])
def test_replica_loop_equals_one_replica_runs(backend):
    """The replica engine of zsort and the loop over per-replica engines of
    cellpair, neighbor and dense (make_replica_engine batches them: the loop
    is their yardstick): each replica's result is run_production of that
    replica alone, bit for bit."""
    if backend == "zsort":
        jcfg = config_from_density(num_cells=5, density=0.8, dt=0.003, dtype="float64",
                                   total_steps=20, output_interval=5, warmup_steps=10,
                                   target_total_energy=-2300.0)
    else:
        jcfg = config_from_density(num_cells=5, density=0.66, dt=0.002, dtype="float64",
                                   neighbor_skin=0.3, total_steps=30, output_interval=10,
                                   warmup_steps=10, target_total_energy=-2000.0)
    cfg = _port_cfg(jcfg)
    states = psim.initialize_replicas(cfg, psim.replica_generators(3, 2), backend="dense",
                                      device="cpu")
    if backend != "zsort":
        # make_replica_engine batches these: the loop, each replica's
        # engine built (cellpair: sized from its own state) as make_engine
        # builds it
        eng = _replica_loop_engine([make_engine(cfg, backend, "cpu", state=replica_state(states, i),
                                                sample_interval=cfg.output_interval)
                                    for i in range(2)])
    else:
        eng = make_replica_engine(cfg, 2, backend, "cpu", states=states,
                                  sample_interval=cfg.output_interval)
    res = psim.run_production(cfg, states, engine=eng)
    assert res.series.shape == (2, 5, cfg.n_samples)
    # zsort: each one-replica run on an engine built for the stack's
    # temperature (the batched engine's skin is the hottest replica's)
    one_kw = ({"engine": make_engine(cfg, backend, "cpu", state=states,
                                     sample_interval=cfg.output_interval)}
              if backend == "zsort" else {"backend": backend})
    for i in range(2):
        one = psim.run_production(cfg, replica_state(states, i), **one_kw)
        assert torch.equal(res.series[i], one.series)
        assert torch.equal(res.means.means[i], one.means.means)
        for k in convert.STATE_FIELDS:
            assert torch.equal(getattr(res.final_state, k)[i], getattr(one.final_state, k)), k
        for k, v in one.diagnostics.items():
            assert bool(res.diagnostics[k][i]) == bool(v)


def test_streaming_equals_in_memory_ensemble():
    cfg = _small_cfg()
    stats = {}
    streamed = pens.ensemble_simulate_streaming(cfg, backend="rows", device="cpu",
                                                chunk_samples=4, stats=stats)
    agg, res = pens.ensemble_simulate(cfg, backend="rows", device="cpu", keep_per_replica=True)
    assert stats["chunks"] == 4 and stats["corr_group"] == R
    assert isinstance(streamed.series, pens.HostSeries)
    np.testing.assert_array_equal(np.asarray(streamed.series), agg.series.numpy())
    for k in ("replica_means", "replica_stds", "mean_of_means", "std_of_means",
              "corr_mean_runs", "corr_norm_mean_runs", "replica_ok"):
        assert torch.equal(getattr(streamed, k), getattr(agg, k)), k
    one = pens.replica_result(res, 2)
    assert one.series.shape == (5, cfg.n_samples) and one.final_state.r.shape == (cfg.n, 3)
    assert torch.equal(one.means.means, agg.replica_means[2])


@pytest.mark.parametrize("group", [1, 2, R])
def test_grouped_corr_stage_equals_ungrouped(group):
    series = torch.as_tensor(np.random.default_rng(8).normal(size=(R, 5, 40)))
    want = pcorr.autocorr_all(series, 9)
    got = pcorr.grouped(lambda s: pcorr.autocorr_all(s, 9), series, group)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    host = pcorr.grouped(lambda s: pcorr.autocorr_all(torch.as_tensor(s), 9), series.numpy(),
                         group)
    for g, w in zip(host, want):
        assert torch.equal(g, w)
    want = pcorr.block_corr_means(series, 3, 6)
    got = pcorr.grouped(lambda s: pcorr.block_corr_means(s, 3, 6), series, group)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert pcorr.corr_group_size(64, 450, 225, 4) == 32
    assert pcorr.corr_group_size(2, 10, 4, 8, budget=1) == 1
    assert pcorr.corr_group_size(3, 10, 4, 8) == 3
