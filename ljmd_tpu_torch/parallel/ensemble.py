"""Ensemble mode: R independent replicas of one config on one card, with
cross-run aggregation (counterpart of ``ljmd_tpu/parallel/ensemble.py``).

Rebuild of the reference's run-many subsystem
(``scripts/run_many_md_simuations/``): its serial loop over runs
(run_many_md.f90:57-82) becomes one batched run over a leading replica axis,
each replica with its own random stream (``simulation.replica_generators``:
replica i's CPU generator seeded from ``numpy.random.SeedSequence(seed)``'s
i-th child), and the aggregator (simulation_results) an in-memory reduction
over that axis. Per-replica coefficients use the canonical formulas.

The JAX package ``vmap``s the whole pipeline, which gives each Pallas kernel
a replica grid axis. Here:

- where the backend resolves to the rows engine (config 4, L < 4 rc: ``auto``
  picks rows), the replicas run batched: (R, N, 3) states, the rows engine
  with ``replicas=R`` (``models/engine.py``), whose tri sweeps (kernel 2) and
  fused chunks (kernels 3 and 4) are ONE launch for all R replicas, each
  replica's rows bit for bit what a one-system run gives it;
- so do they on the zsort engine (the N=864 ensemble: ``auto`` picks zsort
  on the card) with ``replicas=R``: its visit-list packs (kernel 9) and
  list chunks (kernel 10) are one launch for all R, each replica over its own
  sorted order and lists;
- and on the cell-pair engine (config 5's fluid: ``auto`` picks cellpair on
  the card at N >= 8192), one flat stack of R pencil grids at one capacity:
  its sampled sweeps (kernel 13) and fused chunks (kernels 15 and 16) are
  one launch for all R;
- and on the neighbor and dense engines, plain torch over the (R, N, 3)
  stack: (R, N, N) pair matrices (dense) or (R, N, K) lists (neighbor), one
  host read a step of whether any replica's list needs a rebuild, each
  replica keeping its rebuilt or old list by its own flag (JAX's vmap of
  ``lax.cond``).

Replica q's trajectory is what a one-system run gives it (the (R,) sums of
the observables may round otherwise); ``_replica_loop_engine`` of R
one-system engines stays the yardstick.

``ensemble_simulate(..., mesh=)`` splits the replicas over a mesh's replica
axis (``parallel/mesh.py``, the JAX package's ``P(REPLICA_AXIS)`` sharding):
each rank runs its row's R / r replicas as above on its device (the ranks of
a row, along the particle axis, each run the row's replicas, as JAX's
particle axis does not split replicas), and the results are gathered in
replica order: each replica's result is what the unsharded run gives it.

``ensemble_simulate_streaming`` moves the sampled series to the host after
each chunk of samples and runs the correlation stage over groups of
replicas (``CORR_GROUP_BYTES``), so neither the (R, 5, n_samples) series nor
the lag products of all R replicas sit on the card at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models.engine import (
    _effective_dtype,
    make_replica_engine,
    replica_state,
    resolve_device,
)
from ljmd_tpu_torch.models.simulation import (
    SimResult,
    _advance,
    _cadence,
    initialize_replicas,
    replica_generators,
    run_production,
    sample_cycle,
)
from ljmd_tpu_torch.parallel.mesh import REPLICA_AXIS
from ljmd_tpu_torch.state import MDState
from ljmd_tpu_torch.stats.correlations import (
    CORR_GROUP_BYTES,
    autocorr_all,
    corr_group_size,
    grouped,
)
from ljmd_tpu_torch.stats.moments import OBSERVABLES, MeansReport, means_finalize, means_init
from ljmd_tpu_torch.stats.thermo import ThermoCoefs, thermo_coefs_from_report

__all__ = [
    "CORR_GROUP_BYTES",
    "EnsembleResult",
    "HostSeries",
    "ReplicaStats",
    "ensemble_aggregate",
    "ensemble_simulate",
    "ensemble_simulate_streaming",
    "replica_result",
]


class HostSeries:
    """Host-resident (R, 5, n_samples) sampled series of the streaming
    ensemble: a numpy array that ``np.asarray``, ``.shape`` and indexing
    read as it is."""

    __slots__ = ("array",)

    def __init__(self, array):
        self.array = np.asarray(array)

    def __array__(self, dtype=None, copy=None):
        if dtype is None and not copy:
            return self.array
        return np.asarray(self.array, dtype=dtype)

    @property
    def shape(self):
        return self.array.shape

    @property
    def dtype(self):
        return self.array.dtype

    def __getitem__(self, idx):
        return self.array[idx]

    def __len__(self):
        return len(self.array)

    def __repr__(self):
        return f"HostSeries(shape={self.array.shape}, dtype={self.array.dtype})"


@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """Per-replica results and cross-run aggregates.

    replica_means / replica_stds: (R, 11) per-replica time-average means /
    stds (ordered as stats.moments.OBSERVABLES). mean_of_means /
    std_of_means: (11,) cross-run statistics over the replicas that are ok
    (the simulation_results.txt content). thermo: ThermoCoefs with (R,)
    fields. corr_mean_runs / corr_norm_mean_runs: (5, max_lag+1) ACFs
    averaged over the replicas that are ok (each replica an independent
    block)."""

    replica_means: torch.Tensor
    replica_stds: torch.Tensor
    mean_of_means: torch.Tensor
    std_of_means: torch.Tensor
    thermo: ThermoCoefs
    series: object          # (R, 5, n_samples): a tensor, or HostSeries when streamed
    replica_ok: torch.Tensor  # (R,) bool: the replica's means and stds are finite
    corr_mean_runs: torch.Tensor
    corr_norm_mean_runs: torch.Tensor

    def named_cross_run(self) -> dict:
        return {name: (self.mean_of_means[i], self.std_of_means[i])
                for i, name in enumerate(OBSERVABLES)}

    @property
    def n_ok(self) -> torch.Tensor:
        return torch.sum(self.replica_ok)


@dataclasses.dataclass(frozen=True)
class ReplicaStats:
    """What ``ensemble_aggregate`` needs of a run, as the streaming ensemble
    produces it: batched means (fields (R, 11)), corr and corr_norm (R, 5,
    max_lag+1), and the series (a HostSeries)."""

    means: MeansReport
    corr: torch.Tensor
    corr_norm: torch.Tensor
    series: object


def ensemble_simulate(cfg: SimConfig, n_replicas: Optional[int] = None,
                      seed: Optional[int] = None, backend: str = "auto", device="cuda",
                      keep_per_replica: bool = False, mesh=None):
    """Run ``n_replicas`` (default cfg.n_runs) independent simulations on
    ``device`` and aggregate them: ``initialize_replicas`` from
    ``replica_generators(seed or cfg.seed, R)``, then ``run_production`` of
    the (R, N, 3) states, which takes given initial states as well (module
    docstring: batched on every backend's engine). With ``mesh``
    (``parallel/mesh.py``) the replicas split over its replica axis, each
    rank's on the mesh's device (module docstring).
    With ``keep_per_replica=True`` returns (EnsembleResult, batched
    SimResult), for per-run artifacts (``replica_result``)."""
    r = cfg.n_runs if n_replicas is None else int(n_replicas)
    gens = replica_generators(cfg.seed if seed is None else seed, r)
    if mesh is None:
        states = initialize_replicas(cfg, gens, backend=backend, device=device)
        results = run_production(cfg, states, backend=backend, device=device)
    else:
        results = _on_mesh(cfg, gens, backend, mesh)
    agg = ensemble_aggregate(cfg, results)
    return (agg, results) if keep_per_replica else agg


def _on_mesh(cfg: SimConfig, gens: list, backend: str, mesh) -> SimResult:
    """The batched SimResult of the replicas of ``gens`` split over the
    mesh's replica axis: row q runs replicas [q R/r, (q + 1) R/r)."""
    if len(gens) % mesh.replica:
        raise ValueError(f"{len(gens)} replicas not divisible by replica-axis size "
                         f"{mesh.replica}")
    per = len(gens) // mesh.replica

    def rank(comm, row_gens):
        states = initialize_replicas(cfg, row_gens, backend=backend, device=comm.device)
        return run_production(cfg, states, backend=backend, device=comm.device)

    parts = mesh.run(rank, [gens[q * per:(q + 1) * per] for q, _ in mesh.coords])

    def join(get):
        return mesh.gather([get(p) for p in parts], 0, REPLICA_AXIS)

    first = parts[0]
    return dataclasses.replace(
        first,
        final_state=MDState(*(join(lambda p, k=k: getattr(p.final_state, k))
                              for k in ("r", "ru", "v", "a"))),
        series=join(lambda p: p.series),
        means=MeansReport(*(join(lambda p, k=k: getattr(p.means, k))
                            for k in ("count", "means", "stds"))),
        corr=join(lambda p: p.corr), corr_norm=join(lambda p: p.corr_norm),
        corr_mean=join(lambda p: p.corr_mean), corr_mean_norm=join(lambda p: p.corr_mean_norm),
        frames=None,
        diagnostics={k: join(lambda p, k=k: torch.as_tensor(p.diagnostics[k]))
                     for k in first.diagnostics},
        counters={k: join(lambda p, k=k: p.counters[k]) for k in first.counters})


def replica_result(results: SimResult, i: int) -> SimResult:
    """Replica ``i``'s SimResult out of a batched one (``times`` is shared)."""
    m = results.means
    return dataclasses.replace(
        results,
        final_state=replica_state(results.final_state, i),
        series=results.series[i],
        means=MeansReport(count=m.count[i], means=m.means[i], stds=m.stds[i]),
        corr=results.corr[i], corr_norm=results.corr_norm[i],
        corr_mean=results.corr_mean[i], corr_mean_norm=results.corr_mean_norm[i],
        frames=None,
        diagnostics={k: v[i] for k, v in results.diagnostics.items()},
        counters={k: v[i] for k, v in results.counters.items()},
    )


def ensemble_aggregate(cfg: SimConfig, results) -> EnsembleResult:
    """Cross-run reduction over the leading replica axis of a batched
    SimResult or a ReplicaStats. A replica whose means or stds are not
    finite (an NVE blow-up) is excluded from the cross-run statistics and
    the averaged ACFs, as the reference's aggregation skips failed runs
    (run_many_md.f90:76-80)."""
    means = results.means.means  # (R, 11)
    stds = results.means.stds
    ok = torch.isfinite(means).all(dim=1) & torch.isfinite(stds).all(dim=1)
    w = ok.to(means.dtype)[:, None]
    n_ok = torch.clamp(torch.sum(w), min=1.0)
    safe = torch.where(torch.isfinite(means), means, torch.zeros_like(means))
    mean_of_means = torch.sum(safe * w, dim=0) / n_ok
    var = torch.sum(((safe - mean_of_means) ** 2) * w, dim=0) / n_ok
    thermo = thermo_coefs_from_report(cfg.n, cfg.volume, results.means)
    wc = w[:, :, None]

    def runs_mean(c):
        return torch.sum(torch.where(torch.isfinite(c), c, torch.zeros_like(c)) * wc,
                         dim=0) / n_ok

    return EnsembleResult(
        replica_means=means, replica_stds=stds, mean_of_means=mean_of_means,
        std_of_means=torch.sqrt(var), thermo=thermo, series=results.series, replica_ok=ok,
        corr_mean_runs=runs_mean(results.corr), corr_norm_mean_runs=runs_mean(results.corr_norm),
    )


def ensemble_simulate_streaming(cfg: SimConfig, n_replicas: Optional[int] = None,
                                seed: Optional[int] = None, backend: str = "auto",
                                device="cuda", chunk_samples: int = 32,
                                stats: Optional[dict] = None) -> EnsembleResult:
    """``ensemble_simulate`` with the sampled (R, 5, k) series moved to the
    host (float64) after every ``chunk_samples`` samples, so only the means
    accumulators and the engine carry stay on the card while stepping; the
    result's ``series`` is a HostSeries. The correlation stage then runs
    over groups of ``corr_group_size`` replicas (each group copied to the
    card in the run's dtype), so at most CORR_GROUP_BYTES of lag products
    exist at once. The same sample cycles as the in-memory run (series and
    means equal), and the same grouped correlation stage as its
    ``finalize``.

    ``stats``, if given, receives the chunks, the group size, the bytes the
    groups' lag products take and, on a CUDA device, the correlation
    stage's peak of ``torch.cuda.max_memory_allocated`` over what was
    allocated before it (``corr_peak_bytes``)."""
    r = cfg.n_runs if n_replicas is None else int(n_replicas)
    prologue, n_samples, _ = _cadence(cfg)
    if n_samples == 0:
        raise ValueError("no samples would be taken")
    device = resolve_device(device)
    dtype = _effective_dtype(cfg)
    gens = replica_generators(cfg.seed if seed is None else seed, r)
    states = initialize_replicas(cfg, gens, backend=backend, device=device)
    engine = make_replica_engine(cfg, r, backend, device, states=states,
                                 sample_interval=cfg.output_interval)
    ec, _ = engine.init(states)
    ec, _ = _advance(engine, ec, prologue, want_obs=False)
    acc = means_init(dtype=dtype, device=device, batch=(r,))

    blocks = []
    done = 0
    while done < n_samples:
        k = min(chunk_samples, n_samples - done)
        cols = []
        for _ in range(k):
            ec, acc, col = sample_cycle(engine, cfg, ec, acc)
            cols.append(col)
        blocks.append(torch.stack(cols, dim=-1).to("cpu", torch.float64).numpy())
        done += k
    series_host = np.concatenate(blocks, axis=2)  # (R, 5, n_samples)
    report = means_finalize(acc)

    max_lag = cfg.corr_max_lag
    itemsize = torch.empty((), dtype=dtype).element_size()
    group = corr_group_size(r, n_samples, max_lag, itemsize, CORR_GROUP_BYTES)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    if max_lag >= 1:
        corr, corr_norm = grouped(
            lambda s: autocorr_all(torch.as_tensor(s, dtype=dtype, device=device), max_lag),
            series_host, group)
    else:
        corr = torch.zeros((r, 5, 1), dtype=dtype, device=device)
        corr_norm = torch.zeros_like(corr)
    if stats is not None:
        stats.update(chunks=len(blocks), chunk_samples=chunk_samples, corr_group=group,
                     corr_group_bytes=group * 5 * (max_lag + 1) * n_samples * itemsize)
        if cuda:
            torch.cuda.synchronize(device)
            stats["corr_peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    return ensemble_aggregate(cfg, ReplicaStats(means=report, corr=corr, corr_norm=corr_norm,
                                                series=HostSeries(series_host)))
