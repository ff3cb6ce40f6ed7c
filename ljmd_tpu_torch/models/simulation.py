"""End-to-end drivers: initialization and production run (counterpart of
``ljmd_tpu/models/simulation.py``).

- ``initialize`` <-> ``scripts/md_initial_config_program.f90`` (:58-121):
  FCC lattice -> velocities -> COM removal -> initial forces -> rescale to
  the target energy -> warmup; returns the ``rv_init.dat`` state.
- ``run_production`` / ``simulate`` <-> ``scripts/md_simulation_program.f90``
  (:196-560): Verlet production with unwrap tracking, sampling at
  ``(step > warmup) and (step % interval == 0)``, streaming means, series,
  optional frames, ACF + block-averaged ACF, thermodynamic coefficients.

PyTorch runs eagerly, so the JAX package's ``lax.scan`` over samples is a
Python loop over sample cycles; each cycle is ``run_sample(interval)`` where
the engine has one (zsort: fused chunks, the last one summing the sampled
step's observables), else ``run_fast(interval - 1)`` (one fused kernel launch
per <= 256 steps on the card) followed by one observable ``step``. Nothing
in the loop waits for the device: statistics accumulate in device tensors. The cadence is exact for any (total, warmup,
interval) through a prologue / epilogue split, including
``warmup % interval != 0``.

Replica ensembles: ``initialize_replicas`` builds R initial states, one per
CPU generator (``replica_generators``), and ``run_production`` given (R, N,
3) states runs them on ``make_replica_engine``'s engine (every backend's
engine batched over the replicas): series
(R, 5, n_samples), means (R, 11), correlations (R, 5, max_lag+1). The
drivers and the statistics take the leading replica axis as it is; on one
system they compute what they did before, op for op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models.engine import (
    Engine,
    _effective_dtype,
    make_engine,
    make_replica_engine,
    resolve_backend,
    resolve_device,
)
from ljmd_tpu_torch.models.lattice import (
    fcc_lattice,
    random_velocities,
    remove_com_velocity,
    rescale_to_target_energy,
)
from ljmd_tpu_torch.state import MDState
from ljmd_tpu_torch.stats.correlations import (
    autocorr_all,
    block_corr_means,
    corr_group_size,
    grouped,
)
from ljmd_tpu_torch.stats.moments import (
    MeansAccum,
    MeansReport,
    instantaneous_temp_press,
    means_finalize,
    means_init,
    means_update,
)
from ljmd_tpu_torch.stats.thermo import ThermoCoefs, thermo_coefs_from_report
from ljmd_tpu_torch.utils.profiling import span

__all__ = [
    "SERIES_OBSERVABLES",
    "Frames",
    "SimResult",
    "sample_steps",
    "initialize",
    "initialize_replicas",
    "replica_generators",
    "run_production",
    "sample_cycle",
    "finalize",
    "simulate",
]

# Order of the sampled series: the columns of instantaneous_energies.dat
# ("time epot ekin etot T P", md_simulation_program.f90:294).
SERIES_OBSERVABLES = ("epot", "ekin", "etot", "temp", "press")


@dataclasses.dataclass(frozen=True)
class Frames:
    """Sampled frames, each (n_samples, N, 3): the rva.dat records
    (md_simulation_program.f90:384-387)."""

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor


@dataclasses.dataclass(frozen=True)
class SimResult:
    """Everything the reference's production driver emits, as tensors on
    the run's device (an ensemble's: every field but ``times`` with a
    leading replica axis)."""

    final_state: MDState
    times: torch.Tensor       # (n_samples,) sample times step*dt
    series: torch.Tensor      # (5, n_samples) rows ordered as SERIES_OBSERVABLES
    means: MeansReport        # 11 means + stds
    corr: torch.Tensor        # (5, max_lag+1) centered ACF
    corr_norm: torch.Tensor   # (5, max_lag+1) ACF normalized by C(0)
    corr_mean: torch.Tensor   # (5, max_lag+1) block-averaged ACF
    corr_mean_norm: torch.Tensor
    frames: Optional[Frames]
    diagnostics: dict
    counters: dict = dataclasses.field(default_factory=dict)  # the engine's ``counters``

    def thermo(self, cfg: SimConfig) -> ThermoCoefs:
        return thermo_coefs_from_report(cfg.n, cfg.volume, self.means)


def sample_steps(cfg: SimConfig) -> np.ndarray:
    """Absolute step indices at which the reference samples: multiples of
    output_interval in (warmup, total]."""
    first = (cfg.warmup_steps // cfg.output_interval + 1) * cfg.output_interval
    last = (cfg.total_steps // cfg.output_interval) * cfg.output_interval
    if first > last:
        return np.zeros((0,), dtype=np.int64)
    return np.arange(first, last + 1, cfg.output_interval, dtype=np.int64)


def _cadence(cfg: SimConfig):
    """(prologue, n_samples, epilogue): un-sampled steps before the first
    sample cycle (warmup included), number of interval-sized sampled
    cycles, and trailing un-sampled steps after the last sample."""
    steps = sample_steps(cfg)
    n_samples = len(steps)
    if n_samples == 0:
        return cfg.total_steps, 0, 0
    prologue = int(steps[0]) - cfg.output_interval
    epilogue = cfg.total_steps - int(steps[-1])
    return prologue, n_samples, epilogue


def _advance(engine: Engine, carry, n_steps: int, want_obs: bool = True):
    """Advance n_steps, returning the final carry and the observables of the
    LAST step (None when ``want_obs`` is False or n_steps == 0). The first
    n_steps - 1 steps (all of them without ``want_obs``) run observable-free,
    in fused chunks when the engine has ``run_fast``; with ``run_sample`` the
    observable step is fused too."""
    if n_steps == 0:
        return carry, None
    if want_obs and engine.run_sample is not None:
        return engine.run_sample(carry, n_steps)
    n_fast = n_steps - 1 if want_obs else n_steps
    if n_fast > 0:
        if engine.run_fast is not None:
            carry = engine.run_fast(carry, n_fast)
        else:
            fast = engine.step_fast or engine.step
            for _ in range(n_fast):
                carry, _ = fast(carry)
    if not want_obs:
        return carry, None
    return engine.step(carry)


def initialize(
    cfg: SimConfig,
    generator: Optional[torch.Generator] = None,
    backend: str = "auto",
    velocity_init: str = "generator",
    device="cuda",
) -> MDState:
    """Initial-configuration pipeline (md_initial_config_program.f90:58-121).

    Returns the post-warmup state on ``device`` (default the card; raises
    where there is none, ``device="cpu"`` runs the kernels' plain twins):
    positions of the
    equilibrated fluid, velocities rescaled so E_tot == target at the
    rescale point, accelerations consistent with positions, ru = r.

    ``velocity_init``: "generator" (default; uniform draws from ``generator``,
    a CPU ``torch.Generator`` seeded with ``cfg.seed`` when None) or "ran3"
    (the reference's exact subtractive-RNG stream seeded with ``cfg.seed``,
    bit-exact, utils/ran3.py).
    """
    device = resolve_device(device)
    dtype = _effective_dtype(cfg)
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=dtype, device=device)
    if velocity_init == "ran3":
        from ljmd_tpu_torch.utils.ran3 import reference_initial_velocities

        v = torch.as_tensor(reference_initial_velocities(cfg.n, seed=cfg.seed),
                            dtype=dtype, device=device)
    elif velocity_init == "generator":
        if generator is None:
            generator = torch.Generator().manual_seed(cfg.seed)
        v = random_velocities(generator, cfg.n, dtype=dtype, device=device)
    else:
        raise ValueError(f"unknown velocity_init {velocity_init!r}")
    v = remove_com_velocity(v)

    engine = make_engine(cfg, backend, device)
    state = MDState(r=r, ru=r, v=v, a=torch.zeros_like(r))
    carry, obs = engine.init(state)
    state = engine.get_state(carry)

    v = rescale_to_target_energy(state.v, obs.epot, cfg.target_total_energy)
    state = MDState(r=state.r, ru=state.ru, v=v, a=state.a)

    if cfg.warmup_steps > 0:
        # The warmup's engine is built for the rescaled state, as
        # production's is for its start (the cell-pair capacity and fused
        # chunk, the zsort skin: a hot lattice needs shorter chunks).
        engine = make_engine(cfg, backend, device, state=state)
        carry, _ = engine.init(state)
        carry, _ = _advance(engine, carry, cfg.warmup_steps, want_obs=False)
        state = engine.get_state(carry)
    # Production starts its own MSD clock with ru(0) = r(0)
    # (md_simulation_program.f90:229-231).
    return MDState(r=state.r, ru=state.r, v=state.v, a=state.a)


def run_production(
    cfg: SimConfig,
    state: MDState,
    backend: str = "auto",
    record_frames: bool = False,
    engine: Optional[Engine] = None,
    device=None,
) -> SimResult:
    """Production run (md_simulation_program.f90:300-391 + finalization) on
    ``device`` (default: the device ``state`` lives on). Pass ``engine`` to
    supply a pre-built Engine instead of ``backend``. An (R, N, 3) ``state``
    runs R replicas on ``make_replica_engine``'s engine."""
    device = resolve_device(state.device if device is None else device)
    batch = tuple(state.r.shape[:-2])
    if engine is None and batch:
        engine = make_replica_engine(cfg, batch[0], backend, device, states=state,
                                     sample_interval=cfg.output_interval)
    engine = engine or make_engine(cfg, backend, device, state=state,
                                   sample_interval=cfg.output_interval)
    prologue, n_samples, epilogue = _cadence(cfg)
    if n_samples == 0:
        raise ValueError(
            "no samples would be taken (check warmup_steps/output_interval/"
            "total_steps) — the reference aborts too (md_simulation_program.f90:399)"
        )
    dtype = _effective_dtype(cfg)

    # t=0 forces (md_simulation_program.f90:236)
    ecarry, _ = engine.init(state)
    ecarry, _ = _advance(engine, ecarry, prologue, want_obs=False)

    acc = means_init(dtype=dtype, device=device, batch=batch)
    series_cols = []
    frame_states = []
    for _ in range(n_samples):
        ecarry, acc, col = sample_cycle(engine, cfg, ecarry, acc)
        series_cols.append(col)
        if record_frames:
            frame_states.append(engine.get_state(ecarry))

    ecarry, _ = _advance(engine, ecarry, epilogue, want_obs=False)
    frames = None
    if record_frames:
        frames = Frames(*(torch.stack([getattr(s, k) for s in frame_states])
                          for k in ("r", "ru", "v", "a")))
    return finalize(cfg, engine, ecarry, torch.stack(series_cols, dim=-1), acc, frames)


def sample_cycle(engine: Engine, cfg: SimConfig, ecarry, acc: MeansAccum):
    """One sampled cycle of the production loop, the same calls in the same
    order for ``run_production`` and the streaming driver (so their series
    agree bit for bit): ``output_interval`` steps, the last with
    observables, then the means and the series column
    (md_simulation_program.f90:300-391). Returns (carry, means, (5,) column
    ordered as SERIES_OBSERVABLES; an ensemble's (R, 5))."""
    ecarry, ob = _advance(engine, ecarry, cfg.output_interval)
    with span("ljmd.driver.stats"):
        acc = means_update(acc, ob, cfg.n, cfg.volume)
        temp, press = instantaneous_temp_press(ob, cfg.n, cfg.volume)
        col = torch.stack([ob.epot, ob.ekin, ob.epot + ob.ekin, temp, press], dim=-1)
    return ecarry, acc, col


def finalize(cfg: SimConfig, engine: Engine, ecarry, series: torch.Tensor, acc: MeansAccum,
             frames: Optional[Frames]) -> SimResult:
    """The statistics of a finished production (both drivers): means and
    stds, the centered ACF and its block average, the sample times, the
    final state and the engine's diagnostics and counters. ``series`` is (5,
    n_samples) on the run's device (an ensemble's (R, 5, n_samples), whose
    correlations run over groups of ``corr_group_size`` replicas)."""
    device, dtype = series.device, series.dtype
    n_samples = series.shape[-1]
    report = means_finalize(acc)
    max_lag = cfg.corr_max_lag
    n_blocks = cfg.corr_n_blocks(n_samples)

    def stage(fn):
        if series.dim() == 2:
            return fn(series)
        return grouped(fn, series, corr_group_size(series.shape[0], n_samples, max_lag,
                                                   series.element_size()))

    if max_lag >= 1:
        corr, corr_norm = stage(lambda s: autocorr_all(s, max_lag, centered=True))
    else:
        corr = torch.zeros(series.shape[:-1] + (1,), dtype=dtype, device=device)
        corr_norm = torch.zeros_like(corr)
    if n_blocks >= 1 and max_lag >= 1:
        corr_mean, corr_mean_norm = stage(lambda s: block_corr_means(
            s, n_blocks=n_blocks, max_lag=max_lag, centered=True))
    else:
        corr_mean = torch.zeros_like(corr)
        corr_mean_norm = torch.zeros_like(corr_norm)

    steps = torch.as_tensor(sample_steps(cfg), dtype=dtype, device=device)
    return SimResult(
        final_state=engine.get_state(ecarry),
        times=steps * cfg.dt,
        series=series,
        means=report,
        corr=corr,
        corr_norm=corr_norm,
        corr_mean=corr_mean,
        corr_mean_norm=corr_mean_norm,
        frames=frames,
        diagnostics=engine.diagnostics(ecarry),
        counters=engine.counters(ecarry) if engine.counters is not None else {},
    )


def replica_generators(seed: int, replicas: int) -> list:
    """The CPU generators of an ensemble's replicas: replica i's is seeded
    with the first 64-bit word of ``numpy.random.SeedSequence(seed mod
    2**64).spawn(replicas)[i]``. The streams are independent and
    deterministic, and replica i's does not depend on ``replicas``, so
    ``initialize(cfg, replica_generators(seed, R)[i])`` gives replica i's
    state alone."""
    seqs = np.random.SeedSequence(int(seed) % (1 << 64)).spawn(replicas)
    return [torch.Generator().manual_seed(int(s.generate_state(1, np.uint64)[0])) for s in seqs]


def initialize_replicas(cfg: SimConfig, generators, backend: str = "auto",
                        device="cuda") -> MDState:
    """``initialize`` for R replicas, one generator each: the (R, N, 3)
    post-warmup states. The replicas run together on the engine ``backend``
    resolves to (``resolve_backend``; every backend batches): the lattice,
    each replica's velocities from its own generator, per-replica COM
    removal, per-replica rescale to E_target, then the warmup on that engine
    with ``replicas=R``, built for the rescaled stack as ``initialize``'s
    for its state (one launch a chunk for all R; neighbor and dense plain
    torch over the stack). Replica q is ``initialize(cfg, generators[q])`` up to the
    rounding of the (R,) sums the rescale reads (on the CPU with one thread
    bit for bit on the neighbor, dense and cell-pair engines)."""
    device = resolve_device(device)
    replicas = len(generators)
    backend = resolve_backend(cfg, backend, device)
    dtype = _effective_dtype(cfg)
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=dtype, device=device)
    r = r.expand(replicas, -1, -1).contiguous()
    v = torch.stack([random_velocities(g, cfg.n, dtype=dtype, device=device)
                     for g in generators])
    v = remove_com_velocity(v)

    engine = make_replica_engine(cfg, replicas, backend, device)
    state = MDState(r=r, ru=r, v=v, a=torch.zeros_like(r))
    carry, obs = engine.init(state)
    state = engine.get_state(carry)

    v = rescale_to_target_energy(state.v, obs.epot, cfg.target_total_energy)
    state = MDState(r=state.r, ru=state.ru, v=v, a=state.a)

    if cfg.warmup_steps > 0:
        engine = make_replica_engine(cfg, replicas, backend, device, states=state)
        carry, _ = engine.init(state)
        carry, _ = _advance(engine, carry, cfg.warmup_steps, want_obs=False)
        state = engine.get_state(carry)
    return MDState(r=state.r, ru=state.r, v=state.v, a=state.a)


def simulate(
    cfg: SimConfig,
    generator: Optional[torch.Generator] = None,
    backend: str = "auto",
    record_frames: bool = False,
    device="cuda",
) -> SimResult:
    """Full pipeline: initialize + production (the run_all.sh equivalent),
    on ``device`` (default the card, as ``initialize``)."""
    state = initialize(cfg, generator, backend=backend, device=device)
    return run_production(cfg, state, backend=backend,
                          record_frames=record_frames, device=device)
