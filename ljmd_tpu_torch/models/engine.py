"""Engine abstraction: a (carry, step) pair for the MD time loop
(counterpart of ``ljmd_tpu/models/engine.py:36-157, 160-932, 966-1794``).

Backends:

- ``"dense"``: a force function (``models/forces.py``, the ``ops/lj.py``
  oracle) with the plain Verlet step; its carry is the MDState itself.
- ``"neighbor"``: a Verlet neighbor list (``ops/neighbor.py``, plain torch
  gathers) in the carry beside the MDState, rebuilt when a particle has moved
  more than skin/2 since the last build (one host read of that flag per
  step, counted in ``HOST_READS``); sticky ``neighbor_overflow`` diagnostic.
- ``"rows"`` (also ``"pallas"``, the JAX package's name for it): the rows
  engine. Its carry is a ``RowCarry`` of (8, n_pad) row matrices; sampled
  steps run the tri sweep (``ops/pair_sweep.py``; ``triangular=False``: the
  ordered N x N sweep, prefactors 2 / 12) and un-sampled stretches run fused
  multi-step chunks (``ops/fused.py``), each one CUDA launch on the card.
- ``"zsort"``: the z-sorted window-list engine. Its carry is a
  ``ZSortCarry``: the rows in sorted column order, the particle ids, and the
  visit lists. Every inner chunk it re-sorts, rebuilds the tile flags and
  the visit lists (``ops/window_lists.py``) and runs one fused list chunk
  (``ops/fused_list.py``); sampled cycles end in the chunk's ``obs_last``
  step (``run_sample``).
- ``"cellpair"``: the pencil engine for large N. Its carry is a
  ``PencilCarry`` in slot layout (``ops/cell_list.py``); sampled steps run
  the half-shell pencil sweep (``ops/pencil_sweep.py``) and un-sampled
  stretches run fused pencil chunks (``ops/fused_pencil.py``), static or
  width-listed, with a rebin before each chunk. ``half_shell=False`` runs
  the full 9-neighbour sweep instead and ``z_band=True`` the z-banded one
  (both per step, unfused, prefactors 2 / 12).
- ``"auto"``: ``auto_backend``: on a CUDA device the JAX package's
  accelerator routing (``zsort`` where it fits, ``cellpair`` at n >= 8192
  where the pencil grid fits, else ``rows``); on the CPU ``rows``.

``make_replica_engine`` builds an ensemble's engine for R replicas: every
backend's engine batched over the replicas (one launch of each kernel for
all R; neighbor and dense: plain torch over the (R, N, 3) stack).
``_replica_loop_engine`` of R one-system engines is the yardstick.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models.forces import make_force_fn, resolve_device
from ljmd_tpu_torch.models.integrators import velocity_verlet_step
from ljmd_tpu_torch.ops.fused import (
    MAX_CHUNK_STEPS,
    comp_add,
    fused_dense_chunk,
    fused_dense_chunk_ext,
    wrap_positions_ext,
)
from ljmd_tpu_torch.ops.cell_list import (
    bin_to_slots,
    capacity_from_state,
    compute_z_windows,
    default_z_window,
    make_pencil_grid,
)
from ljmd_tpu_torch.ops.fused_list import fused_dense_chunk_list
from ljmd_tpu_torch.ops.fused_pencil import (
    build_width_lists,
    fused_pencil_chunk,
    fused_pencil_width_chunk,
)
from ljmd_tpu_torch.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu_torch.ops.lj import tail_corrections
from ljmd_tpu_torch.ops.neighbor import (
    build_neighbor_list_dense,
    estimate_capacity,
    lj_force_energy_neighbor,
    needs_rebuild,
)
from ljmd_tpu_torch.ops.pair_sweep import ROW_PAD, pair_sweep, pair_sweep_tri
from ljmd_tpu_torch.ops.pencil_rebin import drift_moved2, rebin_slots
from ljmd_tpu_torch.ops.pencil_sweep import (
    TILE_I,
    build_half_shell_tables,
    build_shift_table,
    build_tile_table,
    pencil_sweep,
    pencil_sweep_hs,
    pencil_sweep_zband,
    replica_tables,
    sentinel_fill,
)
from ljmd_tpu_torch.ops.zsort_resort import ZSORT_TILE_I, ZSortGeometry, zsort_resort
from ljmd_tpu_torch.state import MDState, StepObs, kinetic_energy, replica_sum
from ljmd_tpu_torch.utils.profiling import counter, span

__all__ = ["BACKENDS", "Engine", "HOST_READS", "PENCIL_CHUNKS", "PencilCarry", "RowCarry",
           "ROW_PAD", "Tally", "ZSortCarry", "auto_backend", "fused_chunk_steps", "host_read",
           "kinetic_temperature", "make_engine", "make_replica_engine", "replica_capacity",
           "replica_state", "resolve_backend", "resolve_device", "stack_states",
           "zsort_geometry"]

# make_engine's backends ("pallas" is the JAX package's name for "rows").
BACKENDS = ("auto", "rows", "pallas", "zsort", "cellpair", "neighbor", "dense")


class Tally(dict):
    """Counts by key (a dict of counts), with a per-run reset."""

    def reset(self) -> None:
        self.update(dict.fromkeys(self, 0))


# Host reads of a device flag, per decision that depends on data (the JAX
# engine takes them inside lax.cond): the cell-pair engine's per-step
# displacement check, its predictive rebin trigger and its unfused default
# chunk (one read per ``run_fast``), the neighbor engine's per-step rebuild
# check, and the sharded pencil engine's two and its default
# chunk (``parallel/spatial_pencil.py``: one read per decision, after a pmax);
# and, once where an engine is built for a state, its kinetic temperature
# (the zsort skin, the fused cell-pair chunk).
# A replica engine reads whether any replica's flag is set, once per decision.
# Every read goes through ``host_read``.
HOST_READS = counter(Tally(cellpair_moved=0, cellpair_will_exceed=0, cellpair_chunk=0,
                           neighbor_rebuild=0, sharded_pencil_moved=0,
                           sharded_pencil_will_exceed=0, sharded_pencil_chunk=0,
                           engine_temperature=0))
_READ_SPANS = {k: f"ljmd.read.{k}" for k in HOST_READS}

# The cell-pair engine's fused chunks (kernel 15 or 16) as issued: one
# ``chunks`` and ``steps`` more a chunk, on the host (no device read).
PENCIL_CHUNKS = counter(Tally(chunks=0, steps=0))


def host_read(key: str, value: torch.Tensor, cast=bool):
    """``cast(value)`` on the host (it waits for the device's queue to
    drain), counted in ``HOST_READS[key]``; the wait is the span
    ``ljmd.read.<key>``."""
    HOST_READS[key] += 1
    with span(_READ_SPANS[key]):
        return cast(value)


# Chunks sized from the fluid (the unfused cell-pair path's default here, the
# sharded pencil engine's in parallel/spatial_pencil.py): the margin on the
# top speed of the state a run starts from.
CHUNK_SPEED_MARGIN = 1.5


def chunk_from_speed(dt: float, reach: float, top_speed: float, max_chunk: int) -> int:
    """The most steps, at most ``max_chunk`` and at least 1, in which a
    particle at ``CHUNK_SPEED_MARGIN * top_speed`` moves less than ``reach``."""
    if not math.isfinite(top_speed):
        raise ValueError(f"top speed {top_speed}: the state is not finite")
    step = dt * CHUNK_SPEED_MARGIN * top_speed
    if step <= 0.0:
        return max_chunk
    return max(1, min(max_chunk, int(reach / step)))


# The fused cell-pair chunk's longest (the JAX engine's fixed chunk).
FUSED_MAX_CHUNK = 8
# An engine built for a state sizes its fused chunk so that, in a Maxwell
# fluid at the state's kinetic temperature, this many particles a replica
# (on average, at a chunk's start) move fast enough in xy to leave half the
# coverage slack within the chunk. Config 5 (T 0.836, N=62500, half slack
# 0.2496) keeps 8 steps up to T 0.89; LAMMPS's in.lj at N=256,000 (half
# slack 0.2105) takes 5 from its lattice at T 1.44 and 7 in its fluid at
# T 0.7-0.77, where 8 would let ~1e-3 particles a chunk out.
PENCIL_DRIFT_RISK = 2e-5


def fused_chunk_steps(dt: float, half_slack: float, temperature: float, n: int) -> int:
    """The fused cell-pair chunk for a state at kinetic temperature T: the
    most steps, at most ``FUSED_MAX_CHUNK`` and at least 1, in which a
    particle at xy speed sqrt(2 T ln(n / PENCIL_DRIFT_RISK)) moves less than
    ``half_slack``. The xy speed of a Maxwell particle passes s with
    probability exp(-s^2 / 2T), so n particles hold ``PENCIL_DRIFT_RISK``
    that fast."""
    if not math.isfinite(temperature) or temperature < 0.0:
        raise ValueError(f"temperature {temperature}: the state is not finite")
    speed = math.sqrt(2.0 * temperature * math.log(n / PENCIL_DRIFT_RISK))
    if speed <= 0.0:
        return FUSED_MAX_CHUNK
    return max(1, min(FUSED_MAX_CHUNK, int(half_slack / (dt * speed))))


class Engine(NamedTuple):
    """init(state) -> (carry, obs at t=0); step(carry) -> (carry, obs);
    get_state(carry) -> MDState; diagnostics(carry) -> dict.
    ``step_fast`` advances without the energy/virial observables (its obs
    are not meaningful); ``run_fast(carry, n_steps)``, when not None,
    advances n_steps observable-free steps in fused multi-step kernels
    (numerically equivalent to n_steps x step_fast, not bit-identical).
    ``run_sample(carry, n_steps)``, when not None, advances n_steps and
    returns (carry, StepObs of the final step): run_fast(n_steps - 1) + step
    with the final step's observables summed by the last fused chunk
    itself (obs equal ``step``'s up to summation order).
    ``counters(carry)``, when not None, returns the engine's measurements
    kept on the device (a dict of tensors; not flags: ``diagnostics`` holds
    those)."""

    init: Callable[[MDState], tuple[Any, StepObs]]
    step: Callable[[Any], tuple[Any, StepObs]]
    get_state: Callable[[Any], MDState]
    diagnostics: Callable[[Any], dict]
    step_fast: Optional[Callable[[Any], tuple[Any, StepObs]]] = None
    run_fast: Optional[Callable[[Any, int], Any]] = None
    run_sample: Optional[Callable[[Any, int], tuple[Any, StepObs]]] = None
    counters: Optional[Callable[[Any], dict]] = None


def _effective_dtype(cfg: SimConfig) -> torch.dtype:
    """The dtype tensors get: the config's own. (The JAX package truncates a
    float64 config to float32 when x64 is off, as on the TPU; PyTorch and
    the H100 run float64 natively, so nothing truncates here and the
    precision policy follows the requested dtype.)"""
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _pick_replicas(fire: torch.Tensor, new, old):
    """The carry whose replica q is ``new``'s where ``fire[q]``, else
    ``old``'s: every tensor field with the replica axis first."""
    def pick(a, b):
        return torch.where(fire.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return dataclasses.replace(new, **{f.name: pick(getattr(new, f.name), getattr(old, f.name))
                                       for f in dataclasses.fields(new)})


def _force_engine(cfg: SimConfig, device, backend: str = "dense") -> Engine:
    """The plain Verlet step over a force function of ``models/forces.py``
    (JAX ``_force_engine``); its carry is the MDState.

    The dense engine is also the ensemble's engine for R independent
    replicas (the JAX package ``vmap``s the one-system engine): given an
    (R, N, 3) MDState, each step is one dense force call on the stack,
    (R, N, N) pair matrices, with (R,) observables (each replica's own
    sums). The step is elementwise and each force row reduces on its own,
    so replica q's state is what a one-system engine gives it; the
    observables' sums reduce an (R, N, N) stack at once and may round
    otherwise."""
    device = resolve_device(device)
    force_fn = make_force_fn(cfg, backend, device)
    dtype = _effective_dtype(cfg)

    def init(state: MDState):
        state = state.to(device=device, dtype=dtype)
        res = force_fn(state.r)
        obs = StepObs(res.epot, kinetic_energy(state.v), res.d_epot, res.dd_epot)
        return MDState(state.r, state.ru, state.v, res.a), obs

    def step(carry: MDState):
        return velocity_verlet_step(carry, force_fn, cfg.dt, cfg.box_length)

    return Engine(init=init, step=step, get_state=lambda c: c,
                  diagnostics=lambda c: {}, step_fast=step)


def _neighbor_engine(cfg: SimConfig, device, replicas: int | None = None) -> Engine:
    """Verlet-list engine (JAX ``_neighbor_engine``): the carry is
    (MDState, NeighborList); each step rebuilds the list (the dense O(N^2)
    build) when a particle has moved more than skin/2 since the last build.
    JAX takes that decision inside ``lax.cond``; here it is one host read of
    the device flag per step (``HOST_READS["neighbor_rebuild"]``). The
    ``neighbor_overflow`` diagnostic is sticky.

    ``replicas=R`` makes it the ensemble's engine for R independent
    replicas (JAX's vmap of the one-system engine): (R, N, 3) states, a
    NeighborList with a leading replica axis, (R,) observables and
    ``neighbor_overflow`` (R,), one sticky flag a replica. Each replica
    decides its rebuild for itself (JAX's vmap of lax.cond): the host reads
    whether any replica's flag is set (one read a step for the stack); where
    one is, the stack is rebuilt and each replica keeps its rebuilt or its
    old list by its own flag. So replica q's list and state are what a
    one-system engine gives it; the observables' sums reduce an (R, N, K)
    stack at once and may round otherwise."""
    device = resolve_device(device)
    if replicas is not None and replicas < 1:
        raise ValueError("the replica neighbor engine takes replicas >= 1")
    dtype = _effective_dtype(cfg)
    L = cfg.box_length
    skin = cfg.neighbor_skin
    r_list = cfg.rc + skin
    if not r_list < 0.5 * L:
        raise ValueError(
            f"rc + skin = {r_list} must stay below L/2 = {0.5 * L} for MIC "
            "(shrink neighbor_skin or use the dense backend)"
        )
    capacity = cfg.neighbor_capacity or estimate_capacity(cfg.density, r_list)
    r_list_sq = r_list * r_list

    def build(r):
        return build_neighbor_list_dense(r, L, r_list_sq, capacity)

    def force(r, nbrs):
        return lj_force_energy_neighbor(r, nbrs.idx, L, cfg.rc_square,
                                        cfg.use_tail_corrections, cfg.volume, cfg.rc)

    def init(state: MDState):
        state = state.to(device=device, dtype=dtype)
        nbrs = build(state.r)
        res = force(state.r, nbrs)
        obs = StepObs(res.epot, kinetic_energy(state.v), res.d_epot, res.dd_epot)
        return (MDState(state.r, state.ru, state.v, res.a), nbrs), obs

    dt = cfg.dt
    half_dt = 0.5 * cfg.dt
    half_dt_sq = 0.5 * cfg.dt * cfg.dt

    def step(carry):
        state, nbrs = carry
        r_new = wrap_positions(state.r + state.v * dt + state.a * half_dt_sq, L)
        v_half = state.v + state.a * half_dt
        fire = needs_rebuild(nbrs, r_new, L, skin)
        if host_read("neighbor_rebuild", fire.any()):
            rebuilt = build(r_new)
            rebuilt = dataclasses.replace(rebuilt, overflow=rebuilt.overflow | nbrs.overflow)
            nbrs = rebuilt if replicas is None else _pick_replicas(fire, rebuilt, nbrs)
        res = force(r_new, nbrs)
        v_new = v_half + res.a * half_dt
        ru_new = state.ru + minimum_image(r_new - state.r, L)
        obs = StepObs(res.epot, kinetic_energy(v_new), res.d_epot, res.dd_epot)
        return (MDState(r=r_new, ru=ru_new, v=v_new, a=res.a), nbrs), obs

    return Engine(init=init, step=step, get_state=lambda c: c[0],
                  diagnostics=lambda c: {"neighbor_overflow": c[1].overflow}, step_fast=step)


@dataclasses.dataclass(frozen=True)
class RowCarry:
    """Carry in row layout: each field is (8, n_pad) with x/y/z in rows
    0..2, rows 3..7 and columns >= N identically zero (the replica engine's:
    (R, 8, n_pad), replica first). ``rc``/``vc`` are the compensation terms
    (zeros when compensation is off)."""

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    rc: torch.Tensor
    vc: torch.Tensor


def _rows_engine(cfg: SimConfig, device, compensated: bool | None = None,
                 triangular: bool = True, replicas: int | None = None) -> Engine:
    """Dense rows engine: (N, 3) <-> (8, n_pad) conversion only at
    init/get_state; every step is row-matrix elementwise work plus the
    pair sweep; un-sampled stretches run in fused chunks of at most
    ``MAX_CHUNK_STEPS`` steps. ``triangular=True`` (the default) sweeps with
    the tri kernel (each pair once in the observables); ``False`` with the
    ordered N x N sweep (each pair twice, prefactors 2 / 12).

    ``replicas=R`` makes it the ensemble's engine for R independent
    replicas (the JAX package ``vmap``s the one-system engine): states are
    (R, N, 3), the carry's fields (R, 8, n_pad), observables (R,) tensors
    (each replica's sums over its own rows), and each tri sweep and each
    fused chunk is ONE launch for all R replicas (kernels 2, 3 and 4's
    replica launches), each replica's rows bit for bit what a one-system
    engine would give it. The observables' sums reduce an (R, n_pad) row at
    once, so they may round otherwise than a one-system engine's."""
    device = resolve_device(device)
    if replicas is not None and (replicas < 1 or not triangular):
        raise ValueError("the replica rows engine takes replicas >= 1 and the tri sweep")
    n = cfg.n
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    L = cfg.box_length
    dtype = _effective_dtype(cfg)
    e_t, d_t, dd_t = (
        tail_corrections(n, cfg.volume, cfg.rc)
        if cfg.use_tail_corrections
        else (0.0, 0.0, 0.0)
    )

    batch = () if replicas is None else (replicas,)

    def to_rows(x: torch.Tensor) -> torch.Tensor:  # (..., N, 3) -> (..., 8, n_pad)
        out = torch.zeros(batch + (8, n_pad), dtype=dtype, device=device)
        out[..., 0:3, :n] = x.transpose(-1, -2).to(device=device, dtype=dtype)
        return out

    def from_rows(x: torch.Tensor) -> torch.Tensor:  # (..., 8, n_pad) -> (..., N, 3)
        return x[..., 0:3, :n].transpose(-1, -2)

    def accel(out: torch.Tensor) -> torch.Tensor:
        # a = 24 * raw sweep rows 0..2; rows 3..7 (the e/du/ddu partials)
        # zeroed.
        a = torch.zeros_like(out)
        a[..., 0:3, :] = 24.0 * out[..., 0:3, :]
        return a

    sweep_fn = pair_sweep_tri if triangular else pair_sweep
    # The tri sweep counts each pair once (prefactors 4 / 24), the ordered
    # sweep twice (2 / 12).
    e_pref, d_pref = (4.0, 24.0) if triangular else (2.0, 12.0)

    def sweep(pos: torch.Tensor, want_obs: bool = True) -> torch.Tensor:
        return sweep_fn(pos, n, L, cfg.rc_square, want_observables=want_obs)

    def obs_from(out: torch.Tensor, ekin: torch.Tensor) -> StepObs:
        return StepObs(
            epot=e_pref * replica_sum(out[..., 3, :], 1) + e_t,
            ekin=ekin,
            d_epot=d_pref * replica_sum(out[..., 4, :], 1) + d_t,
            dd_epot=d_pref * replica_sum(out[..., 5, :], 1) + dd_t,
        )

    # Compensation in the increment-underflow regime (f32 at dt <= 1e-3, or
    # asked for); float64 increments do not underflow, so f64 runs plain.
    if compensated is None:
        compensated = (cfg.compensated_sum or cfg.dt <= 1.0e-3) and dtype == torch.float32

    def init(state: MDState):
        r8 = to_rows(state.r)
        out = sweep(r8)
        v8 = to_rows(state.v)
        zero = torch.zeros_like(r8)
        carry = RowCarry(r=r8, ru=to_rows(state.ru), v=v8, a=accel(out),
                         rc=zero, vc=zero)
        return carry, obs_from(out, 0.5 * replica_sum(v8 * v8, 2))

    dt = cfg.dt
    half_dt = 0.5 * cfg.dt
    half_dt_sq = 0.5 * cfg.dt * cfg.dt

    def _step(c: RowCarry, want_obs: bool):
        if compensated:
            r_raw, rc_new = comp_add(c.r, c.rc, c.v * dt + c.a * half_dt_sq)
            r_new = wrap_positions(r_raw, L)
            v_half, vc_half = comp_add(c.v, c.vc, c.a * half_dt)
        else:
            r_new = wrap_positions(c.r + c.v * dt + c.a * half_dt_sq, L)
            rc_new = c.rc
            v_half, vc_half = c.v + c.a * half_dt, c.vc
        out = sweep(r_new, want_obs)
        a_new = accel(out)
        if compensated:
            v_new, vc_new = comp_add(v_half, vc_half, a_new * half_dt)
            v_eff = v_new + vc_new
        else:
            v_new, vc_new = v_half + a_new * half_dt, vc_half
            v_eff = v_new
        ekin = 0.5 * replica_sum(v_eff * v_eff, 2)
        ru_new = c.ru + minimum_image(r_new - c.r, L)
        return (
            RowCarry(r=r_new, ru=ru_new, v=v_new, a=a_new, rc=rc_new, vc=vc_new),
            obs_from(out, ekin),
        )

    def step(c: RowCarry):
        return _step(c, True)

    def step_fast(c: RowCarry):
        return _step(c, False)

    def get_state(c: RowCarry) -> MDState:
        v = c.v + c.vc if compensated else c.v
        return MDState(r=from_rows(c.r), ru=from_rows(c.ru), v=from_rows(v), a=from_rows(c.a))

    def run_fast(c: RowCarry, n_steps: int) -> RowCarry:
        """Fused advance in chunks of <= MAX_CHUNK_STEPS, with the unwrap
        update and the [0, L) wrap applied once per chunk (exact: nothing
        wraps inside a chunk)."""
        r, ru, v, a = c.r, c.ru, c.v, c.a
        remaining = n_steps
        while remaining > 0:
            k = min(MAX_CHUNK_STEPS, remaining)
            r_end, v, a = fused_dense_chunk(r, v, a, n, L, cfg.rc_square, dt, k)
            ru = ru + (r_end - r)
            r = wrap_positions(r_end, L)
            remaining -= k
        return RowCarry(r=r, ru=ru, v=v, a=a, rc=c.rc, vc=c.vc)

    def run_fast_ext(c: RowCarry, n_steps: int) -> RowCarry:
        """Compensated fused advance: two-float positions (r + rc) and
        compensated velocities inside the kernel."""
        r, rc_, ru, v, vc_, a = c.r, c.rc, c.ru, c.v, c.vc, c.a
        remaining = n_steps
        while remaining > 0:
            k = min(MAX_CHUNK_STEPS, remaining)
            r_end, rc_end, v, vc_, a = fused_dense_chunk_ext(
                r, rc_, v, vc_, a, n, L, cfg.rc_square, dt, k)
            ru = ru + ((r_end - r) + (rc_end - rc_))
            r, rc_ = wrap_positions_ext(r_end, rc_end, L)
            remaining -= k
        return RowCarry(r=r, ru=ru, v=v, a=a, rc=rc_, vc=vc_)

    return Engine(
        init=init, step=step, get_state=get_state,
        diagnostics=lambda c: {}, step_fast=step_fast,
        run_fast=run_fast_ext if compensated else run_fast,
    )


@dataclasses.dataclass(frozen=True)
class ZSortCarry:
    """Carry of the z-sorted engine: (8, n_pad) rows in sorted column order
    (padding columns last), particle ids (-1 for padding), the reference
    positions of the last sort, the visit lists (``tiles``, ``tcounts``) and
    a sticky ``invalid`` flag (a particle outran the sort skin between two
    sorts: results suspect). ``rlo``/``vc`` are the two-float position
    remainders and velocity compensation of the extended mode (zeros
    otherwise). ``resorts`` (int32) counts the resorts since ``init`` and
    ``travel2`` holds the largest squared sorted-axis travel a check has
    seen since ``init``; ``skips`` (int64, (..., 2)) the runs kernel 10's
    box test tested and skipped since ``init``, which the kernel adds to in
    place, so the carries that descend from one ``init`` share it (none of
    the three is in the JAX carry; ``counters`` gives ``travel2`` as a share
    of the invalid bound and ``skips`` as the share skipped)."""

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    ids: torch.Tensor
    r_ref: torch.Tensor
    tiles: torch.Tensor
    tcounts: torch.Tensor
    invalid: torch.Tensor
    rlo: torch.Tensor
    vc: torch.Tensor
    resorts: torch.Tensor
    travel2: torch.Tensor
    skips: torch.Tensor


# The port's skin for an engine built for a state (make_engine /
# make_replica_engine pass the state's kinetic temperature T, the largest
# over replicas): the invalid bound, 0.6 x skin, is this many
# u = sqrt(T) x inner_chunk x dt of sorted-axis travel in a chunk. The JAX
# rule (8.5 x inner_chunk x dt, v_max ~4.4) is 5.6 u at T 0.84, which an
# N=4000 fluid's 16-step z travel passes ~1e-9 of the time: R=64 ensembles
# set the flag within a minute. That travel, measured on an H100 over
# 1.2e9 particle-chunks at T 0.84 and 2.1, falls off as ln P ~ -0.58 u^2
# (a Gaussian's -0.5 where collisions do not cut it); at 7.4 u a chunk
# passes the bound ~4e-15 of the time, or under 4e-14 on the Gaussian slope.
ZSORT_TRAVEL_SIGMAS = 7.4


def kinetic_temperature(state: MDState) -> float:
    """The largest kinetic temperature 2K / 3N over the replicas of an
    (N, 3) or (R, N, 3) state (one host read, ``engine_temperature``)."""
    v = state.v
    top = host_read("engine_temperature", torch.max(torch.sum(v * v, dim=(-2, -1))), float)
    return top / (3.0 * v.shape[-2])


def zsort_travel_skin(temperature: float, inner_chunk: int, dt: float) -> float:
    """The sort skin whose invalid bound (0.6 x skin) is ``ZSORT_TRAVEL_SIGMAS``
    x sqrt(T) x inner_chunk x dt of travel in a chunk."""
    return ZSORT_TRAVEL_SIGMAS * math.sqrt(max(temperature, 0.0)) * inner_chunk * dt / 0.6


def zsort_geometry(cfg: SimConfig, inner_chunk: int = 16, sort_skin: float | None = None,
                   tile_j: int | None = None, slab_sort: bool | None = None,
                   temperature: float | None = None) -> ZSortGeometry:
    """Skin, window, slab mode, tile width, padding and sort-key bits of the
    zsort engine (JAX ``engine.py:488-684`` under its default resort before
    every chunk, same constants; tail lists on). The default skin is the
    one-chunk travel bound; given the ``temperature`` of the state the
    engine is built for, the larger of that bound and ``zsort_travel_skin``
    (port only; without it, or with an explicit ``sort_skin``, the JAX
    package's geometry), clamped to what the box holds. Raises ValueError
    where the JAX engine does: a box too small for the window or for the
    one-chunk travel skin, too few x-slabs, too few sort-key bits."""
    if sort_skin is None:
        # The flags only have to stay valid across ONE chunk:
        # 0.6 * skin >= 1.15 * v_max * inner_chunk * dt with v_max ~ 4.4.
        sort_skin = max(0.3, 8.5 * inner_chunk * cfg.dt)
        if temperature is not None:
            sort_skin = max(sort_skin, zsort_travel_skin(temperature, inner_chunk, cfg.dt))
    L = cfg.box_length
    n = cfg.n
    # The flag window must respect the minimum image (window < L/2).
    clamped_skin = min(sort_skin, (0.49 * L - cfg.rc) / 1.2)
    if clamped_skin < 0.15:
        raise ValueError("box too small for z-sorted tile skipping (rc ~ L/2); "
                         "use the rows engine")
    if clamped_skin < 0.999 * min(sort_skin, 8.5 * inner_chunk * cfg.dt):
        raise ValueError(
            "box too small for the one-chunk travel skin at this "
            f"inner_chunk={inner_chunk}; reduce inner_chunk or dt")
    sort_skin = clamped_skin
    # The flags stay valid up to 0.6 * skin per-axis travel (the invalid
    # bound), hence the 1.2 x skin margin of the window.
    window = cfg.rc + 1.2 * sort_skin
    n_slabs = int(L / window)
    if slab_sort is None:
        slab_sort = n_slabs >= 5 and n >= 10000
    if slab_sort and n_slabs < 5:
        raise ValueError("slab_sort needs >= 5 x-slabs of width rc+skin")
    if tile_j is None:
        tile_j = 768 if slab_sort else 512
    # 128-granular padding that fits one tile_j-wide visit.
    n_pad = max(-(-n // ZSORT_TILE_I) * ZSORT_TILE_I, tile_j)
    # Packed int32 sort key: quantized z (and slab) above the column index.
    bits_pad = max(1, (n_pad - 1).bit_length())
    slab_bits = max(1, (n_slabs - 1).bit_length()) if slab_sort else 0
    zq_bits = 30 - bits_pad - slab_bits
    if zq_bits < 8:
        raise ValueError(f"z-sort key quantization too coarse ({zq_bits} bits for "
                         f"n_pad={n_pad}, slabs={slab_bits} bits); use the pencil engine")
    return ZSortGeometry(
        sort_skin=sort_skin, window=window, invalid_thresh=(0.6 * sort_skin) ** 2,
        n_slabs=n_slabs, slab_sort=slab_sort,
        tile_j=tile_j, n_pad=n_pad, bits_pad=bits_pad, zq_bits=zq_bits,
        # The JAX list kernel's SMEM cliff; kept so both packages route alike.
        fused_viable=(n_pad // ZSORT_TILE_I) ** 2 <= 32768,
    )


def _zsort_engine(cfg: SimConfig, device, inner_chunk: int = 16,
                  sort_skin: float | None = None, tile_j: int | None = None,
                  extended: bool | None = None, slab_sort: bool | None = None,
                  replicas: int | None = None, temperature: float | None = None) -> Engine:
    """Dense fused engine with sorted tile skipping (JAX ``_zsort_engine``).

    Particles are kept in ascending-z column order (or (x-slab, z) with
    ``slab_sort``); before every fused chunk of at most ``inner_chunk``
    steps the engine checks the travel along the sorted axes since the last
    sort (sticky ``invalid`` past 0.6 * skin), re-sorts, recomputes the
    block flags and rebuilds the visit lists, all on the device with no
    host read (the check folded into the resort, ``ops/zsort_resort.py``:
    two launches on the card; the JAX engine's ``trigger="always"``).
    Per-step ``step``/``step_fast`` use the order-agnostic tri sweep.

    ``replicas=R`` makes it the ensemble's engine for R independent
    replicas (the JAX package ``vmap``s the one-system engine): states are
    (R, N, 3), every carry field has a leading replica axis (``invalid``
    (R,), one flag a replica), observables are (R,) tensors, and each tri
    sweep, resort (its sort kernel and kernel 9) and fused list chunk is ONE
    launch for all R (the replica launches), each replica over its own
    sorted order and lists. The sort keys are unique, so each replica's
    order is the one-system engine's; the flags, gathers and the travel
    check act on each replica alone; so replica q's rows are bit for bit
    what a one-system engine gives it. The observables' sums reduce an
    (R, n_pad) row at once, so they may round otherwise.

    ``temperature`` (``zsort_geometry``) sizes the skin from the
    state's speeds: a one-system engine is replica q's twin only when it is
    built with the stack's temperature. ``counters`` gives each replica's
    largest sorted-axis travel of a check as a share of the invalid bound
    (``zsort_travel_share``; 1.0 is the flag's edge), kept on the device,
    and the share of the runs kernel 10 tested since ``init`` that its box
    test skipped (``list_skip_share``; the kernel adds to the carry's
    device counter, so no operation is added; NaN where nothing was tested:
    the CPU twin, S = 64 (N=864), a streamed plane)."""
    device = resolve_device(device)
    if replicas is not None and replicas < 1:
        raise ValueError("the replica zsort engine takes replicas >= 1")
    batch = () if replicas is None else (replicas,)
    dtype = _effective_dtype(cfg)
    if extended is None:
        extended = (cfg.compensated_sum or cfg.dt <= 1.0e-3) and dtype == torch.float32
    geo = zsort_geometry(cfg, inner_chunk, sort_skin, tile_j, slab_sort, temperature)
    n = cfg.n
    L = cfg.box_length
    tile_i = ZSORT_TILE_I
    n_pad, tile_j = geo.n_pad, geo.tile_j
    e_t, d_t, dd_t = (
        tail_corrections(n, cfg.volume, cfg.rc) if cfg.use_tail_corrections else (0.0, 0.0, 0.0)
    )

    def sweep(pos, want_obs=True):
        return pair_sweep_tri(pos, n, L, cfg.rc_square, want_observables=want_obs)

    def accel(out):
        a = torch.zeros_like(out)
        a[..., 0:3, :] = 24.0 * out[..., 0:3, :]
        return a

    def obs_from(out, ekin):
        return StepObs(epot=4.0 * replica_sum(out[..., 3, :], 1) + e_t, ekin=ekin,
                       d_epot=24.0 * replica_sum(out[..., 4, :], 1) + d_t,
                       dd_epot=24.0 * replica_sum(out[..., 5, :], 1) + dd_t)

    def _resort(r8, ru8, v8, a8, ids, rlo, vcc, resorts=None, check=None):
        return zsort_resort(r8, ru8, v8, a8, ids, rlo, vcc, geo, n, L, extended, resorts=resorts,
                            check=check)

    col = torch.arange(n_pad, dtype=torch.int32, device=device)

    def to_rows(x):
        out = torch.zeros(batch + (8, n_pad), dtype=dtype, device=device)
        out[..., 0:3, :n] = x.transpose(-1, -2).to(device=device, dtype=dtype)
        return out

    def init(state: MDState):
        ids = torch.where(col < n, col, -1).expand(batch + (n_pad,))
        zero = torch.zeros(batch + (8, n_pad), dtype=dtype, device=device)
        s = _resort(to_rows(state.r), to_rows(state.ru), to_rows(state.v), zero, ids, zero, zero)
        out = sweep(s.r)
        carry = ZSortCarry(r=s.r, ru=s.ru, v=s.v, a=accel(out), ids=s.ids, r_ref=s.r,
                           tiles=s.tiles, tcounts=s.tcounts,
                           invalid=torch.zeros(batch, dtype=torch.bool, device=device),
                           rlo=s.rlo, vc=s.vc,
                           resorts=torch.zeros(batch, dtype=torch.int32, device=device),
                           travel2=torch.zeros(batch, dtype=dtype, device=device),
                           skips=torch.zeros(batch + (2,), dtype=torch.int64, device=device))
        return carry, obs_from(out, 0.5 * replica_sum(s.v * s.v, 2))

    dt = cfg.dt
    half_dt = 0.5 * cfg.dt
    half_dt_sq = 0.5 * cfg.dt * cfg.dt

    def _step(c: ZSortCarry, want_obs: bool):
        if extended:
            # zsort drifts by (v + vc) * dt (the rows engine by v * dt).
            r_raw, rlo = comp_add(c.r, c.rlo, (c.v + c.vc) * dt + c.a * half_dt_sq)
            r_new, rlo = wrap_positions_ext(r_raw, rlo, L)
            v_half, vc_half = comp_add(c.v, c.vc, c.a * half_dt)
        else:
            r_new = wrap_positions(c.r + c.v * dt + c.a * half_dt_sq, L)
            rlo = c.rlo
            v_half, vc_half = c.v + c.a * half_dt, c.vc
        out = sweep(r_new, want_obs)
        a_new = accel(out)
        if extended:
            v_new, vc_new = comp_add(v_half, vc_half, a_new * half_dt)
            v_eff = v_new + vc_new
        else:
            v_new, vc_new = v_half + a_new * half_dt, vc_half
            v_eff = v_new
        ekin = 0.5 * replica_sum(v_eff * v_eff, 2)
        ru_new = c.ru + minimum_image(r_new - c.r, L)
        carry = dataclasses.replace(c, r=r_new, ru=ru_new, v=v_new, a=a_new, rlo=rlo,
                                    vc=vc_new)
        return carry, obs_from(out, ekin)

    def _resorted(c: ZSortCarry) -> ZSortCarry:
        """The resort with the travel check folded in
        (``ops/zsort_resort.py``: two launches on the card)."""
        with span("ljmd.zsort.resort"):
            s = _resort(c.r, c.ru, c.v, c.a, c.ids, c.rlo, c.vc, resorts=c.resorts,
                        check=(c.r_ref, c.invalid, c.travel2))
            return dataclasses.replace(c, r=s.r, ru=s.ru, v=s.v, a=s.a, ids=s.ids, r_ref=s.r,
                                       tiles=s.tiles, tcounts=s.tcounts, rlo=s.rlo, vc=s.vc,
                                       resorts=s.resorts, invalid=s.invalid, travel2=s.travel2)

    def _chunk(c: ZSortCarry, k: int, obs: bool = False):
        c = _resorted(c)
        with span("ljmd.zsort.chunk"):
            if extended:
                out = fused_dense_chunk_list(c.r, c.v, c.a, c.tiles, c.tcounts, n, L,
                                             cfg.rc_square, dt, k, tile_i=tile_i, tile_j=tile_j,
                                             r_lo=c.rlo, vc=c.vc, obs_last=obs,
                                             skip_counts=c.skips)
                r_end, rlo_end, v, vcc, a = out[:5]
                ru = c.ru + ((r_end - c.r) + (rlo_end - c.rlo))
                r_w, rlo_w = wrap_positions_ext(r_end, rlo_end, L)
                c2 = dataclasses.replace(c, r=r_w, ru=ru, v=v, a=a, rlo=rlo_w, vc=vcc)
                return (c2, out[5]) if obs else c2
            out = fused_dense_chunk_list(c.r, c.v, c.a, c.tiles, c.tcounts, n, L,
                                         cfg.rc_square, dt, k, tile_i=tile_i, tile_j=tile_j,
                                         obs_last=obs, skip_counts=c.skips)
            r_end, v, a = out[:3]
            c2 = dataclasses.replace(c, r=wrap_positions(r_end, L), ru=c.ru + (r_end - c.r),
                                     v=v, a=a)
            return (c2, out[3]) if obs else c2

    def run_fast(c: ZSortCarry, n_steps: int) -> ZSortCarry:
        full, rem = divmod(n_steps, inner_chunk)
        for _ in range(full):
            c = _chunk(c, inner_chunk)
        if rem:
            c = _chunk(c, rem)
        return c

    def run_sample(c: ZSortCarry, n_steps: int):
        """run_fast(n_steps) with the last chunk in obs_last mode: the final
        step's observables come from the chunk's own sweep."""
        full, rem = divmod(n_steps, inner_chunk)
        if rem == 0:
            full, rem = full - 1, inner_chunk
        for _ in range(full):
            c = _chunk(c, inner_chunk)
        c, obs8 = _chunk(c, rem, obs=True)
        v_eff = c.v + c.vc if extended else c.v
        return c, obs_from(obs8, 0.5 * replica_sum(v_eff * v_eff, 2))

    def get_state(c: ZSortCarry) -> MDState:
        idx = torch.where(c.ids >= 0, c.ids, n).long()
        rep = () if replicas is None else (torch.arange(replicas, device=device)[:, None],)

        def scatter(arr):
            out = torch.zeros(batch + (n + 1, 3), dtype=dtype, device=device)
            out[rep + (idx,)] = arr[..., 0:3, :].transpose(-1, -2)
            return out[..., :n, :]

        v8 = c.v + c.vc if extended else c.v
        return MDState(r=scatter(c.r), ru=scatter(c.ru), v=scatter(v8), a=scatter(c.a))

    return Engine(
        init=init,
        step=lambda c: _step(c, True),
        get_state=get_state,
        diagnostics=lambda c: {"zsort_invalid": c.invalid},
        step_fast=lambda c: _step(c, False),
        run_fast=run_fast if geo.fused_viable else None,
        run_sample=run_sample if geo.fused_viable else None,
        counters=lambda c: {"zsort_travel_share": torch.sqrt(c.travel2 / geo.invalid_thresh),
                            "list_skip_share": c.skips[..., 1].double() / c.skips[..., 0].double()},
    )


def _zsort_kwargs(sample_interval: int | None) -> dict:
    """Sampling-aligned inner chunk (JAX ``engine.py:1746-1748``): an
    interval in 17..24 becomes the chunk, so each sample cycle pays one
    resort instead of two."""
    if sample_interval is not None and 17 <= sample_interval <= 24:
        return {"inner_chunk": sample_interval}
    return {}


@dataclasses.dataclass(frozen=True)
class PencilCarry:
    """Slot-layout carry of the cell-pair engine (the JAX ``PencilCarry``,
    field for field): each float field is (8, n_slots). Rows 0..2 hold
    x/y/z; in ``r``, row 3 is the slot validity (1/0) and row 4 the
    particle id (it survives rebin permutations). ``r_ref`` holds the
    positions of the last rebin, ``counts`` the per-pencil populations,
    ``rc``/``vc`` the two-float position remainders and velocity
    compensation (zeros when compensation is off), ``overflow`` the sticky
    flag (a pencil overflowed its capacity, or a particle outran the
    coverage slack between two rebins: results suspect). ``win_a``,
    ``win_b``, ``use_b`` are the z-banded sweep's window tables ((T * 9,)
    int32, zeros when z_band is off); ``wl_*`` the width lists ((1,) zeros
    when off). ``drift2`` (a replica's each, not in the JAX carry) holds the
    largest squared drift a check has seen since ``init``."""

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    r_ref: torch.Tensor
    counts: torch.Tensor
    win_a: torch.Tensor
    win_b: torch.Tensor
    use_b: torch.Tensor
    rc: torch.Tensor
    vc: torch.Tensor
    overflow: torch.Tensor
    wl_self: torch.Tensor
    wl_self_cnt: torch.Tensor
    wl_nbr_i: torch.Tensor
    wl_nbr_j: torch.Tensor
    wl_nbr_off: torch.Tensor
    drift2: torch.Tensor


CELLPAIR_TRIGGERS = ("always", "predictive", "never")
# The unfused path's longest chunk (the JAX engine's fixed unfused chunk).
UNFUSED_MAX_CHUNK = 12
# Margin of the predictive rebin trigger on the coming chunk's travel.
_PREDICT_SAFETY = 1.25


def _cellpair_engine(cfg: SimConfig, device, z_band: bool = False, half_shell: bool = True,
                     compensated: bool | None = None, rebin_trigger: str | None = None,
                     use_fused: bool | None = None, width_lists: bool = False,
                     inner_chunk: int | None = None, replicas: int | None = None,
                     temperature: float | None = None) -> Engine:
    """Pencil-sweep engine for large N (JAX ``_cellpair_engine``): pair work
    O(N * 9 * capacity) over the pencil pairs, particles rebinned into
    pencils (a stable sort and a gather, ``ops/pencil_rebin.py``: two kernel
    launches on the card; the ``always`` trigger's drift check rides in it)
    when they may have left the coverage slack.

    The sweep: the half shell (default; each pair once, prefactors 4 / 24),
    the full 9-neighbour sweep (``half_shell=False``) or the z-banded one
    (``z_band=True``, which implies ``half_shell=False``; it turns itself off
    where ``default_z_window`` reaches the capacity, as in JAX). Both full
    sweeps count each pair twice (prefactors 2 / 12) and run unfused. The
    z-banded sweep rebins in (pencil, z) order, recomputes its window tables
    at every rebin (their overflow joins the sticky flag) and checks the 3-D
    drift against (skin / 2)^2 instead of the xy slack.

    ``step``/``step_fast`` run one sweep per step with the JAX per-step
    displacement check (one host read of the "moved" flag per step).
    ``run_fast`` advances in chunks of ``inner_chunk`` (fused, by default:
    JAX's 8, or with ``temperature``, the kinetic temperature of the state
    the engine is built for, ``fused_chunk_steps``; unfused, by default, the
    most steps up to JAX's 12 in which a particle at 1.5x the top speed of
    the state the run starts from stays inside half the coverage slack: one
    host read per ``run_fast``, ``HOST_READS["cellpair_chunk"]``; JAX's
    fixed 12 lets config 5's fastest particles outrun its 0.25 and sets
    ``pencil_overflow``) with the rebin decision once per chunk:
    ``rebin_trigger``
    "always" (the plain default: rebin before every chunk, no host read),
    "predictive" (the compensated default: rebin when a particle could
    cross half the slack during the chunk; one host read per chunk) or
    "never" (floor measurements only). ``use_fused`` (default: on with the
    half shell; the kernel launches on any card, the twin runs on the CPU)
    runs each chunk in one fused kernel, else as per-step sweeps
    (``run_fast_unfused``). ``width_lists`` drives the fused chunk by
    occupancy-width visit lists (kernel 16). It is off unless asked for:
    JAX takes them where the 128-quantized mean occupancy leaves a whole
    block free (engine.py:1153-1158, measured on the TPU), but kernel 15
    skips a pencil's empty 128-slot stages itself, and on the H100 kernel
    16 ran 1.5x slower at config 5's capacity 512 and 1.46x at in.lj's 768.

    ``replicas=R`` makes it the ensemble's engine for R independent
    replicas (the JAX package ``vmap``s the one-system engine): states are
    (R, N, 3), observables (R,) tensors and ``pencil_overflow`` (R,), one
    sticky flag a replica. The carry is one flat stack of R grids, (8, R *
    n_slots) with replica q in slots [q * n_slots, (q + 1) * n_slots), swept
    over ``replica_tables``' tables (replica q's pencils offset by q *
    n_pencils, no neighbour in another replica), so each sweep (kernel 13,
    or 11 / 12 for the full sweeps) and each fused chunk (kernel 15 or 16)
    is ONE launch for all R; the rebin keys each slot by its pencil + q *
    n_pencils, and the z-band's window tables are the stack's
    (``compute_z_windows(..., replicas=R)``, their overflow each replica's
    own). Every decision is each replica's own (JAX's vmap of lax.cond):
    "always" rebins the whole stack before every chunk; the predictive
    trigger and the per-step "moved" check read whether any replica's flag
    is set (one host read a decision) and, where one is, rebin the stack and
    keep each replica's rebinned or old carry (and window tables) by its own
    flag. The unfused chunk's default length comes from the stack's fastest
    replica, so replica q is a one-system engine with ``inner_chunk`` pinned
    to that length. So replica q's rows, counts and flag are bit for bit
    those of a one-system engine built at the same capacity, and its
    observables too (each replica's sums are taken over its own slots)."""
    device = resolve_device(device)
    if replicas is not None and replicas < 1:
        raise ValueError("the replica cellpair engine takes replicas >= 1")
    reps = 1 if replicas is None else replicas
    rep_kw = {} if replicas is None else {"replicas": replicas}
    L = cfg.box_length
    if L <= 1.0:
        raise ValueError("cellpair engine requires L > 1 (aux-row wrap invariant)")
    skin = cfg.neighbor_skin
    r_list = cfg.rc + skin
    grid = make_pencil_grid(cfg.n, L, r_list, cfg.density, cfg.neighbor_capacity)
    n, ns, P, cap = cfg.n, grid.n_slots, grid.n_pencils, grid.capacity
    dtype = _effective_dtype(cfg)
    window = default_z_window(grid, n, r_list, TILE_I)
    if window >= cap:
        z_band = False  # banding degenerates to the full sweep
    if z_band:
        half_shell = False  # banding implies the full 9-neighbour sweep
    tbl_np, shf_np = build_half_shell_tables(grid)
    hs_tbl = torch.as_tensor(tbl_np, device=device)
    hs_shf = torch.as_tensor(shf_np, device=device)
    if replicas is not None:
        hs_tbl, hs_shf = replica_tables(hs_tbl, hs_shf, P, replicas)
    if not half_shell:
        # The full sweeps' tables: the 9 xy-neighbours (self at k = 4) and
        # their static image shifts.
        nbr_tbl = torch.as_tensor(build_tile_table(grid), device=device)
        nbr_shf = torch.as_tensor(build_shift_table(grid), device=device)
        if replicas is not None:
            nbr_tbl, nbr_shf = replica_tables(nbr_tbl, nbr_shf, P, replicas)
    e_t, d_t, dd_t = (
        tail_corrections(n, cfg.volume, cfg.rc) if cfg.use_tail_corrections else (0.0, 0.0, 0.0)
    )
    xyz_mask = torch.zeros((8, 1), dtype=dtype, device=device)
    xyz_mask[0:3] = 1.0
    if compensated is None:
        compensated = (cfg.compensated_sum or cfg.dt <= 1.0e-3) and dtype == torch.float32
    if rebin_trigger not in CELLPAIR_TRIGGERS + (None,):
        raise ValueError(f"unknown rebin trigger {rebin_trigger!r}")
    if rebin_trigger is None:
        # JAX's defaults: a rebin before every chunk for plain runs; the
        # predictive trigger for compensated ones (each rebin wraps positions).
        rebin_trigger = "predictive" if compensated else "always"
    # The fused chunks sweep the half shell only (JAX ``fused_ok``).
    if use_fused is None:
        use_fused = half_shell
    elif use_fused and not half_shell:
        raise ValueError("fused pencil path not viable for this config (it needs the half shell)")
    if width_lists and not use_fused:
        raise ValueError("width_lists requires the fused pencil path")
    fluid_chunk = inner_chunk is None and not use_fused
    zero_win = torch.zeros(((reps * ns // TILE_I) * 9,), dtype=torch.int32, device=device)
    no_flag = torch.zeros((), dtype=torch.bool, device=device)
    no_list = torch.zeros((1,), dtype=torch.int32, device=device)
    # The "always" trigger's drift check rides in the rebin (on the card in
    # its key pass); the z-band's 3-D check and the compensated engine's
    # two-float wrap keep it separate.
    fold_check = not z_band and not compensated

    def sweep(pos, counts, wins, want_obs=True):
        if z_band:
            return pencil_sweep_zband(pos, nbr_tbl, counts, *wins, grid, cfg.rc_square, window,
                                      want_obs, **rep_kw)
        if half_shell:
            # Already multiplied by the validity row (ops/pencil_sweep.py).
            return pencil_sweep_hs(pos, hs_tbl, counts, hs_shf, grid, cfg.rc_square, want_obs,
                                   **rep_kw)
        return pencil_sweep(pos, nbr_tbl, counts, nbr_shf, grid, cfg.rc_square, want_obs,
                            **rep_kw)

    def windows(r8, counts):
        """The z-band's window tables and their overflow flag (a stack's:
        each replica's, (R,))."""
        if not z_band:
            return (zero_win, zero_win, zero_win), no_flag
        wa, wb, ub, ovf = compute_z_windows(r8, r8[3], counts, grid, window, r_list, TILE_I,
                                            **rep_kw)
        return (wa, wb, ub), ovf

    def accel(out):
        a = torch.zeros_like(out)
        a[0:3] = 24.0 * out[0:3]
        return a

    def total(x):
        """The sum of a row (or rows) of slots: the whole for one system,
        each replica's own over its slots (contiguous, as a one-system
        engine sums them) for a stack."""
        if replicas is None:
            return torch.sum(x)
        return torch.stack([torch.sum(x[..., q * ns:(q + 1) * ns].contiguous())
                            for q in range(replicas)])

    def rmax(x):
        """The max of a (n_slots,) row: each replica's for a stack."""
        return torch.max(x) if replicas is None else torch.amax(x.reshape(reps, ns), dim=1)

    # The half shell counts each pair once (prefactors 4 / 24), the full
    # sweeps twice (2 / 12).
    e_pref, d_pref = (4.0, 24.0) if half_shell else (2.0, 12.0)

    def obs_from(out, ekin):
        return StepObs(epot=e_pref * total(out[3]) + e_t, ekin=ekin,
                       d_epot=d_pref * total(out[4]) + d_t,
                       dd_epot=d_pref * total(out[5]) + dd_t)

    def counts_from_valid(valid):
        return valid.reshape(reps * P, cap).sum(dim=1).to(torch.int32)

    def lists_from_counts(counts):
        if not width_lists:
            return no_list, no_list, no_list, no_list, no_list
        return build_width_lists(counts, hs_tbl, hs_shf, reps * P, cap)

    def scatter_rows(x, slot):
        out = torch.zeros((8, ns + 1), dtype=dtype, device=device)
        out[0:3, slot] = x.T.to(device=device, dtype=dtype)
        return out[:, :ns].contiguous()  # the kernels take contiguous rows

    def with_tables(c: PencilCarry, wins) -> PencilCarry:
        wl = lists_from_counts(c.counts)
        return dataclasses.replace(c, wl_self=wl[0], wl_self_cnt=wl[1], wl_nbr_i=wl[2],
                                   wl_nbr_j=wl[3], wl_nbr_off=wl[4], win_a=wins[0],
                                   win_b=wins[1], use_b=wins[2])

    def wins_of(c: PencilCarry):
        return c.win_a, c.win_b, c.use_b

    def pick(fire, new: PencilCarry, old: PencilCarry) -> PencilCarry:
        """Replica q's fields from ``new`` where ``fire[q]``, else from
        ``old``: the slot rows, the counts and the flag (the width lists
        follow from the counts)."""
        def rows(a, b):
            return torch.where(fire[None, :, None], a.reshape(8, reps, ns),
                               b.reshape(8, reps, ns)).reshape(8, reps * ns)

        return dataclasses.replace(
            new, **{k: rows(getattr(new, k), getattr(old, k))
                    for k in ("r", "ru", "v", "a", "r_ref", "rc", "vc")},
            counts=torch.where(fire[:, None], new.counts.reshape(reps, P),
                               old.counts.reshape(reps, P)).reshape(-1),
            overflow=torch.where(fire, new.overflow, old.overflow))

    def _rebinned(c: PencilCarry, with_a: bool, fire=None, check=False) -> PencilCarry:
        """The carry rebinned (``with_a``: a rides along, as the next
        chunk's first half-kick uses it); with ``fire`` (R,), only the
        replicas it flags; ``check``: the drift check folded in (its flag
        joins the sticky one)."""
        with span("ljmd.cellpair.rebin"):
            r8, rc8 = c.r, c.rc
            if compensated:
                # The two-float wrap into [0, L), its rounding error folded
                # into the remainder rows (rebin_slots wraps plain rows).
                r8, rc8 = r8.clone(), rc8.clone()
                r8[0:3], rc8[0:3] = wrap_positions_ext(r8[0:3], rc8[0:3], L)
            others = ([c.ru, c.v] + ([c.a] if with_a else [])
                      + ([rc8, c.vc] if compensated else []))
            r8p, perm, counts, ovf, drift2 = rebin_slots(
                r8, others, grid, c.overflow, replicas=replicas, wrap=not compensated,
                z_order=z_band, drift_ref=c.r_ref if check else None,
                drift_thresh=rebuild_thresh, drift_max=c.drift2 if check else None)
            wins, w_ovf = windows(r8p, counts)
            if z_band:
                ovf = ovf | w_ovf
            ru, v, *rest = perm
            a = rest.pop(0) if with_a else c.a
            # Without compensation rc is zeros throughout.
            rc, vc = rest if compensated else (c.rc, c.vc)
            new = dataclasses.replace(c, r=r8p, ru=ru, v=v, a=a, rc=rc, vc=vc, r_ref=r8p,
                                      counts=counts, overflow=ovf,
                                      drift2=c.drift2 if drift2 is None else drift2)
            if fire is None:
                return with_tables(new, wins)
            if z_band:
                wins = tuple(torch.where(fire[:, None], w.reshape(reps, -1), o.reshape(reps, -1))
                             .reshape(-1) for w, o in zip(wins, wins_of(c)))
            return with_tables(pick(fire, new, c), wins)

    def bin_rows(state: MDState):
        """One system's slot rows r (ids, validity, no sentinels yet), ru, v
        and its binning overflow."""
        slot, overflow = bin_to_slots(state.r, grid)
        r8 = scatter_rows(state.r, slot)
        valid = torch.zeros((ns + 1,), dtype=dtype, device=device)
        valid[slot] = 1.0
        ids = torch.zeros((ns + 1,), dtype=dtype, device=device)
        ids[slot] = torch.arange(n, dtype=dtype, device=device)
        r8[3], r8[4] = valid[:ns], ids[:ns]
        return r8, scatter_rows(state.ru, slot), scatter_rows(state.v, slot), overflow

    def init(state: MDState):
        state = state.to(device=device, dtype=dtype)
        if replicas is None:
            r8, ru8, v8, overflow = bin_rows(state)
        else:
            parts = [bin_rows(replica_state(state, q)) for q in range(replicas)]
            r8, ru8, v8 = (torch.cat([pt[i] for pt in parts], dim=1) for i in range(3))
            overflow = torch.stack([pt[3] for pt in parts])
        r8 = sentinel_fill(r8, r8[3], cap, None if replicas is None else P)
        counts = counts_from_valid(r8[3])
        wins, w_ovf = windows(r8, counts)
        out = sweep(r8, counts, wins)
        zero = torch.zeros_like(r8)
        carry = with_tables(PencilCarry(
            r=r8, ru=ru8, v=v8, a=accel(out), r_ref=r8,
            counts=counts, win_a=None, win_b=None, use_b=None, rc=zero, vc=zero,
            overflow=overflow | w_ovf, wl_self=None, wl_self_cnt=None, wl_nbr_i=None,
            wl_nbr_j=None, wl_nbr_off=None,
            drift2=torch.zeros(() if replicas is None else (reps,), dtype=dtype,
                               device=device)), wins)
        return carry, obs_from(out, 0.5 * total(v8 * v8))

    dt = cfg.dt
    half_dt = 0.5 * cfg.dt
    half_dt_sq = 0.5 * cfg.dt * cfg.dt
    # Coverage of the 9-pencil neighbourhood holds while every particle's xy
    # drift since the last rebin stays under (pencil width - rc) / 2; z is
    # unrestricted (the sweeps cover whole z columns). The z-band keeps the
    # 3-D check against the skin: its windows assume bounded z drift.
    skin_xy = grid.pencil_width - cfg.rc
    if z_band:
        rebuild_thresh, drift_rows, slack = (0.5 * skin) ** 2, slice(0, 3), skin
    else:
        rebuild_thresh, drift_rows, slack = (0.5 * skin_xy) ** 2, slice(0, 2), skin_xy
    if inner_chunk is None:
        if not use_fused:
            inner_chunk = UNFUSED_MAX_CHUNK
        elif temperature is None:
            inner_chunk = FUSED_MAX_CHUNK
        else:
            inner_chunk = fused_chunk_steps(dt, 0.5 * slack, temperature, n)

    def _step(c: PencilCarry, want_obs: bool, rebin_mode=True):
        # No per-step wrap: slot coordinates may drift outside [0, L)
        # between rebins (the static image shifts rely on it).
        delta = (c.v * dt + c.a * half_dt_sq) * xyz_mask
        if compensated:
            r_new, rc_new = comp_add(c.r, c.rc, delta)
            v_half, vc_half = comp_add(c.v, c.vc, c.a * half_dt)
        else:
            r_new, rc_new = c.r + delta, c.rc
            v_half, vc_half = c.v + c.a * half_dt, c.vc
        c = dataclasses.replace(c, r=r_new, ru=c.ru + delta, v=v_half, rc=rc_new, vc=vc_half)
        if rebin_mode is True:
            moved = rmax(drift_moved2(r_new, c.r_ref, L, drift_rows)) > rebuild_thresh
            if host_read("cellpair_moved", moved.any()):
                c = _rebinned(c, False, None if replicas is None else moved)
        elif rebin_mode == "force":
            c = _rebinned(c, False)
        with span("ljmd.cellpair.sweep"):
            out = sweep(c.r, c.counts, wins_of(c), want_obs)
            a_new = accel(out)
            if compensated:
                v_new, vc_new = comp_add(c.v, c.vc, a_new * half_dt)
                v_eff = v_new + vc_new
            else:
                v_new, vc_new = c.v + a_new * half_dt, c.vc
                v_eff = v_new
            c = dataclasses.replace(c, v=v_new, vc=vc_new, a=a_new)
            # step_fast's observables are not meaningful: none are summed (a
            # stack's sums are R reductions each).
            return c, obs_from(out, 0.5 * total(v_eff * v_eff)) if want_obs else None

    def _invalid_check(c: PencilCarry):
        """Sticky flag for drift past the coverage slack since the last
        rebin (pairs may have been missed in the last chunk) and the running
        max of the drift; no host read. Returns (carry, per-slot squared xy
        drift)."""
        moved2 = drift_moved2(c.r, c.r_ref, L, drift_rows)
        top = rmax(moved2)
        return dataclasses.replace(c, overflow=c.overflow | (top > rebuild_thresh),
                                   drift2=torch.maximum(c.drift2, top)), moved2

    def _maybe_rebin(c: PencilCarry, k: int) -> PencilCarry:
        if rebin_trigger == "always" and fold_check:
            return _rebinned(c, True, check=True)
        with span("ljmd.cellpair.check"):
            valid = c.r[3]
            c, moved2 = _invalid_check(c)
            if rebin_trigger == "predictive":
                speed = torch.sqrt(torch.sum(c.v[drift_rows] * c.v[drift_rows], dim=0))
                predicted = torch.sqrt(moved2) + speed * (k * dt * _PREDICT_SAFETY)
                will_exceed = rmax(predicted * valid) > 0.5 * slack
        if rebin_trigger == "never":
            return c
        if rebin_trigger == "always":
            return _rebinned(c, True)
        if not host_read("cellpair_will_exceed", will_exceed.any()):
            return c
        return _rebinned(c, True, None if replicas is None else will_exceed)

    def _chunk(c: PencilCarry, k: int) -> PencilCarry:
        c = _maybe_rebin(c, k)
        PENCIL_CHUNKS["chunks"] += 1
        PENCIL_CHUNKS["steps"] += k
        with span("ljmd.cellpair.chunk"):
            ext = {"r_lo": c.rc, "vc": c.vc} if compensated else {}
            if width_lists:
                out = fused_pencil_width_chunk(c.r, c.v, c.a, c.wl_self, c.wl_self_cnt,
                                               c.wl_nbr_i, c.wl_nbr_j, c.wl_nbr_off, P, cap, L,
                                               cfg.rc_square, dt, k, **ext, **rep_kw)
            else:
                out = fused_pencil_chunk(c.r, c.v, c.a, hs_tbl, hs_shf, P, cap, L,
                                         cfg.rc_square, dt, k, **ext, **rep_kw)
            if compensated:
                r_end, rc_end, v_new, vc_new, a_new = out
                ru = c.ru + ((r_end - c.r) + (rc_end - c.rc)) * xyz_mask
                return dataclasses.replace(c, r=r_end, ru=ru, v=v_new, a=a_new, rc=rc_end,
                                           vc=vc_new)
            r_end, v_new, a_new = out
            # No wrap inside the chunk: the unwrap update is the slot-space drift.
            return dataclasses.replace(c, r=r_end, ru=c.ru + (r_end - c.r) * xyz_mask,
                                       v=v_new, a=a_new)

    def _unfused_chunk(c: PencilCarry, k: int) -> PencilCarry:
        start = 0
        if rebin_trigger == "always":
            # The rebin folds into step 1, after its drift and half-kick.
            with span("ljmd.cellpair.check"):
                c, _ = _invalid_check(c)
            c, _ = _step(c, False, "force")
            start = 1
        else:
            c = _maybe_rebin(c, k)
        for _ in range(start, k):
            c, _ = _step(c, False, False)
        return c

    def _top_speed(c: PencilCarry) -> float:
        """The top speed (drift rows) of the carry; a stack's fastest
        replica's among those whose speeds are finite (a replica gone NaN
        does not stop the others; none finite: NaN, which raises)."""
        v = (c.v + c.vc if compensated else c.v)[drift_rows]
        top = torch.amax(torch.sum(v * v, dim=0).reshape(reps, ns), dim=1)
        return host_read("cellpair_chunk",
                         torch.sqrt(torch.where(torch.isfinite(top), top, -1.0).max()), float)

    def _chunked(chunk):
        def run(c: PencilCarry, n_steps: int) -> PencilCarry:
            k = inner_chunk
            if fluid_chunk and n_steps > 0:
                k = chunk_from_speed(dt, 0.5 * slack, _top_speed(c), UNFUSED_MAX_CHUNK)
            full, rem = divmod(n_steps, k)
            for _ in range(full):
                c = chunk(c, k)
            if rem:
                c = chunk(c, rem)
            return c
        return run

    def get_state(c: PencilCarry) -> MDState:
        """Slot layout -> particle order through the id row; positions
        wrapped back into [0, L). A stack's replica q fills rows [q (n + 1),
        (q + 1) (n + 1)) of one buffer, its empty slots row q (n + 1) + n."""
        ids = torch.where(c.r[3] > 0.5, c.r[4].to(torch.int64), n)
        if replicas is not None:
            ids = ids + torch.arange(reps * ns, device=device) // ns * (n + 1)

        def gather(arr):
            out = torch.zeros((reps * (n + 1), 3), dtype=dtype, device=device)
            out[ids] = arr[0:3].T
            return out[:n] if replicas is None else out.view(reps, n + 1, 3)[:, :n]

        v8 = c.v + c.vc if compensated else c.v
        return MDState(r=wrap_positions(gather(c.r), L), ru=gather(c.ru), v=gather(v8),
                       a=gather(c.a))

    run_fast = _chunked(_chunk if use_fused else _unfused_chunk)
    run_fast.__name__ = "run_fast" if use_fused else "run_fast_unfused"
    return Engine(
        init=init,
        step=lambda c: _step(c, True),
        get_state=get_state,
        diagnostics=lambda c: {"pencil_overflow": c.overflow},
        step_fast=lambda c: _step(c, False),
        run_fast=run_fast,
        counters=lambda c: {"pencil_drift_share": torch.sqrt(c.drift2 / rebuild_thresh)},
    )


def _cellpair_viable(cfg: SimConfig) -> bool:
    return int(math.floor(cfg.box_length / (cfg.rc + cfg.neighbor_skin))) >= 3


def auto_backend(cfg: SimConfig, on_accelerator: bool,
                 sample_interval: int | None = None) -> str:
    """The backend ``"auto"`` picks. On an accelerator, the JAX package's
    accelerator branch (``engine.py:1763-1790``): zsort when the window
    lists fit ((n_pad/128)^2 <= 32768), L > 4 rc and the engine accepts the
    config; else the cell-pair engine at n >= 8192 where its pencil grid
    fits; else zsort without its fused path where it builds; else rows. On
    the CPU: rows."""
    if not on_accelerator:
        return "rows"
    zsort_ok = False
    if cfg.box_length > 4.0 * cfg.rc:
        try:
            zsort_geometry(cfg, **_zsort_kwargs(sample_interval))
            zsort_ok = True
        except ValueError:
            pass
    n_pad128 = -(-cfg.n // 128) * 128
    if zsort_ok and (n_pad128 // 128) ** 2 <= 32768:
        return "zsort"
    if cfg.n >= 8192 and _cellpair_viable(cfg):
        return "cellpair"
    return "zsort" if zsort_ok else "rows"


def resolve_backend(cfg: SimConfig, backend: str = "auto", device="cuda",
                    sample_interval: int | None = None) -> str:
    """The backend ``backend`` names: ``auto_backend``'s pick for
    ``"auto"``, else ``backend`` itself; a name not in ``BACKENDS`` raises
    ValueError."""
    device = resolve_device(device)
    if backend == "auto":
        backend = auto_backend(cfg, device.type == "cuda", sample_interval)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    return backend


def replica_capacity(cfg: SimConfig, states: MDState | None) -> int:
    """The cell-pair engine's one pencil capacity: ``cfg.neighbor_capacity``
    where set, else the largest occupancy census (``capacity_from_state``,
    JAX ``_cellpair_tuned``) over the replicas of ``states`` (an (N, 3)
    state is one replica), else 0 (the lattice bound). JAX under vmap
    cannot take a census of a traced state and takes the config's or the
    lattice's."""
    if cfg.neighbor_capacity or states is None:
        return cfg.neighbor_capacity
    r = states.r if states.r.dim() == 3 else states.r[None]
    return max(capacity_from_state(cfg.box_length, cfg.rc + cfg.neighbor_skin, rq) for rq in r)


def _build_engine(cfg: SimConfig, backend: str, device, state: MDState | None,
                  sample_interval: int | None, replicas: int | None) -> Engine:
    """The engine ``backend`` resolves to (``resolve_backend``), for one
    system or, with ``replicas=R``, for an (R, N, 3) stack. ``state`` sizes
    the zsort skin from its kinetic temperature (the hottest replica's) and
    the cell-pair capacity (``replica_capacity``) and fused chunk
    (``fused_chunk_steps``)."""
    device = resolve_device(device)
    backend = resolve_backend(cfg, backend, device, sample_interval)
    sized = state is not None and backend in ("zsort", "cellpair")
    temperature = kinetic_temperature(state) if sized else None
    if backend == "zsort":
        return _zsort_engine(cfg, device, replicas=replicas, temperature=temperature,
                             **_zsort_kwargs(sample_interval))
    if backend == "cellpair":
        cfg = cfg.replace(neighbor_capacity=replica_capacity(cfg, state))
        return _cellpair_engine(cfg, device, replicas=replicas, temperature=temperature)
    if backend == "neighbor":
        return _neighbor_engine(cfg, device, replicas=replicas)
    if backend == "dense":
        return _force_engine(cfg, device)
    return _rows_engine(cfg, device, replicas=replicas)


def make_engine(cfg: SimConfig, backend: str = "auto", device="cuda", state=None,
                sample_interval: int | None = None) -> Engine:
    """Build the engine for ``cfg`` on ``device`` (default the card; raises
    where there is none): one of ``BACKENDS`` (``"pallas"`` is the JAX
    package's name for ``"rows"``; ``"auto"`` is ``auto_backend``).
    ``sample_interval`` (the production loop's ``output_interval``) aligns
    the zsort inner chunk to it. ``state`` (a representative MDState, e.g.
    the post-warmup one) sizes the cell-pair engine's pencil capacity from
    its occupancy census when ``cfg.neighbor_capacity`` is unset and the
    zsort engine's skin from its kinetic temperature (``zsort_geometry``;
    an (R, N, 3) state: its hottest replica's)."""
    return _build_engine(cfg, backend, device, state, sample_interval, None)


def replica_state(states: MDState, i: int) -> MDState:
    """Replica ``i``'s (N, 3) state out of an (R, N, 3) MDState."""
    return MDState(r=states.r[i], ru=states.ru[i], v=states.v[i], a=states.a[i])


def stack_states(states) -> MDState:
    """The (R, N, 3) MDState of a sequence of (N, 3) states."""
    return MDState(*(torch.stack([getattr(s, k) for s in states])
                     for k in ("r", "ru", "v", "a")))


def _replica_loop_engine(engines: list) -> Engine:
    """R one-system engines behind one Engine: states are (R, N, 3), the
    carry is the tuple of the R carries, observables, diagnostics and
    counters are stacked over the replicas. Every call runs each replica's own engine in
    turn, so replica i goes through exactly the calls, in the same order,
    that a one-system run gives it: its rows and its observables bit for
    bit, at R times the launches of one run."""
    first = engines[0]

    def obs_stack(obs) -> StepObs:
        return StepObs(*(torch.stack([getattr(o, f.name) for o in obs])
                         for f in dataclasses.fields(StepObs)))

    def init(states: MDState):
        carries, obs = zip(*(e.init(replica_state(states, i)) for i, e in enumerate(engines)))
        return tuple(carries), obs_stack(obs)

    def step(carries):
        carries, obs = zip(*(e.step(c) for e, c in zip(engines, carries)))
        return tuple(carries), obs_stack(obs)

    def step_fast(carries):
        return tuple((e.step_fast or e.step)(c)[0] for e, c in zip(engines, carries)), None

    def run_fast(carries, n_steps: int):
        return tuple(e.run_fast(c, n_steps) for e, c in zip(engines, carries))

    def run_sample(carries, n_steps: int):
        carries, obs = zip(*(e.run_sample(c, n_steps) for e, c in zip(engines, carries)))
        return tuple(carries), obs_stack(obs)

    def stacked(read):
        def per_replica(carries) -> dict:
            per = [read(e)(c) for e, c in zip(engines, carries)]
            return {k: torch.stack([torch.as_tensor(d[k]) for d in per]) for k in per[0]}
        return per_replica

    return Engine(
        init=init, step=step,
        get_state=lambda carries: stack_states([e.get_state(c) for e, c in zip(engines, carries)]),
        diagnostics=stacked(lambda e: e.diagnostics), step_fast=step_fast,
        run_fast=run_fast if first.run_fast is not None else None,
        run_sample=run_sample if first.run_sample is not None else None,
        counters=stacked(lambda e: e.counters) if first.counters is not None else None,
    )


def make_replica_engine(cfg: SimConfig, replicas: int, backend: str = "auto", device="cuda",
                        states: MDState | None = None,
                        sample_interval: int | None = None) -> Engine:
    """The engine of an R-replica ensemble on ``device``: (R, N, 3) states,
    (R,) observables: the engine ``backend`` resolves to, with
    ``replicas=R``. Rows: one launch of kernels 2, 3 or 4 a sweep or chunk
    for all R; zsort: of kernels 2, 9 and 10; cellpair: of kernel 13 a
    sampled sweep and of kernel 15 or 16 a chunk, at one capacity for all
    replicas (``replica_capacity``, so replica q is what a one-system engine
    built at that capacity gives it); neighbor and dense: plain torch over
    the stack, one rebuild check a step for all R. ``states`` sizes the
    zsort skin from the hottest replica (``kinetic_temperature``).
    ``_replica_loop_engine`` of R one-system engines stays the yardstick of
    the batched ones."""
    return _build_engine(cfg, backend, device, states, sample_interval, replicas)
