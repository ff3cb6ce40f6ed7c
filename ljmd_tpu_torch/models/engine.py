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
    rebin_gather_parts,
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
from ljmd_tpu_torch.ops.pencil_sweep import (
    TILE_I,
    build_half_shell_tables,
    build_shift_table,
    build_tile_table,
    pencil_sweep,
    pencil_sweep_hs,
    pencil_sweep_zband,
    sentinel_fill,
)
from ljmd_tpu_torch.ops.window_lists import build_window_lists, compute_tile_flags
from ljmd_tpu_torch.state import MDState, StepObs, kinetic_energy

__all__ = ["BACKENDS", "Engine", "HOST_READS", "PencilCarry", "RowCarry", "ROW_PAD",
           "ZSortCarry", "auto_backend", "make_engine", "resolve_device", "zsort_geometry"]

# make_engine's backends ("pallas" is the JAX package's name for "rows").
BACKENDS = ("auto", "rows", "pallas", "zsort", "cellpair", "neighbor", "dense")

# Host reads of a device flag, per decision that depends on data (the JAX
# engine takes them inside lax.cond): the cell-pair engine's per-step
# displacement check, its predictive rebin trigger and its unfused default
# chunk (one read per ``run_fast``), the neighbor engine's
# per-step rebuild check, and the sharded pencil engine's two and its default
# chunk (``parallel/spatial_pencil.py``: one read per decision, after a pmax).
HOST_READS = {"cellpair_moved": 0, "cellpair_will_exceed": 0, "cellpair_chunk": 0,
              "neighbor_rebuild": 0, "sharded_pencil_moved": 0,
              "sharded_pencil_will_exceed": 0, "sharded_pencil_chunk": 0}

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
    itself (obs equal ``step``'s up to summation order)."""

    init: Callable[[MDState], tuple[Any, StepObs]]
    step: Callable[[Any], tuple[Any, StepObs]]
    get_state: Callable[[Any], MDState]
    diagnostics: Callable[[Any], dict]
    step_fast: Optional[Callable[[Any], tuple[Any, StepObs]]] = None
    run_fast: Optional[Callable[[Any, int], Any]] = None
    run_sample: Optional[Callable[[Any, int], tuple[Any, StepObs]]] = None


def _effective_dtype(cfg: SimConfig) -> torch.dtype:
    """The dtype tensors get: the config's own. (The JAX package truncates a
    float64 config to float32 when x64 is off, as on the TPU; PyTorch and
    the H100 run float64 natively, so nothing truncates here and the
    precision policy follows the requested dtype.)"""
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _force_engine(cfg: SimConfig, device, backend: str = "dense") -> Engine:
    """The plain Verlet step over a force function of ``models/forces.py``
    (JAX ``_force_engine``); its carry is the MDState."""
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


def _neighbor_engine(cfg: SimConfig, device) -> Engine:
    """Verlet-list engine (JAX ``_neighbor_engine``): the carry is
    (MDState, NeighborList); each step rebuilds the list (the dense O(N^2)
    build) when a particle has moved more than skin/2 since the last build.
    JAX takes that decision inside ``lax.cond``; here it is one host read of
    the device flag per step (``HOST_READS["neighbor_rebuild"]``). The
    ``neighbor_overflow`` diagnostic is sticky."""
    device = resolve_device(device)
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
        HOST_READS["neighbor_rebuild"] += 1
        if bool(needs_rebuild(nbrs, r_new, L, skin)):
            rebuilt = build(r_new)
            nbrs = dataclasses.replace(rebuilt, overflow=rebuilt.overflow | nbrs.overflow)
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
    0..2, rows 3..7 and columns >= N identically zero. ``rc``/``vc`` are the
    compensation terms (zeros when compensation is off)."""

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    rc: torch.Tensor
    vc: torch.Tensor


def _rows_engine(cfg: SimConfig, device, compensated: bool | None = None,
                 triangular: bool = True) -> Engine:
    """Dense rows engine: (N, 3) <-> (8, n_pad) conversion only at
    init/get_state; every step is row-matrix elementwise work plus the
    pair sweep; un-sampled stretches run in fused chunks of at most
    ``MAX_CHUNK_STEPS`` steps. ``triangular=True`` (the default) sweeps with
    the tri kernel (each pair once in the observables); ``False`` with the
    ordered N x N sweep (each pair twice, prefactors 2 / 12)."""
    device = resolve_device(device)
    n = cfg.n
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    L = cfg.box_length
    dtype = _effective_dtype(cfg)
    e_t, d_t, dd_t = (
        tail_corrections(n, cfg.volume, cfg.rc)
        if cfg.use_tail_corrections
        else (0.0, 0.0, 0.0)
    )

    def to_rows(x: torch.Tensor) -> torch.Tensor:  # (N, 3) -> (8, n_pad)
        out = torch.zeros((8, n_pad), dtype=dtype, device=device)
        out[0:3, :n] = x.T.to(device=device, dtype=dtype)
        return out

    def accel(out: torch.Tensor) -> torch.Tensor:
        # a = 24 * raw sweep rows 0..2; rows 3..7 (the e/du/ddu partials)
        # zeroed.
        a = torch.zeros_like(out)
        a[0:3] = 24.0 * out[0:3]
        return a

    sweep_fn = pair_sweep_tri if triangular else pair_sweep
    # The tri sweep counts each pair once (prefactors 4 / 24), the ordered
    # sweep twice (2 / 12).
    e_pref, d_pref = (4.0, 24.0) if triangular else (2.0, 12.0)

    def sweep(pos: torch.Tensor, want_obs: bool = True) -> torch.Tensor:
        return sweep_fn(pos, n, L, cfg.rc_square, want_observables=want_obs)

    def obs_from(out: torch.Tensor, ekin: torch.Tensor) -> StepObs:
        return StepObs(
            epot=e_pref * torch.sum(out[3]) + e_t,
            ekin=ekin,
            d_epot=d_pref * torch.sum(out[4]) + d_t,
            dd_epot=d_pref * torch.sum(out[5]) + dd_t,
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
        return carry, obs_from(out, 0.5 * torch.sum(v8 * v8))

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
        ekin = 0.5 * torch.sum(v_eff * v_eff)
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
        return MDState(r=c.r[0:3, :n].T, ru=c.ru[0:3, :n].T, v=v[0:3, :n].T,
                       a=c.a[0:3, :n].T)

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
    otherwise)."""

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


# The JAX engine's resort triggers; only "always" (what make_engine uses) is
# ported. The others skip resorts behind a lax.cond, which has no
# counterpart without a host read of the firing condition.
ZSORT_TRIGGERS = ("always", "predictive", "static", "never")
# The window lists' block granule (the JAX engine's tile_i).
ZSORT_TILE_I = 128


@dataclasses.dataclass(frozen=True)
class ZSortGeometry:
    """The zsort engine's static choices for one config (``zsort_geometry``)."""

    sort_skin: float
    window: float
    invalid_thresh: float
    n_slabs: int
    slab_sort: bool
    tile_j: int
    n_pad: int
    bits_pad: int
    zq_bits: int
    fused_viable: bool


def zsort_geometry(cfg: SimConfig, inner_chunk: int = 16, sort_skin: float | None = None,
                   tile_j: int | None = None, slab_sort: bool | None = None,
                   trigger: str = "always") -> ZSortGeometry:
    """Skin, window, slab mode, tile width, padding and sort-key bits of the
    zsort engine (JAX ``engine.py:488-684``, same constants; tail lists on).
    Raises ValueError where the JAX engine does: an unknown trigger, a box
    too small for the window or for the one-chunk travel skin, too few
    x-slabs, too few sort-key bits; NotImplementedError for the triggers
    that are not ported."""
    if trigger not in ZSORT_TRIGGERS:
        raise ValueError(f"unknown resort trigger {trigger!r}")
    if trigger != "always":
        raise NotImplementedError(
            f"resort trigger {trigger!r} is not ported to ljmd_tpu_torch yet: "
            "ROADMAP.md Open items §1.5 (zsort triggers)")
    if sort_skin is None:
        # The flags only have to stay valid across ONE chunk:
        # 0.6 * skin >= 1.15 * v_max * inner_chunk * dt with v_max ~ 4.4.
        sort_skin = max(0.3, 8.5 * inner_chunk * cfg.dt)
    L = cfg.box_length
    n = cfg.n
    # The flag window must respect the minimum image (window < L/2).
    clamped_skin = min(sort_skin, (0.49 * L - cfg.rc) / 1.2)
    if clamped_skin < 0.15:
        raise ValueError("box too small for z-sorted tile skipping (rc ~ L/2); "
                         "use the rows engine")
    if clamped_skin < 0.999 * min(sort_skin, 8.5 * inner_chunk * cfg.dt):
        raise ValueError(
            "box too small for the unconditional-resort skin at this "
            f"inner_chunk={inner_chunk}; reduce inner_chunk")
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
        n_slabs=n_slabs, slab_sort=slab_sort, tile_j=tile_j, n_pad=n_pad,
        bits_pad=bits_pad, zq_bits=zq_bits,
        # The JAX list kernel's SMEM cliff; kept so both packages route alike.
        fused_viable=(n_pad // ZSORT_TILE_I) ** 2 <= 32768,
    )


def _zsort_engine(cfg: SimConfig, device, inner_chunk: int = 16,
                  sort_skin: float | None = None, tile_j: int | None = None,
                  extended: bool | None = None, slab_sort: bool | None = None,
                  trigger: str = "always") -> Engine:
    """Dense fused engine with sorted tile skipping (JAX ``_zsort_engine``).

    Particles are kept in ascending-z column order (or (x-slab, z) with
    ``slab_sort``); before every fused chunk of at most ``inner_chunk``
    steps the engine checks the travel since the last sort (sticky
    ``invalid`` past 0.6 * skin), re-sorts, recomputes the block flags and
    rebuilds the visit lists, all on the device with no host read (the
    "always" trigger). Per-step ``step``/``step_fast`` use the
    order-agnostic tri sweep."""
    device = resolve_device(device)
    dtype = _effective_dtype(cfg)
    if extended is None:
        extended = (cfg.compensated_sum or cfg.dt <= 1.0e-3) and dtype == torch.float32
    geo = zsort_geometry(cfg, inner_chunk, sort_skin, tile_j, slab_sort, trigger)
    n = cfg.n
    L = cfg.box_length
    tile_i = ZSORT_TILE_I
    n_pad, tile_j, slab_sort = geo.n_pad, geo.tile_j, geo.slab_sort
    e_t, d_t, dd_t = (
        tail_corrections(n, cfg.volume, cfg.rc) if cfg.use_tail_corrections else (0.0, 0.0, 0.0)
    )

    def sweep(pos, want_obs=True):
        return pair_sweep_tri(pos, n, L, cfg.rc_square, want_observables=want_obs)

    def accel(out):
        a = torch.zeros_like(out)
        a[0:3] = 24.0 * out[0:3]
        return a

    def obs_from(out, ekin):
        return StepObs(epot=4.0 * torch.sum(out[3]) + e_t, ekin=ekin,
                       d_epot=24.0 * torch.sum(out[4]) + d_t,
                       dd_epot=24.0 * torch.sum(out[5]) + dd_t)

    def _lists(r8):
        flags = compute_tile_flags(r8, n, tile_i, tile_i, L, geo.window,
                                   x_window=geo.window if slab_sort else None,
                                   cross_margin=0.6 * geo.sort_skin)
        return build_window_lists(flags, n, n_pad, tile_i, tile_j, zero_fill=False)

    zq_bits, bits_pad = geo.zq_bits, geo.bits_pad
    col = torch.arange(n_pad, dtype=torch.int32, device=device)

    def _sort(r8, ru8, v8, a8, ids, rlo, vcc):
        # Packed unique int32 keys (index in the low bits): torch.sort is
        # then deterministic. Quantization only orders z within a bucket.
        zq = torch.clamp((r8[2] * ((1 << zq_bits) / L)).to(torch.int32), 0, (1 << zq_bits) - 1)
        if slab_sort:
            xb = torch.clamp((r8[0] * (geo.n_slabs / L)).to(torch.int32), 0, geo.n_slabs - 1)
            kq = (xb << zq_bits) | zq
        else:
            kq = zq
        kq = torch.where(ids >= 0, kq, (1 << (30 - bits_pad)) - 1)  # padding last
        packed = torch.sort((kq << bits_pad) | col).values
        order = (packed & ((1 << bits_pad) - 1)).long()
        # Permute only the data-carrying rows 0..2 (rows 3..7 are zero, and
        # rlo / vc are zero outside the extended mode).
        parts = [r8[0:3], ru8[0:3], v8[0:3], a8[0:3]]
        if extended:
            parts += [rlo[0:3], vcc[0:3]]
        stacked = torch.cat(parts, dim=0)[:, order]
        pad5 = torch.zeros((5, n_pad), dtype=dtype, device=device)

        def emb(k):
            return torch.cat([stacked[3 * k:3 * k + 3], pad5], dim=0)

        rlo2, vcc2 = (emb(4), emb(5)) if extended else (rlo, vcc)
        return emb(0), emb(1), emb(2), emb(3), ids[order], rlo2, vcc2

    def to_rows(x):
        out = torch.zeros((8, n_pad), dtype=dtype, device=device)
        out[0:3, :n] = x.T.to(device=device, dtype=dtype)
        return out

    def init(state: MDState):
        ids = torch.where(col < n, col, -1)
        zero = torch.zeros((8, n_pad), dtype=dtype, device=device)
        r8, ru8, v8, a8, ids, rlo, vcc = _sort(to_rows(state.r), to_rows(state.ru),
                                               to_rows(state.v), zero, ids, zero, zero)
        out = sweep(r8)
        tiles, tcounts = _lists(r8)
        carry = ZSortCarry(r=r8, ru=ru8, v=v8, a=accel(out), ids=ids, r_ref=r8,
                           tiles=tiles, tcounts=tcounts,
                           invalid=torch.zeros((), dtype=torch.bool, device=device),
                           rlo=rlo, vc=vcc)
        return carry, obs_from(out, 0.5 * torch.sum(v8 * v8))

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
        ekin = 0.5 * torch.sum(v_eff * v_eff)
        ru_new = c.ru + minimum_image(r_new - c.r, L)
        carry = dataclasses.replace(c, r=r_new, ru=ru_new, v=v_new, a=a_new, rlo=rlo,
                                    vc=vc_new)
        return carry, obs_from(out, ekin)

    def _resort(c: ZSortCarry) -> ZSortCarry:
        # Per-axis staleness: only travel along a sorted axis (z; x too with
        # slabs) can push a pair's gap past the window.
        d = minimum_image(c.r[0:3] - c.r_ref[0:3], L)
        valid = (c.ids >= 0).to(dtype)
        dz2 = d[2] * d[2]
        moved2 = torch.max((torch.maximum(d[0] * d[0], dz2) if slab_sort else dz2) * valid)
        invalid = c.invalid | (moved2 > geo.invalid_thresh)
        r8, ru8, v8, a8, ids, rlo, vcc = _sort(c.r, c.ru, c.v, c.a, c.ids, c.rlo, c.vc)
        tiles, tcounts = _lists(r8)
        return dataclasses.replace(c, r=r8, ru=ru8, v=v8, a=a8, ids=ids, r_ref=r8,
                                   tiles=tiles, tcounts=tcounts, rlo=rlo, vc=vcc,
                                   invalid=invalid)

    def _chunk(c: ZSortCarry, k: int, obs: bool = False):
        c = _resort(c)
        if extended:
            out = fused_dense_chunk_list(c.r, c.v, c.a, c.tiles, c.tcounts, n, L,
                                         cfg.rc_square, dt, k, tile_i=tile_i, tile_j=tile_j,
                                         r_lo=c.rlo, vc=c.vc, obs_last=obs)
            r_end, rlo_end, v, vcc, a = out[:5]
            ru = c.ru + ((r_end - c.r) + (rlo_end - c.rlo))
            r_w, rlo_w = wrap_positions_ext(r_end, rlo_end, L)
            c2 = dataclasses.replace(c, r=r_w, ru=ru, v=v, a=a, rlo=rlo_w, vc=vcc)
            return (c2, out[5]) if obs else c2
        out = fused_dense_chunk_list(c.r, c.v, c.a, c.tiles, c.tcounts, n, L,
                                     cfg.rc_square, dt, k, tile_i=tile_i, tile_j=tile_j,
                                     obs_last=obs)
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
        return c, obs_from(obs8, 0.5 * torch.sum(v_eff * v_eff))

    def get_state(c: ZSortCarry) -> MDState:
        idx = torch.where(c.ids >= 0, c.ids, n).long()

        def scatter(arr):
            out = torch.zeros((n + 1, 3), dtype=dtype, device=device)
            out[idx] = arr[0:3].T
            return out[:n]

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
    when off)."""

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


CELLPAIR_TRIGGERS = ("always", "predictive", "never")
# The unfused path's longest chunk (the JAX engine's fixed unfused chunk).
UNFUSED_MAX_CHUNK = 12
# Margin of the predictive rebin trigger on the coming chunk's travel.
_PREDICT_SAFETY = 1.25


def _cellpair_engine(cfg: SimConfig, device, z_band: bool = False, half_shell: bool = True,
                     compensated: bool | None = None, rebin_trigger: str | None = None,
                     use_fused: bool | None = None, width_lists: bool | None = None,
                     inner_chunk: int | None = None) -> Engine:
    """Pencil-sweep engine for large N (JAX ``_cellpair_engine``): pair work
    O(N * 9 * capacity) over the pencil pairs, particles rebinned into
    pencils (a sort and a gather) when they may have left the coverage slack.

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
    ``run_fast`` advances in chunks of ``inner_chunk`` (8 fused; unfused,
    by default, the most steps up to JAX's 12 in which a particle at 1.5x
    the top speed of the state the run starts from stays inside half the
    coverage slack: one host read per ``run_fast``, ``HOST_READS
    ["cellpair_chunk"]``; JAX's fixed 12 lets config 5's fastest particles
    outrun its 0.25 and sets ``pencil_overflow``) with the rebin decision
    once per chunk: ``rebin_trigger``
    "always" (the plain default: rebin before every chunk, no host read),
    "predictive" (the compensated default: rebin when a particle could
    cross half the slack during the chunk; one host read per chunk) or
    "never" (floor measurements only). ``use_fused`` (default: on with the
    half shell; the kernel launches on any card, the twin runs on the CPU)
    runs each chunk in one fused kernel, else as per-step sweeps
    (``run_fast_unfused``). ``width_lists`` (default: the JAX mean-occupancy
    rule) drives the fused chunk by occupancy-width visit lists."""
    device = resolve_device(device)
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
    if not half_shell:
        # The full sweeps' tables: the 9 xy-neighbours (self at k = 4) and
        # their static image shifts.
        nbr_tbl = torch.as_tensor(build_tile_table(grid), device=device)
        nbr_shf = torch.as_tensor(build_shift_table(grid), device=device)
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
    if width_lists is None:
        # JAX's rule (engine.py:1153-1158, measured on the TPU): width lists
        # where the 128-quantized mean occupancy leaves a whole block free.
        width_lists = bool(use_fused and (int(n / P + 8.0) + 127) // 128 < cap // 128)
    if width_lists and not use_fused:
        raise ValueError("width_lists requires the fused pencil path")
    fluid_chunk = inner_chunk is None and not use_fused
    if inner_chunk is None:
        inner_chunk = 8 if use_fused else UNFUSED_MAX_CHUNK
    zero_win = torch.zeros(((ns // TILE_I) * 9,), dtype=torch.int32, device=device)

    def sweep(pos, counts, wins, want_obs=True):
        if z_band:
            return pencil_sweep_zband(pos, nbr_tbl, counts, *wins, grid, cfg.rc_square, window,
                                      want_obs)
        if half_shell:
            # Already multiplied by the validity row (ops/pencil_sweep.py).
            return pencil_sweep_hs(pos, hs_tbl, counts, hs_shf, grid, cfg.rc_square, want_obs)
        return pencil_sweep(pos, nbr_tbl, counts, nbr_shf, grid, cfg.rc_square, want_obs)

    def windows(r8, counts):
        """The z-band's window tables and their overflow flag."""
        if not z_band:
            return (zero_win, zero_win, zero_win), torch.zeros((), dtype=torch.bool,
                                                                 device=device)
        wa, wb, ub, ovf = compute_z_windows(r8, r8[3], counts, grid, window, r_list, TILE_I)
        return (wa, wb, ub), ovf

    def accel(out):
        a = torch.zeros_like(out)
        a[0:3] = 24.0 * out[0:3]
        return a

    # The half shell counts each pair once (prefactors 4 / 24), the full
    # sweeps twice (2 / 12).
    e_pref, d_pref = (4.0, 24.0) if half_shell else (2.0, 12.0)

    def obs_from(out, ekin):
        return StepObs(epot=e_pref * torch.sum(out[3]) + e_t, ekin=ekin,
                       d_epot=d_pref * torch.sum(out[4]) + d_t,
                       dd_epot=d_pref * torch.sum(out[5]) + dd_t)

    def counts_from_valid(valid):
        return valid.reshape(P, cap).sum(dim=1).to(torch.int32)

    def lists_from_counts(counts):
        if not width_lists:
            z = torch.zeros((1,), dtype=torch.int32, device=device)
            return z, z, z, z, z
        return build_width_lists(counts, hs_tbl, hs_shf, P, cap)

    def scatter_rows(x, slot):
        out = torch.zeros((8, ns + 1), dtype=dtype, device=device)
        out[0:3, slot] = x.T.to(device=device, dtype=dtype)
        return out[:, :ns].contiguous()  # the kernels take contiguous rows

    def permute_rebin(r8, others, order, src, valid_new):
        # Two gathers (sorted order, then the structured src) of the rows
        # that carry data: coordinates and ids of r, rows 0..2 of the others;
        # validity comes from valid_new, rows 5..7 are zero throughout.
        vmask = valid_new.to(dtype)
        parts = [r8[0:3], r8[4:5]] + [o[0:3] for o in others]
        stacked = torch.cat(parts, dim=0)[:, order][:, src] * vmask[None, :]
        pad3 = torch.zeros((3, ns), dtype=dtype, device=device)
        pad5 = torch.zeros((5, ns), dtype=dtype, device=device)
        r8p = torch.cat([stacked[0:3], vmask[None, :], stacked[3:4], pad3], dim=0)
        return r8p, [torch.cat([stacked[4 + 3 * i:7 + 3 * i], pad5], dim=0)
                     for i in range(len(others))]

    def wrap_rows(r8, rc8):
        # Wrap back into [0, L) before binning; compensated: the two-float
        # wrap, whose rounding error folds into the remainder rows.
        r8 = r8.clone()
        if compensated:
            rhi, rlo = wrap_positions_ext(r8[0:3], rc8[0:3], L)
            rc8 = rc8.clone()
            r8[0:3], rc8[0:3] = rhi, rlo
        else:
            r8[0:3] = wrap_positions(r8[0:3], L)
        return r8, rc8

    def rebin(r8, others):
        """(r8p, permuted others, counts, overflow, (lists, windows)) of a
        rebin; the overflow includes the window tables'."""
        order, src, valid_new, overflow = rebin_gather_parts(r8, r8[3], grid, z_order=z_band)
        r8p, permuted = permute_rebin(r8, others, order, src, valid_new)
        r8p = sentinel_fill(r8p, r8p[3], cap)
        counts = counts_from_valid(r8p[3])
        wins, w_ovf = windows(r8p, counts)
        return r8p, permuted, counts, overflow | w_ovf, (lists_from_counts(counts), wins)

    def with_tables(c: PencilCarry, tables) -> PencilCarry:
        wl, wins = tables
        return dataclasses.replace(c, wl_self=wl[0], wl_self_cnt=wl[1], wl_nbr_i=wl[2],
                                   wl_nbr_j=wl[3], wl_nbr_off=wl[4], win_a=wins[0],
                                   win_b=wins[1], use_b=wins[2])

    def wins_of(c: PencilCarry):
        return c.win_a, c.win_b, c.use_b

    def init(state: MDState):
        state = state.to(device=device, dtype=dtype)
        slot, overflow = bin_to_slots(state.r, grid)
        r8 = scatter_rows(state.r, slot)
        valid = torch.zeros((ns + 1,), dtype=dtype, device=device)
        valid[slot] = 1.0
        ids = torch.zeros((ns + 1,), dtype=dtype, device=device)
        ids[slot] = torch.arange(n, dtype=dtype, device=device)
        r8[3], r8[4] = valid[:ns], ids[:ns]
        r8 = sentinel_fill(r8, r8[3], cap)
        v8 = scatter_rows(state.v, slot)
        counts = counts_from_valid(r8[3])
        wins, w_ovf = windows(r8, counts)
        out = sweep(r8, counts, wins)
        zero = torch.zeros_like(r8)
        carry = with_tables(PencilCarry(
            r=r8, ru=scatter_rows(state.ru, slot), v=v8, a=accel(out), r_ref=r8,
            counts=counts, win_a=None, win_b=None, use_b=None, rc=zero, vc=zero,
            overflow=overflow | w_ovf, wl_self=None, wl_self_cnt=None, wl_nbr_i=None,
            wl_nbr_j=None, wl_nbr_off=None), (lists_from_counts(counts), wins))
        return carry, obs_from(out, 0.5 * torch.sum(v8 * v8))

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
            d = minimum_image(r_new[drift_rows] - c.r_ref[drift_rows], L)
            moved = torch.max(torch.sum(d * d, dim=0) * r_new[3]) > rebuild_thresh
            HOST_READS["cellpair_moved"] += 1
            rebin_mode = "force" if bool(moved) else False
        if rebin_mode == "force":
            r8, rc8 = wrap_rows(c.r, c.rc)
            r8p, perm, counts, ovf, tables = rebin(
                r8, [c.ru, c.v] + ([rc8, c.vc] if compensated else []))
            c = with_tables(dataclasses.replace(
                c, r=r8p, ru=perm[0], v=perm[1],
                rc=perm[2] if compensated else torch.zeros_like(r8p),
                vc=perm[3] if compensated else c.vc, r_ref=r8p, counts=counts,
                overflow=c.overflow | ovf), tables)
        out = sweep(c.r, c.counts, wins_of(c), want_obs)
        a_new = accel(out)
        if compensated:
            v_new, vc_new = comp_add(c.v, c.vc, a_new * half_dt)
            v_eff = v_new + vc_new
        else:
            v_new, vc_new = c.v + a_new * half_dt, c.vc
            v_eff = v_new
        c = dataclasses.replace(c, v=v_new, vc=vc_new, a=a_new)
        return c, obs_from(out, 0.5 * torch.sum(v_eff * v_eff))

    def _rebin_carry(c: PencilCarry) -> PencilCarry:
        # a rides along: the next chunk's first half-kick uses it.
        r8, rc8 = wrap_rows(c.r, c.rc)
        r8p, perm, counts, ovf, tables = rebin(
            r8, [c.ru, c.v, c.a] + ([rc8, c.vc] if compensated else []))
        return with_tables(dataclasses.replace(
            c, r=r8p, ru=perm[0], v=perm[1], a=perm[2],
            rc=perm[3] if compensated else torch.zeros_like(r8p),
            vc=perm[4] if compensated else c.vc, r_ref=r8p, counts=counts,
            overflow=c.overflow | ovf), tables)

    def _invalid_check(c: PencilCarry):
        """Sticky flag for drift past the coverage slack since the last
        rebin (pairs may have been missed in the last chunk); no host read.
        Returns (carry, per-slot squared xy drift)."""
        d = minimum_image(c.r[drift_rows] - c.r_ref[drift_rows], L)
        moved2 = torch.sum(d * d, dim=0) * c.r[3]
        return dataclasses.replace(
            c, overflow=c.overflow | (torch.max(moved2) > rebuild_thresh)), moved2

    def _maybe_rebin(c: PencilCarry, k: int) -> PencilCarry:
        valid = c.r[3]
        c, moved2 = _invalid_check(c)
        if rebin_trigger == "never":
            return c
        if rebin_trigger == "always":
            return _rebin_carry(c)
        speed = torch.sqrt(torch.sum(c.v[drift_rows] * c.v[drift_rows], dim=0))
        predicted = torch.sqrt(moved2) + speed * (k * dt * _PREDICT_SAFETY)
        will_exceed = torch.max(predicted * valid) > 0.5 * slack
        HOST_READS["cellpair_will_exceed"] += 1
        return _rebin_carry(c) if bool(will_exceed) else c

    def _chunk(c: PencilCarry, k: int) -> PencilCarry:
        c = _maybe_rebin(c, k)
        ext = {"r_lo": c.rc, "vc": c.vc} if compensated else {}
        if width_lists:
            out = fused_pencil_width_chunk(c.r, c.v, c.a, c.wl_self, c.wl_self_cnt,
                                           c.wl_nbr_i, c.wl_nbr_j, c.wl_nbr_off, P, cap, L,
                                           cfg.rc_square, dt, k, **ext)
        else:
            out = fused_pencil_chunk(c.r, c.v, c.a, hs_tbl, hs_shf, P, cap, L,
                                     cfg.rc_square, dt, k, **ext)
        if compensated:
            r_end, rc_end, v_new, vc_new, a_new = out
            ru = c.ru + ((r_end - c.r) + (rc_end - c.rc)) * xyz_mask
            return dataclasses.replace(c, r=r_end, ru=ru, v=v_new, a=a_new, rc=rc_end,
                                       vc=vc_new)
        r_end, v_new, a_new = out
        # No wrap inside the chunk: the unwrap update is the slot-space drift.
        return dataclasses.replace(c, r=r_end, ru=c.ru + (r_end - c.r) * xyz_mask, v=v_new,
                                   a=a_new)

    def _unfused_chunk(c: PencilCarry, k: int) -> PencilCarry:
        start = 0
        if rebin_trigger == "always":
            # The rebin folds into step 1, after its drift and half-kick.
            c, _ = _invalid_check(c)
            c, _ = _step(c, False, "force")
            start = 1
        else:
            c = _maybe_rebin(c, k)
        for _ in range(start, k):
            c, _ = _step(c, False, False)
        return c

    def _top_speed(c: PencilCarry) -> float:
        v = (c.v + c.vc if compensated else c.v)[drift_rows]
        HOST_READS["cellpair_chunk"] += 1
        return float(torch.sqrt(torch.max(torch.sum(v * v, dim=0))))

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
        wrapped back into [0, L)."""
        ids = torch.where(c.r[3] > 0.5, c.r[4].to(torch.int64), n)

        def gather(arr):
            out = torch.zeros((n + 1, 3), dtype=dtype, device=device)
            out[ids] = arr[0:3].T
            return out[:n]

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


def make_engine(cfg: SimConfig, backend: str = "auto", device="cuda", state=None,
                sample_interval: int | None = None) -> Engine:
    """Build the engine for ``cfg`` on ``device`` (default the card; raises
    where there is none): one of ``BACKENDS`` (``"pallas"`` is the JAX
    package's name for ``"rows"``; ``"auto"`` is ``auto_backend``).
    ``sample_interval`` (the production loop's ``output_interval``) aligns
    the zsort inner chunk to it. ``state`` (a representative MDState, e.g.
    the post-warmup one) sizes the cell-pair engine's pencil capacity from
    its occupancy census when ``cfg.neighbor_capacity`` is unset (JAX
    ``_cellpair_tuned``)."""
    device = resolve_device(device)
    if backend == "auto":
        backend = auto_backend(cfg, device.type == "cuda", sample_interval)
    if backend in ("rows", "pallas"):
        return _rows_engine(cfg, device)
    if backend == "zsort":
        return _zsort_engine(cfg, device, **_zsort_kwargs(sample_interval))
    if backend == "cellpair":
        if state is not None and not cfg.neighbor_capacity:
            cfg = cfg.replace(neighbor_capacity=capacity_from_state(
                cfg.box_length, cfg.rc + cfg.neighbor_skin, state.r))
        return _cellpair_engine(cfg, device)
    if backend == "neighbor":
        return _neighbor_engine(cfg, device)
    if backend == "dense":
        return _force_engine(cfg, device)
    raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
