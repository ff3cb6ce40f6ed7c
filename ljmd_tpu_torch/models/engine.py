"""Engine abstraction: a (carry, step) pair for the MD time loop
(counterpart of ``ljmd_tpu/models/engine.py:36-90, 160-932, 1677-1794``).

Backends:

- ``"dense"``: the ``ops/lj.py`` oracle with the plain Verlet step; its carry
  is the MDState itself.
- ``"rows"``: the rows engine (JAX's ``"pallas"`` backend). Its carry is a
  ``RowCarry`` of (8, n_pad) row matrices; sampled steps run the tri sweep
  (``ops/pair_sweep.py``) and un-sampled stretches run fused multi-step
  chunks (``ops/fused.py``), each one CUDA launch on the card.
- ``"zsort"``: the z-sorted window-list engine. Its carry is a
  ``ZSortCarry``: the rows in sorted column order, the particle ids, and the
  visit lists. Every inner chunk it re-sorts, rebuilds the tile flags and
  the visit lists (``ops/window_lists.py``) and runs one fused list chunk
  (``ops/fused_list.py``); sampled cycles end in the chunk's ``obs_last``
  step (``run_sample``).
- ``"auto"``: ``auto_backend``: on a CUDA device the JAX package's
  accelerator routing (``zsort`` where it fits, else ``rows``); on the CPU
  ``rows``.

The cell-pair and neighbor engines are not ported yet; asking for them
raises ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models.forces import make_force_fn
from ljmd_tpu_torch.models.integrators import velocity_verlet_step
from ljmd_tpu_torch.ops.fused import (
    MAX_CHUNK_STEPS,
    comp_add,
    fused_dense_chunk,
    fused_dense_chunk_ext,
    wrap_positions_ext,
)
from ljmd_tpu_torch.ops.fused_list import fused_dense_chunk_list
from ljmd_tpu_torch.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu_torch.ops.lj import tail_corrections
from ljmd_tpu_torch.ops.pair_sweep import pair_sweep_tri
from ljmd_tpu_torch.ops.window_lists import build_window_lists, compute_tile_flags
from ljmd_tpu_torch.state import MDState, StepObs, kinetic_energy

__all__ = ["Engine", "RowCarry", "ROW_PAD", "ZSortCarry", "auto_backend",
           "make_engine", "resolve_device", "zsort_geometry"]

# Columns of the row layout are padded to a multiple of this (the kernels
# take blocks of 32 particles; 128 also matches the JAX package's minimum).
ROW_PAD = 128

_NOT_PORTED = {
    "cellpair": "ROADMAP.md Open items §1.9 (cellpair pencil engine)",
    "neighbor": "ROADMAP.md Open items §1.10 (neighbor engine)",
}


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


def resolve_device(device) -> torch.device:
    """``torch.device`` of ``device``; raises when CUDA is asked for and no
    CUDA device is present (nothing silently runs on another device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def _effective_dtype(cfg: SimConfig) -> torch.dtype:
    """The dtype tensors get: the config's own. (The JAX package truncates a
    float64 config to float32 when x64 is off, as on the TPU; PyTorch and
    the H100 run float64 natively, so nothing truncates here and the
    precision policy follows the requested dtype.)"""
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _force_engine(cfg: SimConfig, device) -> Engine:
    force_fn = make_force_fn(cfg)
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


def _rows_engine(cfg: SimConfig, device, compensated: bool | None = None) -> Engine:
    """Dense rows engine: (N, 3) <-> (8, n_pad) conversion only at
    init/get_state; every step is row-matrix elementwise work plus the
    pair sweep; un-sampled stretches run in fused chunks of at most
    ``MAX_CHUNK_STEPS`` steps."""
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

    def sweep(pos: torch.Tensor, want_obs: bool = True) -> torch.Tensor:
        return pair_sweep_tri(pos, n, L, cfg.rc_square, want_observables=want_obs)

    def obs_from(out: torch.Tensor, ekin: torch.Tensor) -> StepObs:
        # The tri sweep counts each pair once: prefactors 4 / 24.
        return StepObs(
            epot=4.0 * torch.sum(out[3]) + e_t,
            ekin=ekin,
            d_epot=24.0 * torch.sum(out[4]) + d_t,
            dd_epot=24.0 * torch.sum(out[5]) + dd_t,
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


def _cellpair_viable(cfg: SimConfig) -> bool:
    return int(cfg.box_length // (cfg.rc + cfg.neighbor_skin)) >= 3


def auto_backend(cfg: SimConfig, on_accelerator: bool,
                 sample_interval: int | None = None) -> str:
    """The backend ``"auto"`` picks. On an accelerator, the JAX package's
    accelerator branch (``engine.py:1763-1790``): zsort when the window
    lists fit ((n_pad/128)^2 <= 32768), L > 4 rc and the engine accepts the
    config; else the cell-pair engine at n >= 8192 where it fits, which is
    not ported, so that branch falls to ``rows``; else zsort without its
    fused path where it builds; else rows. On the CPU: rows."""
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
        return "rows"  # JAX: cellpair (not ported, ROADMAP.md §1.9)
    return "zsort" if zsort_ok else "rows"


def make_engine(cfg: SimConfig, backend: str = "auto", device="cpu", state=None,
                sample_interval: int | None = None) -> Engine:
    """Build the engine for ``cfg`` on ``device``: ``"dense"``, ``"rows"``,
    ``"zsort"`` or ``"auto"`` (``auto_backend``). ``sample_interval`` (the
    production loop's ``output_interval``) aligns the zsort inner chunk to it.
    ``state`` sizes the cell-pair engine's capacity in the JAX package; the
    port has no cell-pair engine yet and does not read it."""
    del state
    device = resolve_device(device)
    if backend in _NOT_PORTED:
        raise NotImplementedError(
            f"backend {backend!r} is not ported to ljmd_tpu_torch yet: "
            f"{_NOT_PORTED[backend]}"
        )
    if backend == "auto":
        backend = auto_backend(cfg, device.type == "cuda", sample_interval)
    if backend == "rows":
        return _rows_engine(cfg, device)
    if backend == "zsort":
        return _zsort_engine(cfg, device, **_zsort_kwargs(sample_interval))
    if backend == "dense":
        return _force_engine(cfg, device)
    raise ValueError(f"unknown backend {backend!r}; expected auto, rows, zsort or dense")
