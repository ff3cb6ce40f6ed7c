"""Particle-axis sharding of the pencil (cell-column) engine over a rank
mesh (counterpart of ``ljmd_tpu/parallel/spatial_pencil.py``).

The global slot matrix (8, n_slots) is laid out x-major (pencil
p = ix * m + iy), so rank s holds a contiguous strip of m / d pencil
x-columns (``m_xy % d == 0``). The half-shell sweep needs the +x neighbour
column only, so each step a rank:

- receives ONE halo strip, the next rank's first x-column (``ppermute(-1)``);
- sweeps its strip plus the halo with ``pencil_sweep_hs(...,
  n_pencils_i=p_loc)`` (``ops/pencil_sweep.py``: ``csrc/pencil_sweep_hs.cu``
  on the card, its plain twin on CPU tensors; i over the strip, j over strip
  and halo, the strip-local tables, this rank's image shifts);
- sends the halo's reactions back (``ppermute(+1)``) and adds them in.

The scalar observables are ``psum``-ed. A rank's ``counts`` covers its
strip and the halo (the halo's counts change only at a rebin, when every
rank sees the global counts), which the sweep's tile gates read.

The rebin is global, as in JAX (where XLA partitions the sorts): the slot
rows are gathered, ``ops/cell_list.py::rebin_gather_parts`` runs once
(``mesh.on_root``: under ``DistMesh`` on rank 0, its permutation sent to
every rank), and each rank takes its strip of the permuted rows. The rebin
decisions are the JAX engine's: per step, a rebin when a particle moved more
than skin / 2 since the last one (``moved``); in ``run_fast``, per chunk of
``inner_chunk`` steps, the sticky overflow check and the trigger ``always``
(plain default), ``predictive`` (compensated default: a rebin when a
particle could cross skin / 2 within the chunk) or ``never``. Each decision
is a ``pmax`` over the ranks, then one host read of the flag, counted in
``engine.HOST_READS`` (JAX takes it inside ``lax.cond``).

The drift check is JAX's: 3-D against skin / 2, tighter than the
single-device engine's xy slack, so a chunk must be short enough that no
particle outruns skin / 2 in it. JAX fixes the chunk at 8 steps, which sets
``pencil_overflow`` at BASELINE config 5 (dt = 0.005, skin / 2 = 0.2). Here
the default chunk follows the fluid: each ``run_fast`` takes the most steps,
at most 8, in which a particle at ``engine.CHUNK_SPEED_MARGIN`` times the top speed
of the state it starts from stays within skin / 2 (a ``pmax``, one host read
in ``HOST_READS["sharded_pencil_chunk"]``).

``run_fast`` advances each chunk in one ``mesh.run``: k steps of halo
exchange, local sweep and reaction return. The TPU's VMEM budget for the
mono kernel (``pencil_mono_viable``) has no counterpart on the card.

Precision follows the single-device engines: f32 at dt <= 1e-3 (or with
``compensated_sum``) integrates with Neumaier compensation; compensated
rebins use the two-float wrap and permute the remainder rows with the slots.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models.engine import (
    _PREDICT_SAFETY,
    CELLPAIR_TRIGGERS,
    Engine,
    _effective_dtype,
    chunk_from_speed,
    host_read,
)
from ljmd_tpu_torch.ops.cell_list import bin_to_slots, make_pencil_grid, rebin_gather_parts
from ljmd_tpu_torch.ops.fused import comp_add, wrap_positions_ext
from ljmd_tpu_torch.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu_torch.ops.lj import tail_corrections
from ljmd_tpu_torch.ops.pencil_sweep import _HALF_SHELL, pencil_sweep_hs, sentinel_fill
from ljmd_tpu_torch.state import MDState, StepObs

__all__ = ["ShardedPencilCarry", "augmented_counts", "default_inner_chunk",
           "make_sharded_pencil_engine"]

# The default chunk's bounds: JAX's fixed chunk, and the margin over the top
# speed of the state a ``run_fast`` starts from (within a sample interval an
# equilibrium fluid's top speed grows far less; a fluid still heating up can
# grow faster, hence a margin and not a fixed chunk).
MAX_INNER_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class ShardedPencilCarry:
    """One rank's carry: its strip of every (8, n_slots) field, (8,
    p_loc * capacity). Rows 0..2 = x/y/z; in ``r`` row 3 = validity, row 4 =
    particle id. ``r_ref``: positions at the last rebin; ``rc`` / ``vc``:
    Neumaier compensation terms (zeros when off); ``counts``: the occupancy
    of the strip's pencils and then of the halo's, (p_loc + m,) int32;
    ``overflow``: the sticky capacity / displacement flag (the same on
    every rank)."""

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    r_ref: torch.Tensor
    rc: torch.Tensor
    vc: torch.Tensor
    counts: torch.Tensor
    overflow: torch.Tensor


def _local_half_shell_table(m: int, m_xl: int) -> np.ndarray:
    """(P_loc * 4,) int32 neighbour ids in the LOCAL augmented pencil space:
    local pencils 0..P_loc-1 (p = lx * m + iy), halo pencils P_loc..P_loc+m-1
    (the next rank's first x-column). The same on every rank."""
    p_loc = m_xl * m
    tbl = np.empty(p_loc * 4, dtype=np.int32)
    for lx in range(m_xl):
        for iy in range(m):
            p = lx * m + iy
            for k, (dx, dy) in enumerate(_HALF_SHELL):
                gy = (iy + dy) % m
                gx = lx + dx
                tbl[p * 4 + k] = gx * m + gy if gx < m_xl else p_loc + gy
    return tbl


def _device_shift_tables(m: int, m_xl: int, d: int) -> np.ndarray:
    """(d, P_loc*4*2) int32 xy image shifts (units of L) of each rank's
    strip: only the strip that holds the global x = L face wraps in x (the
    half-shell dx is 0 or 1, never negative)."""
    p_loc = m_xl * m
    shf = np.zeros((d, p_loc, 4, 2), dtype=np.int32)
    for s in range(d):
        for lx in range(m_xl):
            for iy in range(m):
                p = lx * m + iy
                gx = s * m_xl + lx
                for k, (dx, dy) in enumerate(_HALF_SHELL):
                    shf[s, p, k, 0] = 1 if gx + dx >= m else 0
                    shf[s, p, k, 1] = -1 if iy + dy < 0 else (1 if iy + dy >= m else 0)
    return shf.reshape(d, -1)


def augmented_counts(counts: torch.Tensor, m: int, d: int) -> list:
    """Every rank's (p_loc + m,) counts, in rank order, from the global
    (m * m,) counts: its strip's, then its halo's (the next rank's first
    x-column)."""
    p_loc = counts.numel() // d
    return [torch.cat([counts[s * p_loc:(s + 1) * p_loc],
                       counts[((s + 1) % d) * p_loc:((s + 1) % d) * p_loc + m]])
            for s in range(d)]


def default_inner_chunk(cfg: SimConfig, top_speed: float) -> int:
    """The most steps, at most ``MAX_INNER_CHUNK`` and at least 1, in which
    a particle at ``CHUNK_SPEED_MARGIN * top_speed`` moves less than skin / 2."""
    return chunk_from_speed(cfg.dt, 0.5 * cfg.neighbor_skin, top_speed, MAX_INNER_CHUNK)


def make_sharded_pencil_engine(cfg: SimConfig, mesh, compensated: bool | None = None,
                               inner_chunk: int | None = None,
                               rebin_trigger: str | None = None) -> Engine:
    """Engine with the half-shell pencil sweep sharded over ``mesh``
    (module docstring). The pencil grid's x-column count must divide over
    the ranks (m_xy % d == 0); d == 1 works too (the halo is the rank's own
    first column). ``inner_chunk`` is the steps per ``run_fast`` chunk
    (default: ``default_inner_chunk`` of the state each ``run_fast`` starts
    from). Its carry is the tuple of the local ranks'
    ``ShardedPencilCarry``."""
    d = mesh.size
    dev = mesh.device
    L = cfg.box_length
    if L <= 1.0:
        raise ValueError("sharded pencil engine requires L > 1")
    skin = cfg.neighbor_skin
    grid = make_pencil_grid(cfg.n, L, cfg.rc + skin, cfg.density, cfg.neighbor_capacity)
    m = grid.m_xy
    if m % d != 0:
        raise ValueError(f"pencil grid {m}x{m} does not split over {d} ranks "
                         "(m_xy % d != 0); choose a divisor axis size")
    m_xl = m // d
    p_loc = m_xl * m
    cap, ns, n = grid.capacity, grid.n_slots, cfg.n
    w_loc = p_loc * cap
    dtype = _effective_dtype(cfg)
    if compensated is None:
        compensated = (cfg.compensated_sum or cfg.dt <= 1.0e-3) and dtype == torch.float32
    if rebin_trigger is None:
        rebin_trigger = "predictive" if compensated else "always"
    if rebin_trigger not in CELLPAIR_TRIGGERS:
        raise ValueError(f"unknown rebin trigger {rebin_trigger!r}")
    tbl = torch.as_tensor(_local_half_shell_table(m, m_xl), device=dev)
    shf_all = _device_shift_tables(m, m_xl, d)
    shf_loc = [torch.as_tensor(shf_all[s], device=dev) for s in mesh.local_ranks]
    e_t, d_t, dd_t = (tail_corrections(n, cfg.volume, cfg.rc) if cfg.use_tail_corrections
                      else (0.0, 0.0, 0.0))
    xyz_mask = torch.zeros((8, 1), dtype=dtype, device=dev)
    xyz_mask[0:3] = 1.0
    rc_sq = cfg.rc_square
    dt, half_dt, half_dt_sq = cfg.dt, 0.5 * cfg.dt, 0.5 * cfg.dt * cfg.dt
    rebuild_thresh = (0.5 * skin) ** 2

    # ------------------------------------------------------------------
    # The rank-local force sweep: (f rows without the 24 prefactor, e, du,
    # ddu over the strip's pair-once pairs).
    # ------------------------------------------------------------------
    def _local_force(comm, r_loc, counts, shf, want_obs: bool):
        """One halo exchange, the local sweep, the reaction return."""
        halo = comm.ppermute(r_loc[:, :m * cap], -1)
        r_aug = torch.cat([r_loc, halo], dim=1)
        # Already multiplied by the validity row (ops/pencil_sweep.py).
        out_aug = pencil_sweep_hs(r_aug, tbl, counts, shf, grid, rc_sq, want_obs,
                                  n_pencils_i=p_loc)
        f_back = comm.ppermute(out_aug[:, w_loc:], 1)
        out = out_aug[:, :w_loc].clone()
        out[:, :m * cap] += f_back
        if want_obs:
            e, du, ddu = out[3].sum(), out[4].sum(), out[5].sum()
        else:
            e = du = ddu = torch.zeros((), dtype=dtype, device=dev)
        return out * xyz_mask, e, du, ddu

    def _force_obs(comm, c: ShardedPencilCarry, shf, want_obs: bool):
        """(a rows, (epot, d_epot, dd_epot)) at c.r, summed over the ranks."""
        f_rows, e, du, ddu = _local_force(comm, c.r, c.counts, shf, want_obs)
        if want_obs:
            e, du, ddu = comm.psum(e), comm.psum(du), comm.psum(ddu)
        return 24.0 * f_rows, (4.0 * e + e_t, 24.0 * du + d_t, 24.0 * ddu + dd_t)

    def _ekin(comm, v, vc):
        v_eff = v + vc if compensated else v
        return comm.psum(0.5 * torch.sum(v_eff * v_eff))

    # ------------------------------------------------------------------
    # Global layout: binning, rebin, strips.
    # ------------------------------------------------------------------
    def _counts_from_valid(valid):
        return valid.reshape(grid.n_pencils, cap).sum(dim=1).to(torch.int32)

    def _local_counts(counts):
        every = augmented_counts(counts, m, d)
        return [every[s] for s in mesh.local_ranks]

    def _scatter_rows(x, slot):
        out = torch.zeros((8, ns + 1), dtype=dtype, device=dev)
        out[0:3, slot] = x.T.to(device=dev, dtype=dtype)
        return out[:, :ns].contiguous()

    def _strips(**fields) -> list:
        """Per local rank, a dict of its strip of each global field."""
        cut = {k: mesh.split(v, 1) for k, v in fields.items()}
        return [{k: cut[k][i] for k in fields} for i in range(len(mesh.local_ranks))]

    def _rebin(carries) -> tuple:
        """Gather-form global rebin (the single-device engine's and JAX's
        ``_rebin``): the new per-rank carries."""
        r8, ru8, v8, a8, rc8, vc8 = (mesh.gather([getattr(c, k) for c in carries], 1)
                                     for k in ("r", "ru", "v", "a", "rc", "vc"))
        r8 = r8.clone()
        if compensated:
            rc8 = rc8.clone()
            r8[0:3], rc8[0:3] = wrap_positions_ext(r8[0:3], rc8[0:3], L)
        else:
            r8[0:3] = wrap_positions(r8[0:3], L)
        order, src, valid_new, ovf = mesh.on_root(
            lambda: rebin_gather_parts(r8, r8[3], grid))
        vmask = valid_new.to(dtype)
        parts = [r8[0:3], r8[4:5], ru8[0:3], v8[0:3], a8[0:3]] + (
            [rc8[0:3], vc8[0:3]] if compensated else [])
        stacked = torch.cat(parts, dim=0)[:, order][:, src] * vmask[None, :]
        pad3 = torch.zeros((3, ns), dtype=dtype, device=dev)
        pad5 = torch.zeros((5, ns), dtype=dtype, device=dev)
        r8p = torch.cat([stacked[0:3], vmask[None, :], stacked[3:4], pad3], dim=0)
        r8p = sentinel_fill(r8p, vmask, cap)

        def emb(i):
            return torch.cat([stacked[4 + 3 * i:7 + 3 * i], pad5], dim=0)

        rc8p = emb(3) if compensated else torch.zeros_like(r8p)
        vc8p = emb(4) if compensated else vc8
        strips = _strips(r=r8p, ru=emb(0), v=emb(1), a=emb(2), rc=rc8p, vc=vc8p)
        counts = _local_counts(_counts_from_valid(vmask))
        return tuple(ShardedPencilCarry(r_ref=s["r"], counts=cnt, overflow=c.overflow | ovf,
                                        **s)
                     for c, s, cnt in zip(carries, strips, counts))

    # ------------------------------------------------------------------
    # Engine entry points.
    # ------------------------------------------------------------------
    def _init_local(comm, c, shf):
        a8, (epot, d_epot, dd_epot) = _force_obs(comm, c, shf, True)
        return (dataclasses.replace(c, a=a8),
                StepObs(epot=epot, ekin=_ekin(comm, c.v, c.vc), d_epot=d_epot, dd_epot=dd_epot))

    def init(state: MDState):
        state = state.to(device=dev, dtype=dtype)
        slot, overflow = mesh.on_root(lambda: bin_to_slots(state.r, grid))
        r8 = _scatter_rows(state.r, slot)
        valid = torch.zeros((ns + 1,), dtype=dtype, device=dev)
        valid[slot] = 1.0
        ids = torch.zeros((ns + 1,), dtype=dtype, device=dev)
        ids[slot] = torch.arange(n, dtype=dtype, device=dev)
        r8[3], r8[4] = valid[:ns], ids[:ns]
        r8 = sentinel_fill(r8, r8[3], cap)
        zero = torch.zeros_like(r8)
        strips = _strips(r=r8, ru=_scatter_rows(state.ru, slot), v=_scatter_rows(state.v, slot),
                         a=zero, rc=zero, vc=zero)
        carries = [ShardedPencilCarry(r_ref=s["r"], counts=cnt, overflow=overflow, **s)
                   for s, cnt in zip(strips, _local_counts(_counts_from_valid(r8[3])))]
        outs = mesh.run(_init_local, carries, shf_loc)
        return tuple(c for c, _ in outs), outs[0][1]

    def _drift_local(comm, c: ShardedPencilCarry):
        """First half of a step: drift and half kick; the global max of the
        squared displacement since the last rebin."""
        delta = (c.v * dt + c.a * half_dt_sq) * xyz_mask
        if compensated:
            r_new, rc_new = comp_add(c.r, c.rc, delta)
            v_half, vc_half = comp_add(c.v, c.vc, c.a * half_dt)
        else:
            r_new, rc_new = c.r + delta, c.rc
            v_half, vc_half = c.v + c.a * half_dt, c.vc
        dsp = minimum_image(r_new[0:3] - c.r_ref[0:3], L)
        moved = comm.pmax(torch.max(torch.sum(dsp * dsp, dim=0) * r_new[3]))
        return (dataclasses.replace(c, r=r_new, ru=c.ru + delta, v=v_half, rc=rc_new,
                                    vc=vc_half), moved > rebuild_thresh)

    def _kick_local(comm, c: ShardedPencilCarry, shf, want_obs: bool):
        """Second half: forces at the new positions, the second half kick."""
        a_new, (epot, d_epot, dd_epot) = _force_obs(comm, c, shf, want_obs)
        if compensated:
            v_new, vc_new = comp_add(c.v, c.vc, a_new * half_dt)
        else:
            v_new, vc_new = c.v + a_new * half_dt, c.vc
        ekin = (_ekin(comm, v_new, vc_new) if want_obs
                else torch.zeros((), dtype=dtype, device=dev))
        return (dataclasses.replace(c, a=a_new, v=v_new, vc=vc_new),
                StepObs(epot=epot, ekin=ekin, d_epot=d_epot, dd_epot=dd_epot))

    def _step(carries, want_obs: bool):
        outs = mesh.run(_drift_local, carries)
        carries = tuple(c for c, _ in outs)
        if host_read("sharded_pencil_moved", outs[0][1]):
            carries = _rebin(carries)
        outs = mesh.run(_kick_local, carries, shf_loc, [want_obs] * len(carries))
        return tuple(c for c, _ in outs), outs[0][1]

    def _check_local(comm, c: ShardedPencilCarry, k: int):
        """Sticky flag for drift past skin / 2 since the last rebin, and the
        predictive trigger's flag for the coming k steps."""
        valid = c.r[3]
        dsp = minimum_image(c.r[0:3] - c.r_ref[0:3], L)
        moved2 = torch.sum(dsp * dsp, dim=0) * valid
        c = dataclasses.replace(c, overflow=c.overflow | (comm.pmax(torch.max(moved2))
                                                          > rebuild_thresh))
        if rebin_trigger != "predictive":
            return c, None
        speed = torch.sqrt(torch.sum(c.v[0:3] * c.v[0:3], dim=0))
        predicted = torch.sqrt(moved2) + speed * (k * dt * _PREDICT_SAFETY)
        return c, comm.pmax(torch.max(predicted * valid)) > 0.5 * skin

    def _chunk_local(comm, c: ShardedPencilCarry, shf, k: int):
        r, ru, v, a, rc_, vc_ = c.r, c.ru, c.v, c.a, c.rc, c.vc
        for _ in range(k):
            delta = (v * dt + a * half_dt_sq) * xyz_mask
            if compensated:
                r, rc_ = comp_add(r, rc_, delta)
                v, vc_ = comp_add(v, vc_, a * half_dt)
            else:
                r, v = r + delta, v + a * half_dt
            ru = ru + delta
            f_rows, _, _, _ = _local_force(comm, r, c.counts, shf, False)
            a = 24.0 * f_rows
            if compensated:
                v, vc_ = comp_add(v, vc_, a * half_dt)
            else:
                v = v + a * half_dt
        return dataclasses.replace(c, r=r, ru=ru, v=v, a=a, rc=rc_, vc=vc_)

    def _chunk(carries, k: int):
        outs = mesh.run(_check_local, carries, [k] * len(carries))
        carries = tuple(c for c, _ in outs)
        if rebin_trigger == "always" or (
                rebin_trigger == "predictive"
                and host_read("sharded_pencil_will_exceed", outs[0][1])):
            carries = _rebin(carries)
        return tuple(mesh.run(_chunk_local, carries, shf_loc, [k] * len(carries)))

    def _top_speed_local(comm, c: ShardedPencilCarry):
        v = c.v + c.vc if compensated else c.v
        return comm.pmax(torch.sqrt(torch.max(torch.sum(v[0:3] * v[0:3], dim=0))))

    def run_fast(carries, n_steps: int):
        k = inner_chunk
        if k is None and n_steps > 0:
            top = mesh.run(_top_speed_local, carries)[0]
            k = default_inner_chunk(cfg, host_read("sharded_pencil_chunk", top, float))
        full, rem = divmod(n_steps, k)
        for _ in range(full):
            carries = _chunk(carries, k)
        if rem:
            carries = _chunk(carries, rem)
        return carries

    def get_state(carries) -> MDState:
        r8 = mesh.gather([c.r for c in carries], 1)
        ids = torch.where(r8[3] > 0.5, r8[4].to(torch.int64), n)

        def gather(rows):
            out = torch.zeros((n + 1, 3), dtype=dtype, device=dev)
            out[ids] = rows[0:3].T
            return out[:n]

        v8 = [c.v + c.vc if compensated else c.v for c in carries]
        return MDState(r=wrap_positions(gather(r8), L),
                       ru=gather(mesh.gather([c.ru for c in carries], 1)),
                       v=gather(mesh.gather(v8, 1)),
                       a=gather(mesh.gather([c.a for c in carries], 1)))

    return Engine(init=init, step=lambda c: _step(c, True), get_state=get_state,
                  diagnostics=lambda c: {"pencil_overflow": c[0].overflow},
                  step_fast=lambda c: _step(c, False), run_fast=run_fast)
