"""Pencil sweeps of the cell-pair engine (counterpart of
``ljmd_tpu/ops/pallas_pencil2.py``: ``pallas_pencil_sweep_hs`` and
``pallas_pencil_sweep_mono``, which compute one function; and of
``ljmd_tpu/ops/pallas_pencil.py``: ``pallas_pencil_sweep`` and
``pallas_pencil_sweep_zband``).

Slot layout (``ops/cell_list.py``): (8, n_slots) rows, x/y/z in rows 0..2,
row 3 the slot validity (1/0), row 4 the particle id. Empty slots carry
sentinel coordinates (``sentinel_fill``: x = SENT_BASE * (1 + pencil) + rank,
y = z = 0), so a sentinel never passes the cutoff against a real particle or
against another pencil's sentinels.

The half-shell sweep (``pencil_sweep_hs``, the engine's default) has the JAX
kernel's pair set: each pencil against itself (slot triangular, each
in-pencil pair once) and against its 4 upper xy-neighbours
``(0,1), (1,-1), (1,0), (1,1)`` (``build_half_shell_tables``), whose
coordinates are shifted by a static image offset in x/y (z keeps its
minimum-image round). Output (8, n_slots):

- rows 0..2: force on each slot WITHOUT the 24 prefactor;
- rows 3..5: the e / du / ddu partials of each pair, summed on its i side
  (pair once: totals restore with the prefactors 4 / 24);
- rows 6..7 zero, and every row already multiplied by the validity row
  (the JAX kernel leaves that multiply to its caller).

The kernel and its twin sweep it block by block: each 128-slot block of a
pencil meets, from its own side, the stages of its pencil, of its 4 upper
neighbours and of the 4 pencils whose upper neighbour it is
(``half_shell_lower``, the inverse table, which the wrapper builds once per
table and keeps), a stage only where its first rank is below the partner
pencil's count (``hs_stage_plan``; the stages past it hold only sentinels).

``n_pencils_i`` (the mono kernel's contract, for a strip of the sharded
engine, ``parallel/spatial_pencil.py``): the slot matrix holds more pencils
than the tables have rows, a strip of ``n_pencils_i`` i pencils and after it a
halo; i runs over the first ``n_pencils_i`` pencils (the tables' rows), j over
any pencil of the matrix, and the output has the matrix's full width (the
halo's columns hold the reactions of the strip's pairs). ``counts`` then
covers every pencil of the matrix, halo included (the halo's counts travel
with the halo); the JAX kernel reads the i pencils' counts only, and gating
a pair on an empty j pencil drops nothing but sentinel pairs.

The full 9-neighbour sweeps count each pair twice, from each of its slots
(prefactors 2 / 12), with the mask r^2 < rc^2, gi != gj, v_i * v_j > 0.5,
so invalid slots are exactly 0 with no multiply afterwards; i-slices at or
past a pencil's count and empty partner pencils are skipped:

- ``pencil_sweep``: every slot of the 9 xy-neighbours (``build_tile_table``,
  the pencil itself at k = 4), x/y shifted by the static image shifts of
  ``build_shift_table``, z rounded. A partner stage of 128 ranks at or past
  the partner pencil's count holds only invalid slots: ``full_stage_plan``
  lists the stages left, which the kernel and the twin sweep;
- ``pencil_sweep_zband``: per (128-slot i-slice, neighbour), only the
  ``window`` ranks from ``start_a`` and, under ``use_b``, those from
  ``start_b`` that window A does not hold (``compute_z_windows``; ranks
  z-sorted), with the full minimum image in x, y and z. Windows are whole
  128-rank stages, so the dedupe and the partner's count each mask whole
  stages: ``zband_stage_plan`` lists the stages left, which the kernel and
  the twin sweep.

Each wrapper launches its ``csrc/`` kernel on CUDA tensors (``pencil_sweep_hs.cu``,
``pencil_sweep_full.cu``, ``pencil_sweep_zband.cu``) and takes its plain twin
on CPU tensors. The TPU's x-strip plan and ``mxu_reduce`` are VMEM and MXU
facts and are not ported.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.cell_list import PencilGrid
from ljmd_tpu_torch.ops.pair_terms import lj_pair_terms_plain

__all__ = [
    "SENT_BASE",
    "TILE_I",
    "build_half_shell_tables",
    "build_shift_table",
    "build_tile_table",
    "full_grid",
    "full_stage_plan",
    "half_shell_lower",
    "hs_stage_plan",
    "pencil_sweep",
    "pencil_sweep_hs",
    "pencil_sweep_hs_plain",
    "pencil_sweep_plain",
    "pencil_sweep_zband",
    "pencil_sweep_zband_plain",
    "replica_tables",
    "sentinel_fill",
    "sweep_hs_grid",
    "zband_grid",
    "zband_stage_plan",
]

# The slot granule of pencils and visits.
TILE_I = 128
# Sentinel x of pencil p's empty slots: SENT_BASE * (1 + p) + rank (exact in
# float32 up to ~1600 pencils; cross-pencil sentinel r^2 ~ 1e8).
SENT_BASE = 1.0e4

_HALF_SHELL = ((0, 1), (1, -1), (1, 0), (1, 1))
# Roles of a half-shell stage (csrc/pencil_cull.cuh HsRole): the block's own
# pencil, a forward neighbour (partners shifted), a backward one (the block
# shifted); segment s of a block's plan has role _HS_ROLES[s].
_HS_SELF, _HS_FORWARD, _HS_BACKWARD = range(3)
_HS_ROLES = (_HS_SELF,) + (_HS_FORWARD,) * 4 + (_HS_BACKWARD,) * 4
# Visits evaluated at once by the twins (bounds their temporaries).
_VISIT_BATCH = 256
# Pair-tile elements evaluated at once by the full sweeps' twins.
_PAIR_BUDGET = 1 << 23


def build_half_shell_tables(grid: PencilGrid) -> tuple[np.ndarray, np.ndarray]:
    """(tbl (n_pencils*4,) int32 upper-neighbour ids, shifts (n_pencils*4*2,)
    int32 xy image shifts in units of L) for the 4 half-shell offsets."""
    m = grid.m_xy
    tbl = np.empty((m * m, 4), dtype=np.int32)
    shf = np.empty((m * m, 4, 2), dtype=np.int32)
    for ix in range(m):
        for iy in range(m):
            p = ix * m + iy
            for k, (dx, dy) in enumerate(_HALF_SHELL):
                tbl[p, k] = ((ix + dx) % m) * m + (iy + dy) % m
                shf[p, k, 0] = -1 if ix + dx < 0 else (1 if ix + dx >= m else 0)
                shf[p, k, 1] = -1 if iy + dy < 0 else (1 if iy + dy >= m else 0)
    return tbl.reshape(-1), shf.reshape(-1)


def build_tile_table(grid: PencilGrid) -> np.ndarray:
    """(n_pencils * 9,) int32: the k-th xy-neighbour pencil of pencil p at
    [p * 9 + k], the pencil itself at k = 4."""
    if grid.capacity % TILE_I != 0:
        raise ValueError("pencil capacity must be a multiple of 128")
    return grid.neighbor_table().reshape(-1)


def build_shift_table(grid: PencilGrid) -> np.ndarray:
    """(n_pencils * 9 * 2,) int32 xy image shifts in units of L: entry
    [(p * 9 + k) * 2 + c] is -1 / 0 / +1 when the k-th neighbour of pencil p
    wraps below / not / above in component c. With the partners shifted so,
    x_i - x_j is the minimum image for every pair within the cutoff (pencils
    are at least rc + skin wide, at least 3 a side)."""
    m = grid.m_xy
    offsets = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]  # neighbor_table's order
    tbl = np.empty((m * m, 9, 2), dtype=np.int32)
    for ix in range(m):
        for iy in range(m):
            for k, (dx, dy) in enumerate(offsets):
                tbl[ix * m + iy, k, 0] = -1 if ix + dx < 0 else (1 if ix + dx >= m else 0)
                tbl[ix * m + iy, k, 1] = -1 if iy + dy < 0 else (1 if iy + dy >= m else 0)
    return tbl.reshape(-1)


def sentinel_fill(rows_r: torch.Tensor, valid: torch.Tensor, capacity: int,
                  n_pencils: int | None = None) -> torch.Tensor:
    """Sentinel coordinates in the xyz rows of invalid slots
    (x = SENT_BASE * (1 + pencil) + rank, y = z = 0); other rows untouched.
    ``n_pencils`` (a replica stack of grids of that many pencils) numbers
    the pencils within each grid, so that every replica's sentinels are
    those of its grid alone."""
    ns = rows_r.shape[1]
    slot = torch.arange(ns, device=rows_r.device)
    pencil = slot // capacity
    rank = slot - pencil * capacity
    if n_pencils is not None:
        pencil = pencil % n_pencils
    slot_x = (SENT_BASE * (1.0 + pencil.double()) + rank.double()).to(rows_r.dtype)
    ok = valid > 0.5
    out = rows_r.clone()
    out[0] = torch.where(ok, rows_r[0], slot_x)
    out[1] = torch.where(ok, rows_r[1], 0.0)
    out[2] = torch.where(ok, rows_r[2], 0.0)
    return out


def replica_tables(tbl, shf, n_pencils: int, replicas: int):
    """The half-shell (or 9-neighbour) tables of a stack of ``replicas`` grids side by side
    (slots of replica q at [q * n_slots, (q + 1) * n_slots)): the pencil ids
    of replica q offset by q * n_pencils, the image shifts repeated. No
    pencil of the stack has a neighbour in another replica, so a sweep or
    chunk over the stack computes each replica as over its own grid."""
    off = torch.arange(replicas, dtype=tbl.dtype, device=tbl.device) * n_pencils
    return ((tbl.reshape(1, -1) + off[:, None]).reshape(-1).contiguous(),
            shf.repeat(replicas).contiguous())


def accumulate_visits(out, pos, lo, ista, jsta, shx, shy, width, tri, box_length,
                      rc_square, want_observables):
    """Add the pair terms of a class of visits into ``out`` (8, n_slots), the
    way the TPU kernels sum them: forces on both sides (j side negated),
    e / du / ddu on the i side. A visit is 128 i slots from ``ista`` against
    ``width`` j slots from ``jsta`` whose x / y are shifted by (shx, shy) L;
    ``tri`` masks the pairs to j > i (both ranges start at ``ista``). Index
    arrays are host numpy (V,). ``lo`` adds the two-float correction
    lo_i - lo_j (the shift applies to the hi part only)."""
    dev, dt = pos.device, pos.dtype
    L = box_length
    inv_l = 1.0 / box_length
    ar_i = torch.arange(TILE_I, device=dev)
    ar_j = torch.arange(width, device=dev)
    tri_mask = (ar_j[None, :] > ar_i[:, None])[None] if tri else None
    for b0 in range(0, len(ista), _VISIT_BATCH):
        sl = slice(b0, b0 + _VISIT_BATCH)
        ii = torch.as_tensor(ista[sl], device=dev)[:, None] + ar_i   # (B, 128)
        jj = torch.as_tensor(jsta[sl], device=dev)[:, None] + ar_j   # (B, W)
        offx = (torch.as_tensor(shx[sl], device=dev).to(dt) * L)[:, None]
        offy = (torch.as_tensor(shy[sl], device=dev).to(dt) * L)[:, None]
        dx = pos[0][ii][:, :, None] - (pos[0][jj] + offx)[:, None, :]
        dy = pos[1][ii][:, :, None] - (pos[1][jj] + offy)[:, None, :]
        dz = pos[2][ii][:, :, None] - pos[2][jj][:, None, :]
        if lo is not None:
            dx = dx + (lo[0][ii][:, :, None] - lo[0][jj][:, None, :])
            dy = dy + (lo[1][ii][:, :, None] - lo[1][jj][:, None, :])
            dz = dz + (lo[2][ii][:, :, None] - lo[2][jj][:, None, :])
        dz = dz - L * torch.round(dz * inv_l)
        r2 = dx * dx + dy * dy + dz * dz
        mask = r2 < rc_square
        if tri:
            mask = mask & tri_mask
        coef, du, e, ddu = lj_pair_terms_plain(r2, mask, want_observables)
        fi, fj = ii.reshape(-1), jj.reshape(-1)
        for row, d in enumerate((dx, dy, dz)):
            f = coef * d
            out[row].index_add_(0, fi, f.sum(dim=2).reshape(-1))
            out[row].index_add_(0, fj, -f.sum(dim=1).reshape(-1))
        if want_observables:
            for row, term in ((3, e), (4, du), (5, ddu)):
                out[row].index_add_(0, fi, term.sum(dim=2).reshape(-1))


def table_visits(n_pencils: int, capacity: int, tbl, shf, counts=None):
    """The static half-shell visits as host arrays: a list of
    (ista, jsta, shx, shy, width, tri) classes. Self visits start at each
    128-slot i-slice and run to the pencil's end (one class per slice);
    neighbour visits sweep the whole neighbour. With ``counts``, i-slices at
    or past the pencil's count and empty neighbours are skipped, as the
    JAX grid kernel gates them; without, every slice is swept (the fused
    kernel)."""
    P, cap = n_pencils, capacity
    n_sub = cap // TILE_I
    tbl = np.asarray(tbl).reshape(P, 4)
    shf = np.asarray(shf).reshape(P, 4, 2)
    cnt = np.full(P, cap) if counts is None else np.asarray(counts)
    classes = []
    for si in range(n_sub):
        live = np.nonzero(si * TILE_I < cnt[:P])[0]
        ista = live * cap + si * TILE_I
        zero = np.zeros_like(ista)
        classes.append((ista, ista, zero, zero, cap - si * TILE_I, True))
    p, si, k = np.meshgrid(np.arange(P), np.arange(n_sub), np.arange(4), indexing="ij")
    p, si, k = p.ravel(), si.ravel(), k.ravel()
    j = tbl[p, k]
    live = (si * TILE_I < cnt[p]) & (cnt[j] > 0)
    p, si, k, j = p[live], si[live], k[live], j[live]
    classes.append((p * cap + si * TILE_I, j * cap, shf[p, k, 0], shf[p, k, 1], cap, False))
    return classes


def half_shell_lower(tbl, n_pencils: int) -> torch.Tensor:
    """The inverse of the half-shell table ``tbl`` ((rows * 4,), rows <=
    n_pencils: a strip's table has rows for its i pencils only): int32
    (n_pencils * 4,) on its device with ``lower[q * 4 + k]`` the pencil p
    whose k-th upper neighbour is q (``tbl[p * 4 + k] == q``), -1 where no
    row's is. On a full grid each k's map is a translation of the torus, so
    every entry is set once. Torch ops, no host read."""
    dev = tbl.device
    e = torch.arange(tbl.numel(), device=dev)
    lower = torch.full((4 * n_pencils,), -1, dtype=torch.int32, device=dev)
    lower[tbl.long() * 4 + e % 4] = (e // 4).to(torch.int32)
    return lower


def hs_stage_plan(counts, tbl, shf, lower, n_pencils_i: int, n_pencils: int,
                  capacity: int) -> dict:
    """The half-shell sweep's stage plan: the rule of
    ``csrc/pencil_sweep_hs.cu``, as torch ops on the counts' device. Each
    128-slot block (work item) of pencil q whose first rank is below
    counts[q] is live; it meets 9 segments, its own pencil (an i pencil
    only), its 4 upper neighbours (``tbl``, i pencils only; partners shifted
    by ``shf``) and the 4 pencils of ``lower`` (the block shifted by their
    row's shift), each over the partner's live stages: the 128-rank stages
    whose first rank is below the partner's count (slots are packed
    rank-first, so the rest hold only sentinels). Returns ``pencil`` (P, 9)
    int64 partner pencil (-1: none), ``shift`` (P, 9, 2), ``live`` (P, 9)
    stages, ``start`` (P, 9, n_sub) global slot of each stage, ``keep`` (P,
    9, n_sub) bool, ``item_live`` (P, n_sub) bool, and the counts
    ``items`` (live), ``full`` (the stages of the live items with every
    non-empty partner pencil at full capacity: the earlier sweep's),
    ``kept``."""
    dev = counts.device
    P, Pi, n_sub = n_pencils, n_pencils_i, capacity // TILE_I
    cnt = counts.long().to(dev)
    q = torch.arange(P, device=dev)
    k = torch.arange(4, device=dev)
    up = torch.full((P, 4), -1, dtype=torch.long, device=dev)
    up[:Pi] = tbl.long().to(dev).reshape(Pi, 4)
    shf_i = shf.long().to(dev).reshape(Pi, 4, 2)
    sh_up = torch.zeros((P, 4, 2), dtype=torch.long, device=dev)
    sh_up[:Pi] = shf_i
    low = lower.long().to(dev).reshape(P, 4)
    sh_low = torch.where((low >= 0)[:, :, None], shf_i[low.clamp(min=0), k], 0)
    pencil = torch.cat([torch.where(q < Pi, q, -1)[:, None], up, low], dim=1)     # (P, 9)
    shift = torch.cat([torch.zeros((P, 1, 2), dtype=torch.long, device=dev), sh_up, sh_low],
                      dim=1)
    pc = cnt[pencil.clamp(min=0)]
    live = torch.where(pencil >= 0, ((pc + TILE_I - 1) // TILE_I).clamp(max=n_sub), 0)
    c = torch.arange(n_sub, device=dev)
    keep = c[None, None, :] < live[:, :, None]
    start = pencil.clamp(min=0)[:, :, None] * capacity + c * TILE_I
    item_live = c[None, :] * TILE_I < cnt[:, None]
    per_q = item_live.sum(dim=1)
    full = ((pencil >= 0) & (pc > 0)).sum(dim=1) * n_sub
    return {"pencil": pencil, "shift": shift, "live": live, "start": start, "keep": keep,
            "item_live": item_live, "items": int(per_q.sum()),
            "full": int((per_q * full).sum()), "kept": int((per_q * live.sum(dim=1)).sum())}


def hs_chunks(plan: dict):
    """The (128-slot block, kept stage) chunks of a ``hs_stage_plan``, in
    the kernel's order (block by block; each block's segments, then stages
    in rank order): (block, partner start slot, role, shx, shy), int64."""
    n_sub = plan["item_live"].shape[1]
    both = plan["item_live"][:, :, None, None] & plan["keep"][:, None, :, :]
    q, b, sg, c = torch.nonzero(both, as_tuple=True)
    role = torch.tensor(_HS_ROLES, device=q.device)[sg]
    shx, shy = plan["shift"][q, sg, 0], plan["shift"][q, sg, 1]
    return q * n_sub + b, plan["start"][q, sg, c], role, shx, shy


def _stage_sweep(out, pos, chunks, box_length, rc_square, want_observables):
    """Add the pair terms of the (block, stage) ``chunks`` into ``out`` (8,
    n_slots), each from its block's side: the self role without the slot
    itself, the forward role with the partners' x / y shifted, the backward
    role with the block's own; only z takes the round. e / du / ddu of the
    pairs of which the block's slot is the i side (forward, and self
    partners above the slot)."""
    blk, q0, role, shx, shy = chunks
    dev, dt = pos.device, pos.dtype
    L, inv_l = box_length, 1.0 / box_length
    ar = torch.arange(TILE_I, device=dev)
    for b0 in range(0, blk.numel(), _VISIT_BATCH):
        sl = slice(b0, b0 + _VISIT_BATCH)
        rl = role[sl][:, None]
        ii = blk[sl][:, None] * TILE_I + ar
        jj = q0[sl][:, None] + ar
        offx, offy = (sh[sl][:, None].to(dt) * L for sh in (shx, shy))
        fwd, bwd = rl == _HS_FORWARD, rl == _HS_BACKWARD
        xi = torch.where(bwd, pos[0][ii] + offx, pos[0][ii])
        yi = torch.where(bwd, pos[1][ii] + offy, pos[1][ii])
        xj = torch.where(fwd, pos[0][jj] + offx, pos[0][jj])
        yj = torch.where(fwd, pos[1][jj] + offy, pos[1][jj])
        dx = xi[:, :, None] - xj[:, None, :]
        dy = yi[:, :, None] - yj[:, None, :]
        dz = pos[2][ii][:, :, None] - pos[2][jj][:, None, :]
        dz = dz - L * torch.round(dz * inv_l)
        r2 = dx * dx + dy * dy + dz * dz
        self_role = (rl == _HS_SELF)[:, :, None]
        mask = (r2 < rc_square) & (~self_role | (ii[:, :, None] != jj[:, None, :]))
        coef, du, e, ddu = lj_pair_terms_plain(r2, mask, want_observables)
        fi = ii.reshape(-1)
        for row, d in enumerate((dx, dy, dz)):
            out[row].index_add_(0, fi, (coef * d).sum(dim=2).reshape(-1))
        if want_observables:
            i_side = fwd[:, :, None] | (self_role & (jj[:, None, :] > ii[:, :, None]))
            for row, term in ((3, e), (4, du), (5, ddu)):
                out[row].index_add_(0, fi, torch.where(i_side, term, 0.0).sum(dim=2).reshape(-1))


def pencil_sweep_hs_plain(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                          want_observables: bool = True, n_pencils_i: int | None = None):
    """Plain twin of ``pencil_sweep_hs``: every live 128-slot block over the
    kept stages of its ``hs_stage_plan``, in batches of dense tiles; i over
    the first ``n_pencils_i`` pencils (default: all of the grid's), the
    output as wide as ``pos``."""
    cap = grid.capacity
    p_all = pos.shape[1] // cap
    p_i = grid.n_pencils if n_pencils_i is None else n_pencils_i
    dev = pos.device
    tbl, shf = tbl.to(dev), shf.to(dev)
    plan = hs_stage_plan(counts.to(dev), tbl, shf, half_shell_lower(tbl, p_all), p_i, p_all,
                         cap)
    out = torch.zeros_like(pos)
    _stage_sweep(out, pos, hs_chunks(plan), grid.box_length, rc_square, want_observables)
    return out * pos[3:4]


def _i_side_visits(out, pos, ista, jsta, width, shx, shy, excl, box_length, rc_square,
                   want_observables):
    """Add the i-side pair terms of a class of visits into ``out`` (8,
    n_slots), the full sweeps' way (no reactions: each pair is visited from
    both of its slots). A visit is TILE_I i slots from ``ista`` against
    ``width`` j slots from ``jsta``; ``shx`` / ``shy`` shift the partners'
    x / y by that many L and only z takes the round, or are None for the
    full minimum image; ``excl`` (None: nothing) is the global start of
    ``width`` partner slots left out. Mask: r^2 < rc^2, gi != gj,
    v_i * v_j > 0.5. Index arrays are host numpy (V,)."""
    dev, dt = pos.device, pos.dtype
    L = box_length
    inv_l = 1.0 / box_length
    ar_i = torch.arange(TILE_I, device=dev)
    ar_j = torch.arange(width, device=dev)
    batch = max(1, _PAIR_BUDGET // (TILE_I * width))
    for b0 in range(0, len(ista), batch):
        sl = slice(b0, b0 + batch)
        ii = torch.as_tensor(ista[sl], device=dev)[:, None] + ar_i   # (B, 128)
        jj = torch.as_tensor(jsta[sl], device=dev)[:, None] + ar_j   # (B, W)
        xj, yj = pos[0][jj], pos[1][jj]
        if shx is not None:
            xj = xj + (torch.as_tensor(shx[sl], device=dev).to(dt) * L)[:, None]
            yj = yj + (torch.as_tensor(shy[sl], device=dev).to(dt) * L)[:, None]
        dx = pos[0][ii][:, :, None] - xj[:, None, :]
        dy = pos[1][ii][:, :, None] - yj[:, None, :]
        dz = pos[2][ii][:, :, None] - pos[2][jj][:, None, :]
        if shx is None:
            dx = dx - L * torch.round(dx * inv_l)
            dy = dy - L * torch.round(dy * inv_l)
        dz = dz - L * torch.round(dz * inv_l)
        r2 = dx * dx + dy * dy + dz * dz
        both = pos[3][ii][:, :, None] * pos[3][jj][:, None, :]
        mask = (r2 < rc_square) & (ii[:, :, None] != jj[:, None, :]) & (both > 0.5)
        if excl is not None:
            ex = torch.as_tensor(excl[sl], device=dev)[:, None, None]
            mask = mask & ~((jj[:, None, :] >= ex) & (jj[:, None, :] < ex + width))
        coef, du, e, ddu = lj_pair_terms_plain(r2, mask, want_observables)
        fi = ii.reshape(-1)
        for row, d in enumerate((dx, dy, dz)):
            out[row].index_add_(0, fi, (coef * d).sum(dim=2).reshape(-1))
        if want_observables:
            for row, term in ((3, e), (4, du), (5, ddu)):
                out[row].index_add_(0, fi, term.sum(dim=2).reshape(-1))


def full_stage_plan(counts, tbl, n_pencils: int, capacity: int) -> dict:
    """The full 9-neighbour sweep's stage plan: the rule of
    ``csrc/pencil_sweep_full.cu``, as torch ops on the counts' device. Each
    128-slot i-slice whose first rank is below its pencil's count is live; it
    meets its 9 xy-neighbours k = 0..8 (``tbl``), each over the partner's
    stages of 128 ranks whose first rank is below the partner's count (slots
    are packed rank-first, so the rest hold only invalid slots, which the
    validity test masks). Returns ``pencil`` (T, 9) int64 partner pencil of
    each i-slice (T = n_pencils * capacity / 128), ``start`` (T, 9, n_sub)
    global slot of each stage, ``keep`` (T, 9, n_sub) bool, ``item_live``
    (T,) bool, and the counts ``items`` (live i-slices), ``stages`` (the
    stages of the live slices with every non-empty partner at full capacity:
    the earlier sweep's), ``past_count`` (those skipped) and ``kept``."""
    dev = counts.device
    P, n_sub = n_pencils, capacity // TILE_I
    cnt = counts.long()
    t = torch.arange(P * n_sub, device=dev)
    q = t // n_sub
    pencil = tbl.long().to(dev).reshape(P, 9)[q]                               # (T, 9)
    cj = cnt[pencil]
    item_live = (t % n_sub) * TILE_I < cnt[q]
    c = torch.arange(n_sub, device=dev)
    swept = (item_live[:, None] & (cj > 0))[:, :, None].expand(-1, -1, n_sub)
    keep = swept & (c * TILE_I < cj[:, :, None])
    stages, kept = int(swept.sum()), int(keep.sum())
    return {"pencil": pencil, "start": pencil[:, :, None] * capacity + c * TILE_I, "keep": keep,
            "item_live": item_live, "items": int(item_live.sum()), "stages": stages,
            "past_count": stages - kept, "kept": kept}


def pencil_sweep_plain(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                       want_observables: bool = True, replicas: int | None = None):
    """Plain twin of ``pencil_sweep``: each live 128-slot i-slice against
    each stage that ``full_stage_plan`` keeps (the counts read on the host),
    evaluated in batches of dense tiles; ``replicas=R``: over a stack of R
    grids (``pencil_sweep``)."""
    n_pencils = grid.n_pencils * (replicas or 1)
    out = torch.zeros_like(pos)
    plan = full_stage_plan(counts.cpu(), tbl.cpu(), n_pencils, grid.capacity)
    t, k, _ = (x.numpy() for x in torch.nonzero(plan["keep"], as_tuple=True))
    shf = np.asarray(shf.cpu()).reshape(n_pencils, 9, 2)
    p = t // (grid.capacity // TILE_I)
    _i_side_visits(out, pos, t * TILE_I, plan["start"][plan["keep"]].numpy(), TILE_I,
                   shf[p, k, 0], shf[p, k, 1], None, grid.box_length, rc_square,
                   want_observables)
    return out


def zband_stage_plan(counts, tbl, start_a, start_b, use_b, n_pencils: int, capacity: int,
                     window: int) -> dict:
    """The z-banded sweep's window stages and which of them it sweeps: the
    rule of ``csrc/pencil_sweep_zband.cu``, as torch ops on the tables'
    device. Windows start on 128-slot boundaries and are multiples of 128,
    so each is ``window / 128`` whole stages of 128 ranks, and a stage of
    window B either lies inside window A or misses it. Of the stages of the
    live visits (i-slices below their pencil's count, non-empty partner
    pencils; window A always, window B under ``use_b``), two kinds are
    skipped, both exactly: a window-B stage inside window A (the rank
    dedupe masks all of it) and a stage whose first rank is at or past the
    partner pencil's count (only invalid slots, which the validity test
    masks). Returns ``start`` (T, 9, 2, W) int64 global slot of each stage
    (window A at [:, :, 0], B at [:, :, 1]; T = n_pencils * capacity / 128
    i-slices, W = window / 128), ``keep`` (T, 9, 2, W) bool, and the counts
    ``stages`` (of the live visits), ``b_inside_a``, ``a_past_count`` and
    ``b_past_count`` (B stages outside A past the count), ``kept``."""
    dev = counts.device
    P, cap = n_pencils, capacity
    n_sub, n_win = cap // TILE_I, window // TILE_I
    T = P * n_sub
    cnt = counts.long()
    t = torch.arange(T, device=dev)
    j = tbl.long().to(dev).reshape(P, 9)[t // n_sub]                          # (T, 9)
    cj = cnt[j]
    live_visit = ((t % n_sub) * TILE_I < cnt[t // n_sub])[:, None] & (cj > 0)
    sa, sb = (x.long().to(dev).reshape(T, 9) for x in (start_a, start_b))
    ub = use_b.to(dev).reshape(T, 9) > 0
    rank = torch.stack([sa, sb], dim=2)[..., None] + TILE_I * torch.arange(n_win, device=dev)
    swept = torch.stack([live_visit, live_visit & ub], dim=2)[..., None].expand(rank.shape)
    in_a = (rank >= sa[:, :, None, None]) & (rank < sa[:, :, None, None] + window)
    in_a[:, :, 0] = False  # window A itself
    past = rank >= cj[:, :, None, None]
    keep = swept & ~in_a & ~past
    b = swept[:, :, 1]
    return {"start": j[:, :, None, None] * cap + rank, "keep": keep,
            "stages": int(swept.sum()), "b_inside_a": int((b & in_a[:, :, 1]).sum()),
            "a_past_count": int((swept[:, :, 0] & past[:, :, 0]).sum()),
            "b_past_count": int((b & ~in_a[:, :, 1] & past[:, :, 1]).sum()),
            "kept": int(keep.sum())}


def pencil_sweep_zband_plain(pos, tbl, counts, start_a, start_b, use_b, grid: PencilGrid,
                             rc_square, window: int, want_observables: bool = True,
                             replicas: int | None = None):
    """Plain twin of ``pencil_sweep_zband``: the stages of
    ``zband_stage_plan`` that the sweep keeps, each 128-slot i-slice against
    each kept 128-rank stage (no dedupe test: the skipped stages are the
    ones it would mask); ``replicas=R``: over a stack of R grids."""
    out = torch.zeros_like(pos)
    plan = zband_stage_plan(counts.cpu(), tbl.cpu(), start_a.cpu(), start_b.cpu(), use_b.cpu(),
                            grid.n_pencils * (replicas or 1), grid.capacity, window)
    t, _, _, _ = (x.numpy() for x in torch.nonzero(plan["keep"], as_tuple=True))
    jsta = plan["start"][plan["keep"]].numpy()
    _i_side_visits(out, pos, t * TILE_I, jsta, TILE_I, None, None, None, grid.box_length,
                   rc_square, want_observables)
    return out


def _check_tables(name, pos, grid, *tables, n_slots=None):
    """pos: contiguous (8, n_slots) CUDA rows (default: the grid's slots);
    each (table, size): a contiguous (size,) int32 tensor on pos's device."""
    _cuda.require_cuda_rows(name, pos)
    n_slots = grid.n_slots if n_slots is None else n_slots
    if pos.shape[1] != n_slots:
        raise ValueError(f"{name}: {pos.shape[1]} slots, expected {n_slots}")
    for t, size in tables:
        if (t.device != pos.device or t.dtype != torch.int32 or not t.is_contiguous()
                or t.shape != (size,)):
            raise ValueError(f"{name}: tables must be contiguous int32 on {pos.device} "
                             f"shaped {[sz for _, sz in tables]} for P={grid.n_pencils}")


# The inverses of the half-shell tables the sweep and the static chunk
# (ops/fused_pencil.py) were given (the engines keep their tables for the
# run; a sharded run's ranks share one table, from several threads): built
# once per table.
_LOWER_CACHE: dict = {}
_LOWER_LOCK = threading.Lock()


def _lower_of(tbl, n_pencils: int):
    key = (id(tbl), n_pencils)
    with _LOWER_LOCK:
        hit = _LOWER_CACHE.get(key)
        if hit is not None and hit[0] is tbl and hit[1] == tbl._version:
            return hit[2]
        lower = half_shell_lower(tbl, n_pencils)
        if len(_LOWER_CACHE) >= 8:
            _LOWER_CACHE.clear()
        _LOWER_CACHE[key] = (tbl, tbl._version, lower)
        return lower


def pencil_sweep_hs(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                    want_observables: bool = True, n_pencils_i: int | None = None,
                    replicas: int | None = None):
    """Half-shell sweep of an (8, n_slots) slot matrix (module docstring):
    ONE launch of ``csrc/pencil_sweep_hs.cu`` on CUDA tensors (the counts
    read on the device), the plain twin on CPU tensors. With ``n_pencils_i``
    the matrix is a strip plus its halo: (8, n_pencils * capacity) for any
    n_pencils >= n_pencils_i, tables of n_pencils_i rows, counts of all
    n_pencils. With ``replicas=R`` it is R grids side by side, (8, R *
    n_slots), with ``replica_tables``' tables and the R grids' counts: one
    launch for all R (counted as ``pencil_sweep_hs_replicas``), replica q's
    slots what a launch on its grid alone gives them."""
    name = "pencil_sweep_hs"
    if replicas is not None:
        if n_pencils_i is not None or replicas < 1:
            raise ValueError("pencil_sweep_hs: replicas >= 1, and not with n_pencils_i")
        n_pencils_i, name = replicas * grid.n_pencils, "pencil_sweep_hs_replicas"
    if pos.device.type == "cpu":
        return pencil_sweep_hs_plain(pos, tbl, counts, shf, grid, rc_square, want_observables,
                                     n_pencils_i)
    if pos.device.type != "cuda":
        raise ValueError(f"pencil_sweep_hs: unsupported device {pos.device}")
    cap = grid.capacity
    if n_pencils_i is None:
        p_i = p_all = grid.n_pencils
    else:
        p_i, p_all = n_pencils_i, pos.shape[1] // cap
        if not 0 < p_i <= p_all:
            raise ValueError(f"pencil_sweep_hs: n_pencils_i={p_i} outside [1, {p_all}]")
    _check_tables("pencil_sweep_hs", pos, grid, (tbl, 4 * p_i), (counts, p_all), (shf, 8 * p_i),
                  n_slots=p_all * cap)
    lib = _cuda.library()
    if cap // TILE_I > lib.ljmd_sweep_hs_max_sub():
        raise ValueError(f"pencil_sweep_hs: capacity {cap} above "
                         f"{TILE_I * lib.ljmd_sweep_hs_max_sub()}")
    if pos.data_ptr() % 16:
        raise ValueError("pencil_sweep_hs: pos must start on a 16-byte boundary (cp.async)")
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.zeros_like(pos)
    lower = _lower_of(tbl, p_all)
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_pencil_sweep_hs_{suffix}")(
            pos.data_ptr(), out.data_ptr(), tbl.data_ptr(), counts.data_ptr(),
            shf.data_ptr(), lower.data_ptr(), p_i, p_all, cap, float(grid.box_length),
            1.0 / float(grid.box_length), float(rc_square), int(want_observables),
            _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return out


def sweep_hs_grid(pos, want_observables: bool = True) -> dict:
    """The half-shell sweep's launch shape for slot rows ``pos`` (on the
    card): threads a slot (S) and a block (128 x S), blocks (128-slot work
    items), resident blocks an SM, registers and spill bytes a thread, and
    the warps an SM."""
    _cuda.require_cuda_rows("sweep_hs_grid", pos)
    lib = _cuda.library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(pos.device):
        _cuda.check(lib.ljmd_sweep_hs_occupancy(pos.element_size(), int(want_observables), out),
                    "pencil_sweep_hs occupancy")
    s = lib.ljmd_sweep_hs_slices()
    return {"slices": s, "threads": TILE_I * s, "blocks": pos.shape[1] // TILE_I,
            "blocks_per_sm": out[0], "sms": out[1], "regs": out[2], "spill_bytes": out[3],
            "warps_per_sm": out[0] * TILE_I * s // 32}


def _stack_pencils(name: str, grid: PencilGrid, replicas: int | None):
    """(pencils of the slot matrix, launch count name) of a sweep over one
    grid or over a stack of ``replicas`` grids."""
    if replicas is None:
        return grid.n_pencils, name
    if replicas < 1:
        raise ValueError(f"{name}: replicas >= 1")
    return replicas * grid.n_pencils, f"{name}_replicas"


def pencil_sweep(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                 want_observables: bool = True, replicas: int | None = None):
    """Full 9-neighbour sweep of an (8, n_slots) slot matrix (module
    docstring): ONE launch of ``csrc/pencil_sweep_full.cu`` on CUDA tensors
    (the counts read on the device), the plain twin on CPU tensors. ``tbl``
    and ``shf`` are ``build_tile_table`` and ``build_shift_table``. With
    ``replicas=R`` the matrix is R grids side by side, (8, R * n_slots), with
    ``replica_tables``' 9-entry tables and the R grids' counts: one launch
    for all R (counted as ``pencil_sweep_full_replicas``), replica q's slots
    what a launch on its grid alone gives them (each i-slice meets its 9
    partners in their one-grid order)."""
    P, name = _stack_pencils("pencil_sweep_full", grid, replicas)
    if pos.device.type == "cpu":
        return pencil_sweep_plain(pos, tbl, counts, shf, grid, rc_square, want_observables,
                                  replicas)
    if pos.device.type != "cuda":
        raise ValueError(f"pencil_sweep: unsupported device {pos.device}")
    cap = grid.capacity
    _check_tables("pencil_sweep", pos, grid, (tbl, 9 * P), (counts, P), (shf, 18 * P),
                  n_slots=P * cap)
    lib = _cuda.library()
    if cap // TILE_I > lib.ljmd_full_max_sub():
        raise ValueError(f"pencil_sweep: capacity {cap} above {TILE_I * lib.ljmd_full_max_sub()}")
    if pos.data_ptr() % 16:
        raise ValueError("pencil_sweep: pos must start on a 16-byte boundary (cp.async)")
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.zeros_like(pos)
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_pencil_sweep_full_{suffix}")(
            pos.data_ptr(), out.data_ptr(), tbl.data_ptr(), counts.data_ptr(),
            shf.data_ptr(), P, cap, float(grid.box_length), 1.0 / float(grid.box_length),
            float(rc_square), int(want_observables), _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return out


def full_grid(pos, want_observables: bool = True) -> dict:
    """Kernel 11's launch shape for slot rows ``pos`` (on the card): threads
    a block (128 slots x 4), blocks (128-slot i-slices), resident blocks an
    SM, registers and spill bytes a thread, and the warps an SM."""
    _cuda.require_cuda_rows("full_grid", pos)
    lib = _cuda.library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(pos.device):
        _cuda.check(lib.ljmd_full_occupancy(pos.element_size(), int(want_observables), out),
                    "pencil_sweep_full occupancy")
    threads = lib.ljmd_full_block_threads()
    return {"threads": threads, "blocks": pos.shape[1] // TILE_I, "blocks_per_sm": out[0],
            "sms": out[1], "regs": out[2], "spill_bytes": out[3],
            "warps_per_sm": out[0] * threads // 32}


def pencil_sweep_zband(pos, tbl, counts, start_a, start_b, use_b, grid: PencilGrid, rc_square,
                       window: int, want_observables: bool = True,
                       replicas: int | None = None):
    """z-banded sweep of an (8, n_slots) slot matrix with z-sorted ranks
    (module docstring): ONE launch of ``csrc/pencil_sweep_zband.cu`` on CUDA
    tensors, the plain twin on CPU tensors. The window tables are
    ``compute_z_windows``'s: their starts are multiples of 128 and at most
    capacity - window, which the kernel (and its stage skips,
    ``zband_stage_plan``) relies on. With ``replicas=R`` the matrix is R
    grids side by side with ``replica_tables``' neighbour table and the
    stack's window tables (``compute_z_windows(..., replicas=R)``, R *
    n_slots / 128 * 9 entries): one launch for all R (counted as
    ``pencil_sweep_zband_replicas``), replica q's slots what a launch on its
    grid alone gives them."""
    P, name = _stack_pencils("pencil_sweep_zband", grid, replicas)
    if pos.device.type == "cpu":
        return pencil_sweep_zband_plain(pos, tbl, counts, start_a, start_b, use_b, grid,
                                        rc_square, window, want_observables, replicas)
    if pos.device.type != "cuda":
        raise ValueError(f"pencil_sweep_zband: unsupported device {pos.device}")
    cap = grid.capacity
    lib = _cuda.library()
    if (window % TILE_I or not TILE_I <= window <= cap
            or window // TILE_I > lib.ljmd_zband_max_window_stages()):
        raise ValueError(f"pencil_sweep_zband: window {window} must be a multiple of 128 "
                         f"in [128, capacity={cap}], at most "
                         f"{TILE_I * lib.ljmd_zband_max_window_stages()}")
    n_tab = P * cap // TILE_I * 9
    _check_tables("pencil_sweep_zband", pos, grid, (tbl, 9 * P), (counts, P),
                  (start_a, n_tab), (start_b, n_tab), (use_b, n_tab), n_slots=P * cap)
    if pos.data_ptr() % 16:
        raise ValueError("pencil_sweep_zband: pos must start on a 16-byte boundary (cp.async)")
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.zeros_like(pos)
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_pencil_sweep_zband_{suffix}")(
            pos.data_ptr(), out.data_ptr(), tbl.data_ptr(), counts.data_ptr(),
            start_a.data_ptr(), start_b.data_ptr(), use_b.data_ptr(), P, cap, int(window),
            float(grid.box_length), 1.0 / float(grid.box_length), float(rc_square),
            int(want_observables), _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    return out


def zband_grid(pos, want_observables: bool = True) -> dict:
    """Kernel 12's launch shape for slot rows ``pos`` (on the card): threads
    a block (128 slots x 4), blocks (128-slot i-slices), resident blocks an
    SM, registers and spill bytes a thread, and the warps an SM."""
    _cuda.require_cuda_rows("zband_grid", pos)
    lib = _cuda.library()
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(pos.device):
        _cuda.check(lib.ljmd_zband_occupancy(pos.element_size(), int(want_observables), out),
                    "zband occupancy")
    threads = lib.ljmd_zband_block_threads()
    return {"threads": threads, "blocks": pos.shape[1] // TILE_I, "blocks_per_sm": out[0],
            "sms": out[1], "regs": out[2], "spill_bytes": out[3],
            "warps_per_sm": out[0] * threads // 32}
