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
  ``build_shift_table``, z rounded;
- ``pencil_sweep_zband``: per (128-slot i-slice, neighbour), only the
  ``window`` ranks from ``start_a`` and, under ``use_b``, those from
  ``start_b`` that window A does not hold (``compute_z_windows``; ranks
  z-sorted), with the full minimum image in x, y and z.

Each wrapper launches its ``csrc/`` kernel on CUDA tensors (``pencil_sweep_hs.cu``,
``pencil_sweep_full.cu``, ``pencil_sweep_zband.cu``) and takes its plain twin
on CPU tensors. The TPU's x-strip plan and ``mxu_reduce`` are VMEM and MXU
facts and are not ported.
"""

from __future__ import annotations

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
    "pencil_sweep",
    "pencil_sweep_hs",
    "pencil_sweep_hs_plain",
    "pencil_sweep_plain",
    "pencil_sweep_zband",
    "pencil_sweep_zband_plain",
    "sentinel_fill",
]

# The slot granule of pencils and visits.
TILE_I = 128
# Sentinel x of pencil p's empty slots: SENT_BASE * (1 + p) + rank (exact in
# float32 up to ~1600 pencils; cross-pencil sentinel r^2 ~ 1e8).
SENT_BASE = 1.0e4

_HALF_SHELL = ((0, 1), (1, -1), (1, 0), (1, 1))
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


def sentinel_fill(rows_r: torch.Tensor, valid: torch.Tensor, capacity: int) -> torch.Tensor:
    """Sentinel coordinates in the xyz rows of invalid slots
    (x = SENT_BASE * (1 + pencil) + rank, y = z = 0); other rows untouched."""
    ns = rows_r.shape[1]
    slot = torch.arange(ns, device=rows_r.device)
    pencil = slot // capacity
    rank = slot - pencil * capacity
    slot_x = (SENT_BASE * (1.0 + pencil.double()) + rank.double()).to(rows_r.dtype)
    ok = valid > 0.5
    out = rows_r.clone()
    out[0] = torch.where(ok, rows_r[0], slot_x)
    out[1] = torch.where(ok, rows_r[1], 0.0)
    out[2] = torch.where(ok, rows_r[2], 0.0)
    return out


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


def pencil_sweep_hs_plain(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                          want_observables: bool = True, n_pencils_i: int | None = None):
    """Plain twin of ``pencil_sweep_hs``: the JAX grid kernel's visits (the
    counts read on the host), evaluated in batches of dense tiles; i over
    the first ``n_pencils_i`` pencils (default: all of the grid's)."""
    out = torch.zeros_like(pos)
    p_i = grid.n_pencils if n_pencils_i is None else n_pencils_i
    for ista, jsta, shx, shy, width, tri in table_visits(p_i, grid.capacity, tbl.cpu(),
                                                         shf.cpu(), counts.cpu()):
        accumulate_visits(out, pos, None, ista, jsta, shx, shy, width, tri,
                          grid.box_length, rc_square, want_observables)
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


def _full_visits(grid: PencilGrid, tbl, counts):
    """(pencil, i-slice, neighbour k, partner pencil) of every visit of the
    full sweeps, as host arrays: i-slices at or past the pencil's count and
    empty partner pencils skipped, as the JAX kernels gate them."""
    P, n_sub = grid.n_pencils, grid.capacity // TILE_I
    tbl = np.asarray(tbl).reshape(P, 9)
    cnt = np.asarray(counts)
    p, si, k = (a.ravel() for a in np.meshgrid(np.arange(P), np.arange(n_sub), np.arange(9),
                                               indexing="ij"))
    j = tbl[p, k]
    live = (si * TILE_I < cnt[p]) & (cnt[j] > 0)
    return p[live], si[live], k[live], j[live]


def pencil_sweep_plain(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                       want_observables: bool = True):
    """Plain twin of ``pencil_sweep``: the JAX kernel's visits (the counts
    read on the host), evaluated in batches of dense tiles."""
    out = torch.zeros_like(pos)
    cap = grid.capacity
    p, si, k, j = _full_visits(grid, tbl.cpu(), counts.cpu())
    shf = np.asarray(shf.cpu()).reshape(grid.n_pencils, 9, 2)
    _i_side_visits(out, pos, p * cap + si * TILE_I, j * cap, cap, shf[p, k, 0], shf[p, k, 1],
                   None, grid.box_length, rc_square, want_observables)
    return out


def pencil_sweep_zband_plain(pos, tbl, counts, start_a, start_b, use_b, grid: PencilGrid,
                             rc_square, window: int, want_observables: bool = True):
    """Plain twin of ``pencil_sweep_zband``: window A of every visit, then
    window B (deduped against A) where ``use_b`` is set."""
    out = torch.zeros_like(pos)
    cap = grid.capacity
    p, si, k, j = _full_visits(grid, tbl.cpu(), counts.cpu())
    e = (p * (cap // TILE_I) + si) * 9 + k
    sa, sb, ub = (np.asarray(t.cpu())[e] for t in (start_a, start_b, use_b))
    ista, a0 = p * cap + si * TILE_I, j * cap + sa
    _i_side_visits(out, pos, ista, a0, window, None, None, None, grid.box_length, rc_square,
                   want_observables)
    b = ub > 0
    _i_side_visits(out, pos, ista[b], j[b] * cap + sb[b], window, None, None, a0[b],
                   grid.box_length, rc_square, want_observables)
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


def pencil_sweep_hs(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                    want_observables: bool = True, n_pencils_i: int | None = None):
    """Half-shell sweep of an (8, n_slots) slot matrix (module docstring):
    ONE launch of ``csrc/pencil_sweep_hs.cu`` on CUDA tensors (the counts
    read on the device), the plain twin on CPU tensors. With ``n_pencils_i``
    the matrix is a strip plus its halo: (8, n_pencils * capacity) for any
    n_pencils >= n_pencils_i, tables of n_pencils_i rows, counts of all
    n_pencils."""
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
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.zeros_like(pos)
    lib = _cuda.library()
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_pencil_sweep_hs_{suffix}")(
            pos.data_ptr(), out.data_ptr(), tbl.data_ptr(), counts.data_ptr(),
            shf.data_ptr(), p_i, p_all, cap, float(grid.box_length),
            1.0 / float(grid.box_length), float(rc_square), int(want_observables),
            _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump("pencil_sweep_hs")
    _cuda.check(code, "pencil_sweep_hs")
    return out


def pencil_sweep(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                 want_observables: bool = True):
    """Full 9-neighbour sweep of an (8, n_slots) slot matrix (module
    docstring): ONE launch of ``csrc/pencil_sweep_full.cu`` on CUDA tensors
    (the counts read on the device), the plain twin on CPU tensors. ``tbl``
    and ``shf`` are ``build_tile_table`` and ``build_shift_table``."""
    if pos.device.type == "cpu":
        return pencil_sweep_plain(pos, tbl, counts, shf, grid, rc_square, want_observables)
    if pos.device.type != "cuda":
        raise ValueError(f"pencil_sweep: unsupported device {pos.device}")
    P = grid.n_pencils
    _check_tables("pencil_sweep", pos, grid, (tbl, 9 * P), (counts, P), (shf, 18 * P))
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.zeros_like(pos)
    lib = _cuda.library()
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_pencil_sweep_full_{suffix}")(
            pos.data_ptr(), out.data_ptr(), tbl.data_ptr(), counts.data_ptr(),
            shf.data_ptr(), P, grid.capacity, float(grid.box_length),
            1.0 / float(grid.box_length), float(rc_square), int(want_observables),
            _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump("pencil_sweep_full")
    _cuda.check(code, "pencil_sweep_full")
    return out


def pencil_sweep_zband(pos, tbl, counts, start_a, start_b, use_b, grid: PencilGrid, rc_square,
                       window: int, want_observables: bool = True):
    """z-banded sweep of an (8, n_slots) slot matrix with z-sorted ranks
    (module docstring): ONE launch of ``csrc/pencil_sweep_zband.cu`` on CUDA
    tensors, the plain twin on CPU tensors. The window tables are
    ``compute_z_windows``'s: their starts are multiples of 128 and at most
    capacity - window, which the kernel relies on."""
    if pos.device.type == "cpu":
        return pencil_sweep_zband_plain(pos, tbl, counts, start_a, start_b, use_b, grid,
                                        rc_square, window, want_observables)
    if pos.device.type != "cuda":
        raise ValueError(f"pencil_sweep_zband: unsupported device {pos.device}")
    P, cap = grid.n_pencils, grid.capacity
    if window % TILE_I or not TILE_I <= window <= cap:
        raise ValueError(f"pencil_sweep_zband: window {window} must be a multiple of 128 "
                         f"in [128, capacity={cap}]")
    n_tab = grid.n_slots // TILE_I * 9
    _check_tables("pencil_sweep_zband", pos, grid, (tbl, 9 * P), (counts, P),
                  (start_a, n_tab), (start_b, n_tab), (use_b, n_tab))
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.zeros_like(pos)
    lib = _cuda.library()
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_pencil_sweep_zband_{suffix}")(
            pos.data_ptr(), out.data_ptr(), tbl.data_ptr(), counts.data_ptr(),
            start_a.data_ptr(), start_b.data_ptr(), use_b.data_ptr(), P, cap, int(window),
            float(grid.box_length), 1.0 / float(grid.box_length), float(rc_square),
            int(want_observables), _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump("pencil_sweep_zband")
    _cuda.check(code, "pencil_sweep_zband")
    return out
