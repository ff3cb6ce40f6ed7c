"""Half-shell pencil sweep of the cell-pair engine (counterpart of
``ljmd_tpu/ops/pallas_pencil2.py``: ``pallas_pencil_sweep_hs`` and
``pallas_pencil_sweep_mono``, which compute one function).

Slot layout (``ops/cell_list.py``): (8, n_slots) rows, x/y/z in rows 0..2,
row 3 the slot validity (1/0), row 4 the particle id. Empty slots carry
sentinel coordinates (``sentinel_fill``: x = SENT_BASE * (1 + pencil) + rank,
y = z = 0), so a sentinel never passes the cutoff against a real particle or
against another pencil's sentinels.

The pair set is the JAX kernel's: each pencil against itself (slot
triangular, each in-pencil pair once) and against its 4 upper xy-neighbours
``(0,1), (1,-1), (1,0), (1,1)`` (``build_half_shell_tables``), whose
coordinates are shifted by a static image offset in x/y (z keeps its
minimum-image round). Output (8, n_slots):

- rows 0..2: force on each slot WITHOUT the 24 prefactor;
- rows 3..5: the e / du / ddu partials of each pair, summed on its i side
  (pair once: totals restore with the prefactors 4 / 24);
- rows 6..7 zero, and every row already multiplied by the validity row
  (the JAX kernel leaves that multiply to its caller).

``pencil_sweep_hs`` launches ``csrc/pencil_sweep_hs.cu`` on CUDA tensors and
takes the plain twin ``pencil_sweep_hs_plain`` on CPU tensors. The TPU's
x-strip plan and ``mxu_reduce`` are VMEM and MXU facts and are not ported.
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
    "pencil_sweep_hs",
    "pencil_sweep_hs_plain",
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
        live = np.nonzero(si * TILE_I < cnt)[0]
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
                          want_observables: bool = True):
    """Plain twin of ``pencil_sweep_hs``: the JAX grid kernel's visits (the
    counts read on the host), evaluated in batches of dense tiles."""
    out = torch.zeros_like(pos)
    for ista, jsta, shx, shy, width, tri in table_visits(grid.n_pencils, grid.capacity,
                                                         tbl.cpu(), shf.cpu(), counts.cpu()):
        accumulate_visits(out, pos, None, ista, jsta, shx, shy, width, tri,
                          grid.box_length, rc_square, want_observables)
    return out * pos[3:4]


def _check_tables(name, pos, tbl, counts, shf, grid):
    ns, P = grid.n_slots, grid.n_pencils
    _cuda.require_cuda_rows(name, pos)
    if pos.shape[1] != ns:
        raise ValueError(f"{name}: {pos.shape[1]} slots, the grid has {ns}")
    for t, size in ((tbl, 4 * P), (counts, P), (shf, 8 * P)):
        if (t.device != pos.device or t.dtype != torch.int32 or not t.is_contiguous()
                or t.shape != (size,)):
            raise ValueError(f"{name}: tables must be contiguous int32 on {pos.device} "
                             f"shaped (4P,), (P,), (8P,) for P={P}")


def pencil_sweep_hs(pos, tbl, counts, shf, grid: PencilGrid, rc_square,
                    want_observables: bool = True):
    """Half-shell sweep of an (8, n_slots) slot matrix (module docstring):
    ONE launch of ``csrc/pencil_sweep_hs.cu`` on CUDA tensors (the counts
    read on the device), the plain twin on CPU tensors."""
    if pos.device.type == "cpu":
        return pencil_sweep_hs_plain(pos, tbl, counts, shf, grid, rc_square, want_observables)
    if pos.device.type != "cuda":
        raise ValueError(f"pencil_sweep_hs: unsupported device {pos.device}")
    _check_tables("pencil_sweep_hs", pos, tbl, counts, shf, grid)
    suffix = _cuda.dtype_suffix(pos.dtype)
    out = torch.zeros_like(pos)
    lib = _cuda.library()
    with torch.cuda.device(pos.device):
        code = getattr(lib, f"ljmd_pencil_sweep_hs_{suffix}")(
            pos.data_ptr(), out.data_ptr(), tbl.data_ptr(), counts.data_ptr(),
            shf.data_ptr(), grid.n_pencils, grid.capacity, float(grid.box_length),
            1.0 / float(grid.box_length), float(rc_square), int(want_observables),
            _cuda.stream_handle(pos))
    _cuda.LAUNCHES.bump("pencil_sweep_hs")
    _cuda.check(code, "pencil_sweep_hs")
    return out
