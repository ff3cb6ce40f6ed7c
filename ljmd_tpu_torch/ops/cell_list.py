"""Pencil (cell-column) binning for the cell-pair engine (counterpart of
``ljmd_tpu/ops/cell_list.py:43-396``).

Particles are re-arranged into fixed-capacity "pencils": z-columns of
cross-section >= rc + skin. ``m_xy = floor(L / (rc + skin))`` pencils per
side (at least 3), pencil id ``p = ix * m_xy + iy``, and each pencil owns
``capacity`` slots (a multiple of 128): a particle of pencil p with rank k
sits in slot ``p * capacity + k``. Valid slots are packed rank-first.

The JAX package's v5e workarounds (the compare-reduce counts, the packed
int32 sort key, the cummax run starts, the ban on ``searchsorted``) are not
carried over; the algorithm is: two stable ``torch.sort`` calls give
``bin_to_slots``'s (pencil, z) lexsort with ties broken by particle index,
one stable sort by pencil gives the rebin order (the JAX packed key
``(pid << bits) | slot`` is unique, so any sort of it is this order), two
give the z-ordered rebin's lexsort, and a scatter-add gives the counts (no
host read). The z-banded sweep's window tables (``compute_z_windows``) use
a batched ``torch.searchsorted`` where JAX vmaps ``jnp.searchsorted``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "PencilGrid",
    "bin_to_slots",
    "capacity_from_state",
    "compute_z_windows",
    "default_z_window",
    "make_pencil_grid",
    "pencil_capacity",
    "rebin_gather",
    "rebin_gather_parts",
]


@dataclasses.dataclass(frozen=True)
class PencilGrid:
    """Static pencil geometry (host-side constants)."""

    m_xy: int           # pencils per box side
    capacity: int       # slots per pencil (multiple of 128)
    box_length: float

    @property
    def n_pencils(self) -> int:
        return self.m_xy * self.m_xy

    @property
    def n_slots(self) -> int:
        return self.n_pencils * self.capacity

    @property
    def pencil_width(self) -> float:
        return self.box_length / self.m_xy

    def neighbor_table(self) -> np.ndarray:
        """(n_pencils, 9) int32: the xy-neighbour pencil ids, the pencil
        itself at k = 4, PBC-wrapped; k runs over dx, then dy in (-1, 0, 1)."""
        m = self.m_xy
        offsets = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        tbl = np.empty((m * m, 9), dtype=np.int32)
        for ix in range(m):
            for iy in range(m):
                for k, (dx, dy) in enumerate(offsets):
                    tbl[ix * m + iy, k] = ((ix + dx) % m) * m + (iy + dy) % m
        return tbl


def pencil_capacity(n: int, density: float, box_length: float, m_xy: int) -> int:
    """Static per-pencil slot capacity, a multiple of 128: the mean
    occupancy plus max(0.15 * mean + 8, 3.5 * sqrt(mean)), raised to cover
    the FCC starting lattice (whose atom columns bunch into pencils) when n
    is an FCC count. Overflow past it sets the engine's sticky flag."""
    del density
    mean = n / (m_xy * m_xy)
    margin = max(0.15 * mean + 8.0, 3.5 * mean**0.5)
    cap = int(mean + margin)
    if n >= 32:
        k = round((n / 4) ** (1 / 3))
        if 4 * k**3 == n:
            cap = max(cap, _fcc_max_pencil_occupancy(k, box_length, m_xy) + 8)
    return ((cap + 127) // 128) * 128


def capacity_from_state(box_length: float, r_list: float, r) -> int:
    """128-granular capacity from an actual configuration's occupancy
    census: the smallest multiple of 128 >= max(occ_max + 16,
    mean + 3.5 sqrt(mean) + 1), at least 128. ``r`` is (N, 3), on any
    device (read on the host once)."""
    m_xy = int(math.floor(box_length / r_list))
    if m_xy < 3:
        raise ValueError("box too small for a pencil grid")
    pos = r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)
    inv_w = m_xy / box_length
    ix = np.clip((pos[:, 0] * inv_w).astype(np.int64), 0, m_xy - 1)
    iy = np.clip((pos[:, 1] * inv_w).astype(np.int64), 0, m_xy - 1)
    occ = np.bincount(ix * m_xy + iy, minlength=m_xy * m_xy)
    mean = pos.shape[0] / (m_xy * m_xy)
    need = max(int(occ.max()) + 16, int(mean + 3.5 * mean**0.5) + 1)
    return max(128, -(-need // 128) * 128)


def _fcc_max_pencil_occupancy(num_cells: int, box_length: float, m_xy: int) -> int:
    """Exact max per-pencil occupancy of the FCC starting lattice: the
    4-atom basis projected onto xy, histogrammed into the pencil grid."""
    a = box_length / num_cells
    cells = np.arange(num_cells) * a
    cols_x, cols_y = [], []
    for bx, by in ((0.0, 0.0), (0.0, 0.5), (0.5, 0.0), (0.5, 0.5)):
        gx, gy = np.meshgrid((cells + bx * a) % box_length, (cells + by * a) % box_length,
                             indexing="ij")
        cols_x.append(gx.ravel())
        cols_y.append(gy.ravel())
    inv_w = m_xy / box_length
    ix = np.clip((np.concatenate(cols_x) * inv_w).astype(np.int64), 0, m_xy - 1)
    iy = np.clip((np.concatenate(cols_y) * inv_w).astype(np.int64), 0, m_xy - 1)
    occ = np.bincount(ix * m_xy + iy, minlength=m_xy * m_xy) * num_cells
    return int(occ.max())


def make_pencil_grid(n: int, box_length: float, r_list: float, density: float,
                     capacity: int = 0) -> PencilGrid:
    m_xy = int(math.floor(box_length / r_list))
    if m_xy < 3:
        raise ValueError(
            f"box holds only {m_xy} pencils of width >= {r_list}; "
            "use the dense kernel for small boxes"
        )
    cap = capacity or pencil_capacity(n, density, box_length, m_xy)
    return PencilGrid(m_xy=m_xy, capacity=cap, box_length=box_length)


def _pencil_ids(x: torch.Tensor, y: torch.Tensor, grid: PencilGrid) -> torch.Tensor:
    inv_w = grid.m_xy / grid.box_length
    ix = torch.clamp((x * inv_w).to(torch.int32), 0, grid.m_xy - 1)
    iy = torch.clamp((y * inv_w).to(torch.int32), 0, grid.m_xy - 1)
    return ix * grid.m_xy + iy


def _counts_starts(keys: torch.Tensor, n_keys: int):
    """(counts, exclusive starts) of the int keys in [0, n_keys]; key
    ``n_keys`` (invalid) is not counted. A scatter-add, not
    ``torch.bincount``: on a CUDA tensor bincount reads the keys' min and
    max on the host, two synchronizations per rebin."""
    keys = keys.long()
    counts = torch.zeros((n_keys + 1,), dtype=torch.long, device=keys.device)
    counts = counts.scatter_add_(0, keys, torch.ones_like(keys))[:n_keys]
    starts = torch.cumsum(counts, 0) - counts
    return counts, starts


def bin_to_slots(r: torch.Tensor, grid: PencilGrid):
    """Bin (N, 3) wrapped positions into pencil slots: returns
    (slot_of_particle (N,) int64, overflow bool tensor). Ranks within a
    pencil ascend in z, ties broken by particle index."""
    n = r.shape[0]
    pid = _pencil_ids(r[:, 0], r[:, 1], grid)
    # lexsort((z, pid)): stable by z, then stable by pencil.
    by_z = torch.sort(r[:, 2], stable=True).indices
    order = by_z[torch.sort(pid[by_z], stable=True).indices]
    sorted_pid = pid[order]
    _, starts = _counts_starts(pid, grid.n_pencils)
    ranks_sorted = torch.arange(n, device=r.device) - starts[sorted_pid.long()]
    ranks = torch.empty_like(ranks_sorted)
    ranks[order] = ranks_sorted
    overflow = torch.any(ranks >= grid.capacity)
    slot = pid.long() * grid.capacity + torch.clamp(ranks, max=grid.capacity - 1)
    return slot, overflow


def rebin_gather_parts(rows_r: torch.Tensor, valid: torch.Tensor, grid: PencilGrid,
                       z_order: bool = False, replicas: int | None = None):
    """Recompute the slot assignment from slot-layout data, in gather form:
    returns ``(order, src, valid_new, overflow)`` with the new layout
    ``new[:, t] = old[:, order[src[t]]] where valid_new[t]``. ``rows_r`` is
    (8, n_slots) with x/y/z in rows 0..2; ``valid`` (n_slots,) is 1/0.
    Invalid slots sort last; overflow victims (rank >= capacity) are
    dropped, with ``overflow`` set. Ranks within a pencil follow the old
    slot order, or ascend in z with ``z_order`` (JAX's
    ``lexsort((z where valid else 0, pencil))``, which the z-banded sweep's
    windows need).

    ``replicas=R``: the rows are R grids side by side ((8, R * n_slots),
    replica q in slots [q * n_slots, (q + 1) * n_slots)), each slot keyed
    by its pencil + q * n_pencils, so that the one stable sort orders each
    replica as its own rebin would and no particle leaves its replica;
    ``overflow`` is then (R,), one flag a replica."""
    reps = 1 if replicas is None else replicas
    ns = grid.n_slots * reps
    n_keys = grid.n_pencils * reps
    cap = grid.capacity
    dev = rows_r.device
    pid = _pencil_ids(rows_r[0], rows_r[1], grid)
    if replicas is not None:
        pid = pid + (torch.arange(ns, device=dev, dtype=torch.int32) // grid.n_slots
                     ) * grid.n_pencils
    is_valid = valid > 0.5
    pid_key = torch.where(is_valid, pid, n_keys)
    if z_order:
        zkey = torch.where(is_valid, rows_r[2], torch.zeros((), dtype=rows_r.dtype, device=dev))
        by_z = torch.sort(zkey, stable=True).indices
        order = by_z[torch.sort(pid_key[by_z], stable=True).indices]
    else:
        order = torch.sort(pid_key, stable=True).indices
    counts, starts = _counts_starts(pid_key, n_keys)
    over = counts > cap
    overflow = torch.any(over) if replicas is None else over.reshape(reps, -1).any(dim=1)
    j = torch.arange(cap, device=dev)
    src = torch.clamp((starts[:, None] + j[None, :]).reshape(ns), 0, ns - 1)
    valid_new = (j[None, :] < torch.clamp(counts, max=cap)[:, None]).reshape(ns)
    return order, src, valid_new, overflow


def rebin_gather(rows_r: torch.Tensor, valid: torch.Tensor, grid: PencilGrid,
                 z_order: bool = False):
    """``rebin_gather_parts`` with the permutation composed:
    ``(old_of_new (ns,), valid_new (ns,) bool, overflow)``."""
    order, src, valid_new, overflow = rebin_gather_parts(rows_r, valid, grid, z_order)
    return order[src], valid_new, overflow


def default_z_window(grid: PencilGrid, n: int, r_extend: float, tile_i: int = 128) -> int:
    """Static z-window width (slots) of the z-banded sweep: the expected rank
    span of a tile_i slice plus the rank-equivalent of the +-r_extend z
    margin, times a fluctuation factor 1.35, + 16, + 128 for starts aligned
    down to 128; 128-aligned, clamped to [128, capacity]."""
    occ = n / grid.n_pencils
    est = (tile_i + 2.0 * r_extend / grid.box_length * occ) * 1.35 + 16 + 128
    w = ((int(est) + 127) // 128) * 128
    return max(128, min(w, grid.capacity))


def compute_z_windows(rows_r: torch.Tensor, valid: torch.Tensor, counts: torch.Tensor,
                      grid: PencilGrid, window: int, r_extend: float, tile_i: int = 128,
                      replicas: int | None = None):
    """Per-(i-slice, neighbour) z-window start tables of the z-banded sweep.

    For each tile_i-slot i-slice and each of its 9 xy-neighbour pencils, up
    to two ``window``-slot rank windows that cover every j whose z (at this
    rebin) lies within [zmin_i - r_extend, zmax_i + r_extend], circularly in
    z: window A the main interval, window B the spill across z = 0 or z = L
    (the sweep dedups B against A by rank). Starts are aligned down to 128
    and clamped to capacity - window. Needs z-sorted ranks in each pencil.

    Returns ``(start_a, start_b, use_b, overflow)``: three (T * 9,) int32
    tables, T = n_slots / tile_i, and a 0-d bool set where a window cannot
    cover its interval (pairs would be missed).

    ``replicas=R``: the rows are R grids side by side (``rebin_gather_parts``
    with ``replicas``), each i-slice's neighbours those of its own grid
    (replica q's pencils offset by q * n_pencils): tables of R * T * 9
    entries, replica q's at [q * T * 9, (q + 1) * T * 9) and equal to its
    grid's alone (the ranks are each pencil's own), and ``overflow`` (R,)."""
    reps = 1 if replicas is None else replicas
    cap = grid.capacity
    L = grid.box_length
    dev = rows_r.device
    T = grid.n_slots // tile_i * reps
    big = 2.0 * L  # z of empty slots: sorts after every real z
    z = rows_r[2]
    ok = valid > 0.5
    zcol = torch.where(ok, z, big).reshape(grid.n_pencils * reps, cap)
    zsl = z.reshape(T, tile_i)
    vsl = ok.reshape(T, tile_i)
    zmin = torch.where(vsl, zsl, big).min(dim=1).values
    zmax = torch.where(vsl, zsl, -big).max(dim=1).values
    nonempty = vsl.any(dim=1)
    lo = zmin - r_extend
    hi = zmax + r_extend

    nbr = torch.as_tensor(grid.neighbor_table(), dtype=torch.long, device=dev)
    if replicas is not None:
        off = torch.arange(reps, device=dev) * grid.n_pencils
        nbr = (nbr[None] + off[:, None, None]).reshape(-1, 9)
    nbrs = nbr[torch.arange(T, device=dev) // (cap // tile_i)]  # (T, 9)
    zk = zcol[nbrs]                                              # (T, 9, cap)

    def ss(values, right):  # (T,) values against each (slice, neighbour) column
        v = values[:, None, None].expand(T, 9, 1).contiguous()
        return torch.searchsorted(zk, v, right=right)[..., 0]

    s1 = ss(torch.clamp(lo, min=0.0), False)
    e1 = ss(torch.clamp(hi, max=L), True)
    start_a = torch.clamp((s1 // 128) * 128, max=cap - window)
    over_a = e1 > start_a + window

    wrap_lo = (lo < 0.0)[:, None].expand(T, 9)
    wrap_hi = (hi > L)[:, None].expand(T, 9)
    # wrap below: [lo + L, L] -> ranks [s2, count); above: [0, hi - L] -> [0, e3)
    s2 = ss(lo + L, False)
    e2 = counts.long()[nbrs]
    e3 = ss(hi - L, True)
    use_b = wrap_lo | wrap_hi
    b_start_raw = torch.where(wrap_lo, s2, 0)
    b_end = torch.where(wrap_lo, e2, e3)
    start_b = torch.clamp((b_start_raw // 128) * 128, max=cap - window)
    over_b = use_b & (b_end > start_b + window)

    bad = nonempty[:, None] & (over_a | over_b | (wrap_lo & wrap_hi))
    overflow = torch.any(bad) if replicas is None else bad.reshape(reps, -1).any(dim=1)
    i32 = torch.int32
    return (start_a.to(i32).reshape(-1), start_b.to(i32).reshape(-1),
            use_b.to(i32).reshape(-1), overflow)
