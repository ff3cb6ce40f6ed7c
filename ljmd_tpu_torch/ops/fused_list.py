"""Fused multi-step Verlet chunk over window visit lists (counterpart of
``ops/pallas_fused.py::fused_dense_chunk_list`` under the window contract the
zsort engine uses: ``j_granule=tile_i``, four categories, per-width tails,
jmin prefix mask).

Same contract as ``ops/fused.py``'s chunks: (8, n_pad) rows in the engine's
sorted column order, ``a`` 24-prefactored, no wrap inside the chunk. The
visit lists (``ops/window_lists.py``) say which pairs are evaluated and
which minimum-image rounds each pair takes; a pair contributes iff some
visit covers it un-masked. Modes: plain (returns r, v, a), extended
(``r_lo``/``vc`` given: two-float positions and compensated velocities,
returns r, r_lo, v, vc, a) and ``obs_last`` (one more (8, n_pad) output
whose rows 3..5 hold the final step's pair-once e/du/ddu partials, summed on
each visit's i side; the caller restores 4 / 24).

The TPU kernel's ``mxu_reduce``, ``trans_acc`` and ``dual_acc`` options are
TPU layout experiments and are not ported.

Both the kernel and the twin evaluate the lists granule by granule: each
128-column granule meets the 128-column stages of the visits that touch it,
in list order (``list_plan_stages``: a visit whose i-block is the granule
gives its j columns, "forward"; a visit whose j columns hold the granule
gives its 128 i rows, "backward", the mask read from the other side), each
pair from both of its sides. The kernel gathers that plan once per launch
into a scratch the wrapper allocates (the lists do not change inside a
chunk).

On a CUDA tensor each chunk is ONE cooperative launch of
``csrc/fused_dense_chunk_list.cu`` (the launch shape from ``list_plan``);
on a CPU tensor the plain twin runs a Python step loop over the plan.

Where the position plane stays in shared memory and a warp takes at least
``LIST_MIN_RUNS`` runs of a stage (S <= 32: N=4000's S = 16, not N=864's
S = 64), the kernel takes each granule's columns in xy order
(``list_granule_order``: a c x c grid of cells, ``list_cells``, in snake
order, then z), and a warp skips a run of partner slots whose box lies at
least rc from the box of its own particles (``list_skip_runs`` is that test
in plain torch; ``list_skip_counts`` the runs it tests and skips). The
pairs it skips add exact zeros, so the twin, which evaluates every listed
pair, stays the kernel's reference; only each particle's order of
summation differs. ``skip_counts`` (an int64 (2,) or (R, 2) CUDA tensor)
gets the runs tested and skipped added.

Replicas (the batched zsort engine): (R, 8, n_pad) rows with (R, rows, max_t)
lists and (R, n_cats) counts, each replica over its own lists, in ONE launch
of the kernel's replica kernel (counted as ``fused_dense_chunk_list_replicas``;
the launch shape ``list_replicas_plan``, at the one-replica plan's S, so
replica q's rows equal a launch on replica q alone bit for bit); on a CPU
tensor the twin runs replica by replica.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.fused import MAX_CHUNK_STEPS, comp_add
from ljmd_tpu_torch.ops.pair_terms import lj_pair_terms_plain

__all__ = ["fused_dense_chunk_list", "fused_dense_chunk_list_plain", "list_cells",
           "list_coverage", "list_granule_order", "list_plan", "list_plan_stages",
           "list_plan_stride", "list_replicas_plan", "list_skip_counts", "list_skip_runs"]

# The kernel's list granule: visits start and end on 128-column blocks.
LIST_TILE_I = 128
# A plan entry's meta word (csrc/fused_dense_chunk_list.cu): bit 0 forward,
# 1 masked, 2 x round, 3 z round, bits 4.. the jmin block.
_FWD, _MASKED, _MIC_X, _MIC_Z = 1, 2, 4, 8
# Plan stages the twin evaluates at once.
_STAGE_BATCH = 256
# The xy order's grid: at most 8 x 8 cells (two columns a cell of a granule
# on average), cells of about 0.8 rc a side.
LIST_MAX_CELLS = 8
# The narrowest run of slots a box covers (csrc: kListBoxCols).
LIST_BOX_COLS = 16
# Runs a warp takes of a stage, at least, for the box test (csrc:
# kListMinRuns): with S = 64 (two a stage) every run is kept untested.
LIST_MIN_RUNS = 4
# The box test's margins (csrc: BoxMargins): eps_rel x L off each axis's
# gap, rc^2 x (1 + rc2_rel) the bar, by element size.
_BOX_MARGINS = {4: (2.0 ** -19, 2.0 ** -18), 8: (2.0 ** -48, 2.0 ** -47)}


def _categories(n_tails: int, span: int):
    """(count index, tiles row, width in blocks, masked, x round, z round)
    of each list: the four window categories, then the tails."""
    cats = [(0, 0, span, False, False, False), (1, 2, span, False, True, False),
            (2, 4, span, False, True, True), (3, 6, span, True, True, True)]
    cats += [(4 + w - 1, 9 + 2 * (w - 1), w, True, True, True) for w in range(1, n_tails + 1)]
    return cats


def _check_lists(tiles, tcounts, n_pad, tile_i, tile_j):
    if tile_i != LIST_TILE_I or tile_j % tile_i or n_pad % tile_i or tile_j > n_pad:
        raise ValueError(f"fused_dense_chunk_list: needs tile_i={LIST_TILE_I} dividing "
                         f"tile_j={tile_j} <= n_pad={n_pad}, got tile_i={tile_i}")
    n_tails = (tiles.shape[0] - 9) // 2
    if tiles.dim() != 2 or n_tails < 0 or tiles.shape[0] != 9 + 2 * n_tails \
            or tcounts.shape != (4 + n_tails,) or n_tails > tile_j // tile_i - 1:
        raise ValueError(f"fused_dense_chunk_list: tiles {tuple(tiles.shape)} / tcounts "
                         f"{tuple(tcounts.shape)} are not a window-list layout")
    return n_tails


def list_coverage(tiles, tcounts, n, n_pad, tile_i, tile_j):
    """(cover, mic_x, mic_z), each (n_pad, n_pad) bool on the lists' device:
    ``cover[i, j]`` iff some visit with i on its row side covers the pair
    (i, j) un-masked; ``mic_x`` / ``mic_z`` where that visit takes the x / z
    minimum-image round (the y round is always taken). Reads the counts on
    the host: a reference for tests and candidate counts, not the card
    path."""
    n_tails = _check_lists(tiles, tcounts, n_pad, tile_i, tile_j)
    span = tile_j // tile_i
    dev = tiles.device
    t = tiles.cpu().tolist()
    counts = tcounts.cpu().tolist()
    cover = torch.zeros((n_pad, n_pad), dtype=torch.bool, device=dev)
    mic_x = torch.zeros_like(cover)
    mic_z = torch.zeros_like(cover)
    col = torch.arange(n_pad, device=dev)
    for cidx, row, wb, masked, rx, rz in _categories(n_tails, span):
        for k in range(counts[cidx]):
            i0, j0 = t[row][k] * tile_i, t[row + 1][k] * tile_i
            w = wb * tile_i
            gi, gj = col[i0:i0 + tile_i, None], col[None, j0:j0 + w]
            if masked:
                jmin = t[8][k] * tile_i if cidx == 3 else 0
                blk = (gj > gi) & (gj < n) & (gi < n) & (gj >= jmin)
            else:
                blk = torch.ones((tile_i, w), dtype=torch.bool, device=dev)
            cover[i0:i0 + tile_i, j0:j0 + w] |= blk
            if rx:
                mic_x[i0:i0 + tile_i, j0:j0 + w] |= blk
            if rz:
                mic_z[i0:i0 + tile_i, j0:j0 + w] |= blk
    return cover, mic_x, mic_z


def list_plan_stride(n_pad: int, tile_j: int) -> int:
    """The most plan stages a 128-column granule can have: 3 n_b + span
    (a row's visits start at least span blocks apart, so its forward
    stages number at most n_b + span - 1; at most two visits of a row hold
    a given block)."""
    return 3 * (n_pad // LIST_TILE_I) + tile_j // LIST_TILE_I


def list_plan_stages(tiles, tcounts, n_pad: int, tile_j: int):
    """The visit plan of the list chunk, the rule of
    ``csrc/fused_dense_chunk_list.cu`` as torch ops on the lists' device:
    for each 128-column granule g, the 128-column stages of the visits that
    touch it, in list order (categories, then the tails, each by its
    count), each visit's forward stages (its i-block is g: its j columns,
    one stage a block) before its backward one (its j columns hold g: its
    128 i rows). Returns int64 (offsets (n_b + 1,), col0 (E,), meta (E,)):
    granule g's stages are [offsets[g], offsets[g + 1]), ``col0`` each
    stage's first column, ``meta`` its word (bit 0 forward, 1 masked, 2 x
    round, 3 z round, bits 4.. the jmin block)."""
    n_tails = _check_lists(tiles, tcounts, n_pad, LIST_TILE_I, tile_j)
    span = tile_j // LIST_TILE_I
    n_b = n_pad // LIST_TILE_I
    dev = tiles.device
    max_t = tiles.shape[1]
    t = torch.arange(max_t, device=dev)
    grans, keys, cols, metas = [], [], [], []
    for cidx, row, wb, masked, rx, rz in _categories(n_tails, span):
        live = t < tcounts[cidx].long()
        ib, jb = tiles[row].long(), tiles[row + 1].long()
        jmin = tiles[8].long() if cidx == 3 else torch.zeros_like(ib)
        meta = (_MASKED * masked) | (_MIC_X * rx) | (_MIC_Z * rz) | (jmin << 4)
        key = (cidx * max_t + t) * (span + 1)  # list order; forward d < span, backward span
        for d in range(wb):
            grans += [torch.where(live, ib, n_b), torch.where(live, jb + d, n_b)]
            keys += [key + d, key + span]
            cols += [(jb + d) * LIST_TILE_I, ib * LIST_TILE_I]
            metas += [meta | _FWD, meta]
    gran, key = torch.cat(grans), torch.cat(keys)
    order = torch.argsort(gran * (len(_categories(n_tails, span)) * max_t * (span + 1)) + key)
    gran = gran[order]
    keep = gran < n_b
    offsets = torch.searchsorted(gran[keep], torch.arange(n_b + 1, device=dev))
    return offsets, torch.cat(cols)[order][keep], torch.cat(metas)[order][keep]


def list_cells(box_length: float, rc: float) -> int:
    """c of the c x c grid of xy cells that orders each granule's slots:
    cells of about 0.8 rc a side, at most ``LIST_MAX_CELLS`` (L = 16.796,
    rc = 2.5: 8; L = 10.078: 5)."""
    return max(1, min(LIST_MAX_CELLS, int(box_length / (0.8 * rc))))


def list_granule_order(r, n, box_length, cells):
    """The kernel's xy order of each 128-column granule of (8, n_pad) rows
    (or each replica's of (R, 8, n_pad)): int64 (..., n_pad), the column
    at each slot. Columns are keyed by their cell of the c x c grid in x and
    y (c / L computed in the rows' dtype; NaN in cell 0), the rows of cells
    in snake order, padding columns (>= n) last, and sorted stably within
    their granule: the order of equal keys is the columns' (z) order."""
    n_pad = r.shape[-1]
    n_b = n_pad // LIST_TILE_I
    scale = torch.tensor(cells / box_length, dtype=r.dtype, device=r.device)

    def cell(x):
        f = x * scale
        return torch.where(f >= cells - 1, cells - 1,
                           torch.where(f >= 1, torch.trunc(f), 0.0)).long()

    cx, cy = cell(r[..., 0, :]), cell(r[..., 1, :])
    key = cy * cells + torch.where(cy % 2 == 1, cells - 1 - cx, cx)
    key = torch.where(torch.arange(n_pad, device=r.device) < n, key, cells * cells)
    local = torch.sort(key.reshape(*key.shape[:-1], n_b, LIST_TILE_I), dim=-1,
                       stable=True).indices
    base = torch.arange(n_b, device=r.device)[:, None] * LIST_TILE_I
    return (local + base).reshape(key.shape)


def _boxes(x, real=None):
    """Centres and half-widths of the point sets on the last axis of x (3,
    ..., k), as the kernel rounds them; a NaN or infinity among the points
    (the real ones) makes the centre NaN."""
    if real is None:
        lo, hi, bad = x.amin(-1), x.amax(-1), (x - x).sum(-1)
    else:
        inf = float("inf")
        lo = torch.where(real, x, inf).amin(-1)
        hi = torch.where(real, x, -inf).amax(-1)
        bad = torch.where(real, x - x, 0.0).sum(dim=(0, -1))
    return (lo + hi) * 0.5 + bad, (hi - lo) * 0.5


def list_skip_runs(r, tiles, tcounts, n, box_length, rc_square, tile_j, slices, cells=None):
    """The kernel's box test at one step, in plain torch, for (8, n_pad)
    rows ``r`` (the step's positions, sorted columns) at S = ``slices`` (4,
    8, 16 or 32: the kernel makes the test where a warp takes at least
    ``LIST_MIN_RUNS`` runs of a stage): each granule's slots in xy order
    (``list_granule_order`` of ``r``, the launch's start), a warp 32 / S
    consecutive slots, its box over its real slots; a stage's k-th run of a
    warp its S slots from k S, tested against the box of the
    ``LIST_BOX_COLS`` (S = 32: 32) slots that hold it. A run is skipped
    where the lower bound of the minimum-image gap squared, in the rows'
    dtype, reaches rc^2 (1 + rc2_rel): per axis max(0, |mi(c_warp - c_run)|
    - (h_warp + h_run) - eps_rel L).

    Returns a dict: ``perm`` (n_pad,), ``gran`` (E,) / ``col0`` (E,) /
    ``meta`` (E,) of the plan's stages (``list_plan_stages``), ``slots``
    (E, warps, 32 / S) the slots of each stage's warps (of its granule),
    ``live`` (E, warps) whether the warp holds a real slot, ``cols`` (E,
    warps, 128 / S, S) the partner slots of each run and ``skip`` (E,
    warps, 128 / S)."""
    S = int(slices)
    if S not in (4, 8, 16, 32):
        raise ValueError(f"list_skip_runs: the kernel tests no run at S={S}")
    dev, dtype = r.device, r.dtype
    n_pad = r.shape[-1]
    if cells is None:
        cells = list_cells(box_length, math.sqrt(rc_square))
    perm = list_granule_order(r, n, box_length, cells)
    offsets, col0, meta = list_plan_stages(tiles, tcounts, n_pad, tile_j)
    gran = torch.repeat_interleave(torch.arange(offsets.numel() - 1, device=dev),
                                   offsets[1:] - offsets[:-1])
    p = r[0:3][:, perm]
    real = perm < n
    W = 32 if S == 32 else LIST_BOX_COLS
    run_c, run_h = _boxes(p.reshape(3, -1, W))
    ppw = 32 // S  # particles a warp
    w_c, w_h = _boxes(p.reshape(3, -1, ppw), real.reshape(-1, ppw))
    live = real.reshape(-1, ppw).any(-1)
    per_g = LIST_TILE_I // ppw  # warps a granule
    wg = gran[:, None] * per_g + torch.arange(per_g, device=dev)               # (E, warps)
    first = col0[:, None, None] + torch.arange(LIST_TILE_I // S, device=dev) * S  # (E, 1, nk)
    run = (first // W).expand(-1, per_g, -1)
    L = torch.tensor(box_length, dtype=dtype, device=dev)
    inv_l = torch.tensor(1.0 / box_length, dtype=dtype, device=dev)
    eps_rel, rc2_rel = _BOX_MARGINS[r.element_size()]
    eps = L * eps_rel
    bar = torch.tensor(rc_square, dtype=dtype, device=dev) * (1.0 + rc2_rel)
    g2 = None
    for a in range(3):
        d = w_c[a][wg][..., None] - run_c[a][run]
        d = torch.abs(d - L * torch.round(d * inv_l))
        g = (d - (w_h[a][wg][..., None] + run_h[a][run])) - eps
        g = torch.where(g < 0, 0.0, g)
        g2 = g * g if g2 is None else g2 + g * g
    slots = wg[..., None] * ppw + torch.arange(ppw, device=dev)
    cols = first.expand(-1, per_g, -1)[..., None] + torch.arange(S, device=dev)
    return {"perm": perm, "gran": gran, "col0": col0, "meta": meta, "slots": slots,
            "live": live[wg], "cols": cols, "skip": g2 >= bar}


def list_skip_counts(r, tiles, tcounts, n, box_length, rc_square, tile_j, slices, cells=None):
    """The runs the kernel tests and skips at one step at positions ``r``
    (``list_skip_runs``; a warp without a real slot tests none, and no warp
    where it takes fewer than ``LIST_MIN_RUNS`` runs of a stage, S = 64):
    int64 (tested, skipped), or (R, 2) for (R, 8, n_pad) rows and (R, ...)
    lists."""
    if r.dim() == 3:
        return torch.stack([list_skip_counts(r[q], tiles[q], tcounts[q], n, box_length,
                                             rc_square, tile_j, slices, cells)
                            for q in range(r.shape[0])])
    if LIST_TILE_I // slices < LIST_MIN_RUNS:
        return torch.zeros(2, dtype=torch.int64, device=r.device)
    t = list_skip_runs(r, tiles, tcounts, n, box_length, rc_square, tile_j, slices, cells)
    return torch.stack([t["live"].sum() * t["skip"].shape[-1],
                        (t["skip"] & t["live"][..., None]).sum()])


def _plan_forces(pos, lo, plan, n, box_length, rc_square, want_obs):
    """Forces / 24 on every column (rows 0..2) from the plan's stages, each
    granule from its own side, and, when ``want_obs``, the e/du/ddu
    partials of the forward stages (rows 3..5): (8, n_pad)."""
    offsets, col0, meta = plan
    dev, dt = pos.device, pos.dtype
    L, inv_l = box_length, 1.0 / box_length
    gran = torch.repeat_interleave(torch.arange(offsets.numel() - 1, device=dev),
                                   offsets[1:] - offsets[:-1])
    ar = torch.arange(LIST_TILE_I, device=dev)
    out = torch.zeros_like(pos)

    def mic(c):
        return c - L * torch.round(c * inv_l)

    for b0 in range(0, gran.numel(), _STAGE_BATCH):
        sl = slice(b0, b0 + _STAGE_BATCH)
        mt = meta[sl][:, None, None]
        ii = (gran[sl][:, None] * LIST_TILE_I + ar)[:, :, None]   # (B, 128, 1)
        jj = (col0[sl][:, None] + ar)[:, None, :]                  # (B, 1, 128)
        d = [pos[c][ii] - pos[c][jj] for c in range(3)]
        if lo is not None:
            d = [d[c] + (lo[c][ii] - lo[c][jj]) for c in range(3)]
        dx = torch.where((mt & _MIC_X) > 0, mic(d[0]), d[0])
        dy = mic(d[1])
        dz = torch.where((mt & _MIC_Z) > 0, mic(d[2]), d[2])
        r2 = dx * dx + dy * dy + dz * dz
        fwd = (mt & _FWD) > 0
        gr, gc = torch.where(fwd, ii, jj), torch.where(fwd, jj, ii)
        pair_ok = (gc > gr) & (gc < n) & (gr < n) & (gc >= (mt >> 4) * LIST_TILE_I)
        mask = (r2 < rc_square) & (((mt & _MASKED) == 0) | pair_ok)
        coef, du, e, ddu = lj_pair_terms_plain(r2, mask, want_obs)
        fi = ii.reshape(-1)
        for row, dr in enumerate((dx, dy, dz)):
            out[row].index_add_(0, fi, (coef * dr).sum(dim=2).reshape(-1))
        if want_obs:
            for row, term in ((3, e), (4, du), (5, ddu)):
                out[row].index_add_(0, fi, torch.where(fwd, term, 0.0).sum(dim=2).reshape(-1))
    return out


def fused_dense_chunk_list_plain(r, v, a, tiles, tcounts, n, box_length, rc_square,
                                 dt, n_steps, tile_i=128, tile_j=512, r_lo=None,
                                 vc=None, obs_last=False):
    """Plain twin of ``fused_dense_chunk_list``: a Python loop of Verlet
    steps over the visit plan (``list_plan_stages``); on (R, 8, n_pad) rows
    with (R, ...) lists, replica by replica."""
    if r.dim() == 3:
        outs = [fused_dense_chunk_list_plain(
            r[q], v[q], a[q], tiles[q], tcounts[q], n, box_length, rc_square, dt, n_steps,
            tile_i, tile_j, None if r_lo is None else r_lo[q], None if vc is None else vc[q],
            obs_last) for q in range(r.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    if not 0 <= n_steps <= MAX_CHUNK_STEPS:
        raise ValueError(f"n_steps={n_steps} outside [0, MAX_CHUNK_STEPS={MAX_CHUNK_STEPS}]")
    if tile_i != LIST_TILE_I:
        raise ValueError(f"fused_dense_chunk_list: needs tile_i={LIST_TILE_I}, got {tile_i}")
    extended = r_lo is not None
    plan = list_plan_stages(tiles, tcounts, r.shape[1], tile_j)
    real = (torch.arange(r.shape[1], device=r.device) < n).to(r.dtype)
    half_dt = 0.5 * dt
    half_dt_sq = 0.5 * dt * dt
    obs = torch.zeros_like(r)
    for s in range(n_steps):
        want_obs = obs_last and s == n_steps - 1
        if extended:
            r, r_lo = comp_add(r, r_lo, (v + vc) * dt + a * half_dt_sq)
            v, vc = comp_add(v, vc, a * half_dt)
        else:
            r = r + v * dt + a * half_dt_sq
            v = v + a * half_dt
        sweep = _plan_forces(r, r_lo, plan, n, box_length, rc_square, want_obs) * real
        a = torch.zeros_like(r)
        a[0:3] = 24.0 * sweep[0:3]
        if extended:
            v, vc = comp_add(v, vc, a * half_dt)
        else:
            v = v + a * half_dt
        if want_obs:
            obs[3:6] = sweep[3:6]
    out = (r, r_lo, v, vc, a) if extended else (r, v, a)
    return out + (obs,) if obs_last else out


# The plane a launch takes (the kernel's kPlane*): streamed, resident, and
# resident with the xy order and the box test.
_PLANE_STREAMED, _PLANE_SLOTS = 0, 2


@functools.lru_cache(maxsize=None)
def _plan(device_index: int, element_size: int, extended: bool, n_pad: int, slices: int,
          grid_cap: int, replicas: int = 0) -> dict:
    """The kernel's launch shape (cached: it depends only on the card, the
    variant and these sizes); ``replicas`` > 0: the replica kernel's for
    that many replicas, at the given S (the one-replica plan's)."""
    out = (ctypes.c_int * 8)()
    lib = _cuda.library()
    with torch.cuda.device(device_index):
        if replicas:
            code = lib.ljmd_list_replicas_plan(element_size, int(extended), n_pad, slices,
                                               replicas, grid_cap, out)
        else:
            code = lib.ljmd_list_plan(element_size, int(extended), n_pad, slices, grid_cap, out)
        _cuda.check(code, "fused_dense_chunk_list occupancy query")
    s, plane, per_sm, sms, smem, blocks, regs, spill = out
    threads = lib.ljmd_list_block_threads()
    plan = {"slices": s, "particles_per_item": threads // s,
            "items": max(1, replicas) * n_pad * s // threads,
            "resident": plane != _PLANE_STREAMED, "slots": plane == _PLANE_SLOTS,
            "blocks_per_sm": per_sm, "sms": sms,
            "smem_bytes": smem, "blocks": blocks,
            "warps_per_sm": blocks * (threads // 32) / sms, "regs": regs, "spill_bytes": spill}
    return {**plan, "replicas": replicas} if replicas else plan


def list_plan(r, extended=False, slices=None, grid_cap=None) -> dict:
    """The list chunk kernel's launch shape for rows ``r`` (on the card):
    threads a particle (``slices``, S), particles a work item, work items,
    whether the position plane stays in shared memory for the step
    (``resident``) or streams through a ring, whether the launch takes the
    xy order and the box test (``slots``: resident, with room for the boxes
    at two blocks an SM, and S <= 32), blocks an SM holds, the
    persistent grid (``blocks``), the warps it puts on each SM, and
    registers and spill bytes a thread. ``slices`` and ``grid_cap``
    (measurements and tests only) ask for a given S or a capped grid."""
    _cuda.require_cuda_rows("list_plan", r)
    return _plan(r.device.index, r.element_size(), bool(extended), r.shape[1], int(slices or 0),
                 int(grid_cap or 0))


def list_replicas_plan(r, extended=False, grid_cap=None) -> dict:
    """The replica kernel's launch shape for (R, 8, n_pad) rows ``r`` (on
    the card): ``list_plan``'s fields at the one-replica plan's S, its work
    items and persistent grid over all R replicas."""
    _cuda.require_cuda_rows("list_replicas_plan", r, replicas=True)
    slices = list_plan(r[0], extended)["slices"]
    return _plan(r.device.index, r.element_size(), bool(extended), r.shape[-1], slices,
                 int(grid_cap or 0), r.shape[0])


def _launch(r, v, a, tiles, tcounts, n, box_length, rc_square, dt, n_steps,
            tile_i, tile_j, r_lo, vc, obs_last, grid_cap=None, slices=None, skip_counts=None):
    """One launch of the kernel, on (8, n_pad) rows or (R, 8, n_pad) replica
    stacks with (R, ...) lists (the replica kernel, counted as ``name +
    "_replicas"``); ``grid_cap`` (tests and the smoke script only) caps the
    persistent grid so that each block takes several work items; ``slices``
    (measurements only, one system) asks for a given S; ``skip_counts`` (int64
    (2,), or (R, 2) for a stack, on the rows' device) gets the runs tested and
    skipped added."""
    extended = r_lo is not None
    replicas = r.dim() == 3
    name = "fused_dense_chunk_list"
    _cuda.require_cuda_rows(name, *((r, r_lo, v, vc, a) if extended else (r, v, a)),
                            replicas=replicas)
    n_pad = r.shape[-1]
    batch = tuple(r.shape[:1]) if replicas else ()
    if not 0 <= n_steps <= MAX_CHUNK_STEPS:
        raise ValueError(f"n_steps={n_steps} outside [0, MAX_CHUNK_STEPS={MAX_CHUNK_STEPS}]")
    if not 0 <= n <= n_pad:
        raise ValueError(f"{name}: n={n} outside [0, n_pad={n_pad}]")
    if tiles.shape[:len(batch)] != batch or tcounts.shape[:len(batch)] != batch \
            or tiles.dim() != 2 + len(batch):
        raise ValueError(f"{name}: lists {tuple(tiles.shape)} / {tuple(tcounts.shape)} do not "
                         f"match rows {tuple(r.shape)}")
    n_tails = _check_lists(tiles[0] if replicas else tiles, tcounts[0] if replicas else tcounts,
                           n_pad, tile_i, tile_j)
    for t in (tiles, tcounts):
        if t.device != r.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: tiles / tcounts must be contiguous int32 on {r.device}")
    if replicas and slices is not None:
        raise ValueError(f"{name}: the replica launch takes the one-replica plan's S")
    if skip_counts is not None and (skip_counts.shape != batch + (2,) or skip_counts.dtype
                                    != torch.int64 or skip_counts.device != r.device
                                    or not skip_counts.is_contiguous()):
        raise ValueError(f"{name}: skip_counts must be a contiguous int64 {batch + (2,)} "
                         f"tensor on {r.device}")
    suffix = _cuda.dtype_suffix(r.dtype)
    lib = _cuda.library()
    rbuf = torch.zeros((2,) + tuple(r.shape), dtype=r.dtype, device=r.device)
    rbuf[0].copy_(r)
    lobuf = None
    if extended:
        lobuf = torch.zeros_like(rbuf)
        lobuf[0].copy_(r_lo)
    v_out, a_out = v.clone(), a.clone()
    vc_out = vc.clone() if extended else None
    obs = torch.zeros_like(r) if obs_last else None
    if n_steps > 0:
        plan = (list_replicas_plan(r, extended, grid_cap) if replicas
                else list_plan(r, extended, slices, grid_cap))
        stride = list_plan_stride(n_pad, tile_j)
        n_b = n_pad // LIST_TILE_I * (batch[0] if replicas else 1)  # granules of all replicas
        # plan entries, then each granule's entry count, then the xy order
        scratch = torch.empty((n_b * (2 * stride + 1 + LIST_TILE_I),), dtype=torch.int32,
                              device=r.device)
        cells = list_cells(float(box_length), math.sqrt(float(rc_square)))
        entry = f"ljmd_{name}_replicas_{suffix}" if replicas else f"ljmd_{name}_{suffix}"
        with torch.cuda.device(r.device):
            code = getattr(lib, entry)(
                rbuf.data_ptr(), lobuf.data_ptr() if extended else None,
                v_out.data_ptr(), vc_out.data_ptr() if extended else None,
                a_out.data_ptr(), obs.data_ptr() if obs_last else None,
                tiles.data_ptr(), tcounts.data_ptr(), tiles.shape[-1], n_tails,
                tile_j // tile_i, n, n_pad, *batch, float(box_length), 1.0 / float(box_length),
                float(rc_square), float(dt), 0.5 * dt, 0.5 * dt * dt, n_steps,
                int(obs_last), int(extended), plan["slices"],
                _PLANE_SLOTS if plan["slots"] else int(plan["resident"]),
                scratch.data_ptr(), scratch.data_ptr() + 4 * 2 * stride * n_b, stride,
                scratch.data_ptr() + 4 * (2 * stride + 1) * n_b,
                None if skip_counts is None else skip_counts.data_ptr(), cells,
                cells / float(box_length), plan["blocks"], _cuda.stream_handle(r))
        _cuda.LAUNCHES.bump(name + "_replicas" if replicas else name)
        _cuda.check(code, name)
    last = n_steps % 2
    out = ((rbuf[last], lobuf[last], v_out, vc_out, a_out) if extended
           else (rbuf[last], v_out, a_out))
    return out + (obs,) if obs_last else out


def fused_dense_chunk_list(r, v, a, tiles, tcounts, n, box_length, rc_square, dt,
                           n_steps, tile_i=128, tile_j=512, r_lo=None, vc=None,
                           obs_last=False, skip_counts=None):
    """Advance ``n_steps`` (<= MAX_CHUNK_STEPS) Verlet steps over the visit
    lists, of (8, n_pad) rows or of each replica of (R, 8, n_pad) stacks over
    its own lists. Returns (r, v, a) or, with ``r_lo``/``vc``, (r, r_lo, v,
    vc, a), plus the obs rows when ``obs_last``. One kernel launch on CUDA
    tensors; the counts are read on the device. ``skip_counts`` (the card
    only; the twin has no warps and leaves it as it is) gets the kernel's
    runs tested and skipped added."""
    if r.device.type == "cpu":
        return fused_dense_chunk_list_plain(r, v, a, tiles, tcounts, n, box_length,
                                            rc_square, dt, n_steps, tile_i, tile_j,
                                            r_lo, vc, obs_last)
    if r.device.type != "cuda":
        raise ValueError(f"fused_dense_chunk_list: unsupported device {r.device}")
    return _launch(r, v, a, tiles, tcounts, n, box_length, rc_square, dt, n_steps,
                   tile_i, tile_j, r_lo, vc, obs_last, skip_counts=skip_counts)
