"""Fused multi-step chunks of the cell-pair engine (counterpart of
``ljmd_tpu/ops/pallas_pencil_fused.py``: ``fused_pencil_chunk`` and
``fused_pencil_width_chunk``, with ``build_width_lists``).

Both advance ``n_steps`` (<= ``MAX_PENCIL_CHUNK_STEPS``) velocity-Verlet
steps of the slot layout (``ops/pencil_sweep.py``) over the half-shell pair
set, without observables:

- invalid slots carry sentinels with v = a = 0; every step the forces are
  multiplied by 24 and by the validity row (r row 3), so sentinels never move;
- no wrap inside the chunk (the caller rebins between chunks);
- extended mode (``r_lo`` / ``vc`` given): two-float positions and
  Neumaier-compensated velocities, each pair displacement corrected by
  lo_i - lo_j (the image shift applies to the hi part only).

``fused_pencil_chunk`` sweeps every pencil at its full capacity from the
half-shell tables: each 128-slot block meets, from its own side, the stages
of its pencil, of its 4 upper neighbours and of the 4 pencils whose upper
neighbour it is (``half_shell_lower``, the inverse table, which the wrapper
builds once per table and keeps). A stage whose first slot is invalid holds
no partner (valid slots are packed rank-first) and is skipped, as is a
block whose first slot is invalid; ``static_stream`` writes that stream in
``width_index``'s entry form, and the static twin runs through it.
``fused_pencil_width_chunk`` runs every visit at the
pencil's 128-granular active width, driven by the five visit lists of
``build_width_lists`` (built from the current bin's counts, valid until the
next rebin). Returns (r, v, a) or, extended, (r, r_lo, v, vc, a).

The width chunk reads the lists through a per-block visit index,
``width_index``: for each 128-slot block the visits that touch it, with
their role (``ROLES``), partner blocks and image shift, as CSR offsets and
packed entries, and the blocks ordered by their partner count. The wrapper
derives it on the device from the lists, once per list build (it keeps the
last few lists it indexed), with torch ops and no host read.

On CUDA tensors each chunk is ONE cooperative launch (the static chunk:
``csrc/fused_pencil_chunk.cu``, tables, the inverse table and the validity
row read on the device, 8 threads a slot, the grid from ``static_plan``;
the width chunk: ``csrc/fused_pencil_width_chunk.cu``, the index read on the
device); on CPU tensors the plain twins run a Python step loop, block by
block over the static stream or the width index. The TPU kernel's
``mxu_reduce`` is an MXU layout experiment and is not ported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.fused import comp_add
from ljmd_tpu_torch.ops.pair_terms import lj_pair_terms_plain
from ljmd_tpu_torch.ops.pencil_sweep import TILE_I, _lower_of, half_shell_lower

__all__ = [
    "MAX_PENCIL_CHUNK_STEPS",
    "build_width_lists",
    "fused_pencil_chunk",
    "fused_pencil_chunk_plain",
    "fused_pencil_width_chunk",
    "fused_pencil_width_chunk_plain",
    "half_shell_lower",
    "ROLES",
    "static_plan",
    "static_stream",
    "width_index",
    "width_grid",
    "width_index_entries",
    "width_visits",
]

MAX_PENCIL_CHUNK_STEPS = 128

# Roles of a width-index entry (csrc/fused_pencil_width_chunk.cu): the block
# `start` of a self visit below the indexed block (every partner counts);
# the indexed block and those above it in its own self visit (every partner
# but the slot itself); a neighbour visit from the block (partners shifted);
# a neighbour visit whose j range holds the block (the block's slots
# shifted).
ROLES = ("self_below", "self_diag", "forward", "backward")
_SELF_BELOW, _SELF_DIAG, _FORWARD, _BACKWARD = range(4)
# Entry word: (start << 12) | (blocks << 6) | (role << 4) | (shx+1) << 2 | (shy+1).
_START_BITS, _BLOCK_BITS = 19, 6
# Chunks of 128 x 128 pairs the width twin evaluates at once.
_INDEX_BATCH = 256


def build_width_lists(counts, tbl, shf, n_pencils: int, capacity: int):
    """Visit lists of ``fused_pencil_width_chunk`` from the per-pencil
    counts (valid slots packed rank-first), element for element the JAX
    package's. Torch ops on the counts' device, no host read. Slot
    addresses are 128-slot block indices. Returns (wl_self (n_sub*P,),
    wl_self_cnt (n_sub,), wl_nbr_i (P*n_sub*4,), wl_nbr_j (P*n_sub*4,),
    wl_nbr_off (n_sub+1,)), all int32:

    - self visits of class u (width u blocks, triangular) are the i-start
      blocks in ``wl_self[(u-1)*P : (u-1)*P + wl_self_cnt[u-1]]``, one per
      pencil with w_p >= u, at block p*n_sub + w_p - u;
    - neighbour visits (p, si < w_p, k) with a non-empty neighbour, classed
      by the neighbour's width w in ``[wl_nbr_off[w-1], wl_nbr_off[w])``:
      ``wl_nbr_i`` the i block, ``wl_nbr_j`` the packed word
      (j_block << 4) | (shx+1) << 2 | (shy+1).
    """
    dev = counts.device
    i32 = torch.int32
    P = n_pencils
    n_sub = capacity // TILE_I
    w = torch.clamp((counts + (TILE_I - 1)) // TILE_I, 0, n_sub).to(i32)
    tbl = tbl.to(dev).long()
    shf = shf.to(dev).to(i32)

    def scatter(size, tgt, vals):
        out = torch.zeros((size + 1,), dtype=i32, device=dev)  # slot `size` drops
        out[tgt] = vals.to(i32)
        return out[:size]

    base_blk = torch.arange(P, dtype=i32, device=dev) * n_sub
    tgts, vals, cnts = [], [], []
    for u in range(1, n_sub + 1):
        m = w >= u
        pos = torch.cumsum(m.to(i32), 0) - 1
        tgts.append(torch.where(m, (u - 1) * P + pos, n_sub * P))
        vals.append(base_blk + (w - u))
        cnts.append(m.to(i32).sum())
    wl_self = scatter(n_sub * P, torch.cat(tgts).long(), torch.cat(vals))
    wl_self_cnt = torch.stack(cnts).to(i32)

    M = P * n_sub * 4
    e = torch.arange(M, dtype=torch.long, device=dev)
    k_e = e % 4
    si_e = (e // 4) % n_sub
    p_e = e // (4 * n_sub)
    pk = p_e * 4 + k_e
    j_e = tbl[pk]
    wj = w[j_e]
    active = (si_e < w[p_e]) & (wj >= 1)
    cls = torch.where(active, wj, 0)
    cnt_w = torch.stack([(cls == ww).to(i32).sum() for ww in range(1, n_sub + 1)])
    off = torch.cat([torch.zeros((1,), dtype=i32, device=dev), torch.cumsum(cnt_w, 0).to(i32)])
    ista_e = (p_e * n_sub + si_e).to(i32)
    packed = (((j_e * n_sub) << 4) | ((shf[2 * pk].long() + 1) << 2)
              | (shf[2 * pk + 1].long() + 1)).to(i32)
    tgt = torch.full((M,), M, dtype=torch.long, device=dev)
    for ww in range(1, n_sub + 1):
        mw = cls == ww
        pos = torch.cumsum(mw.long(), 0) - 1
        tgt = torch.where(mw, off[ww - 1].long() + pos, tgt)
    return wl_self, wl_self_cnt, scatter(M, tgt, ista_e), scatter(M, tgt, packed), off


def width_visits(wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off, n_pencils: int,
                 capacity: int):
    """The visits of width lists as host arrays, in ``table_visits``'s
    class form (reads the lists on the host): the reference the tests hold
    ``width_index`` against."""
    P = n_pencils
    n_sub = capacity // TILE_I
    ws, wc = wl_self.cpu().numpy(), wl_self_cnt.cpu().numpy()
    wi, wj, wo = wl_nbr_i.cpu().numpy(), wl_nbr_j.cpu().numpy(), wl_nbr_off.cpu().numpy()
    classes = []
    for u in range(1, n_sub + 1):
        ista = ws[(u - 1) * P:(u - 1) * P + wc[u - 1]].astype(np.int64) * TILE_I
        zero = np.zeros_like(ista)
        classes.append((ista, ista, zero, zero, u * TILE_I, True))
    for ww in range(1, n_sub + 1):
        pk = wj[wo[ww - 1]:wo[ww]].astype(np.int64)
        ista = wi[wo[ww - 1]:wo[ww]].astype(np.int64) * TILE_I
        classes.append((ista, (pk >> 4) * TILE_I, ((pk >> 2) & 3) - 1, (pk & 3) - 1,
                        ww * TILE_I, False))
    return classes


@functools.lru_cache(maxsize=8)
def _index_static(n_pencils: int, n_sub: int, device: torch.device) -> dict:
    """The record layout of ``width_index`` that depends only on the grid:
    self records (class u, slot t of the class, block d of the visit) and
    neighbour records (list entry e, backward block d), int32."""
    i32, P = torch.int32, n_pencils
    u = torch.arange(1, n_sub + 1, dtype=i32, device=device)[:, None, None]
    t = torch.arange(P, dtype=i32, device=device)[None, :, None]
    d = torch.arange(n_sub, dtype=i32, device=device)[None, None, :]
    diag = d == 0
    shape = (n_sub, P, n_sub)
    blocks = torch.where(diag, u, 1).expand(shape)
    return {
        # t where the record exists (d < u), else past any class count
        "t": torch.where(d < u, t, P + 1).expand(shape).contiguous(),
        "d": d.expand(shape).contiguous(),
        "self_bits": ((blocks << 6) | (diag.to(i32) << 4) | 5).contiguous(),  # no shift
        "self_blocks": blocks.reshape(-1).contiguous(),
        "e": torch.arange(P * n_sub * 4, dtype=i32, device=device),
        "dd": torch.arange(n_sub, dtype=i32, device=device)[None, :],
        "blocks": torch.arange(P * n_sub + 1, dtype=i32, device=device),
    }


def width_index(wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off, n_pencils: int,
                capacity: int):
    """The per-block visit index of the width lists, on the lists' device
    with a few dozen torch ops (a stable sort of the visits' records by
    block; no host read). Returns int32 (offsets (NB+1,), entries (R,),
    order (NB,)) over the NB = n_pencils * n_sub 128-slot blocks: block b's
    entries are entries[offsets[b]:offsets[b+1]], one per visit that touches
    b (the entry words above; ``width_index_entries`` decodes them), in a
    fixed order (self visits, then forward, then backward, each in list
    order); ``order`` lists the blocks by their partner blocks, most first
    (ties by index)."""
    P = n_pencils
    n_sub = capacity // TILE_I
    NB = P * n_sub
    if NB >= 1 << _START_BITS or n_sub >= 1 << _BLOCK_BITS:
        raise ValueError(f"width_index: {P} pencils x {n_sub} blocks exceed the entry word")
    st = _index_static(P, n_sub, wl_self.device)
    # Self visits of class u (i block ib, j blocks [ib, ib + u)): touch block
    # ib + d, d < u; the diagonal one (d = 0) pairs with all u blocks.
    ib = wl_self.view(n_sub, P, 1)
    s_tgt = torch.where(st["t"] < wl_self_cnt.view(n_sub, 1, 1), ib + st["d"], NB)
    s_word = (ib << 12) | st["self_bits"]
    # Neighbour visits of class w (i block nib, j blocks [jb, jb + w)):
    # forward at nib, backward at each jb + d.
    e, dd = st["e"], st["dd"]
    live = e < wl_nbr_off[n_sub]
    w = 1 + (e[:, None] >= wl_nbr_off[None, 1:n_sub]).sum(dim=1, dtype=torch.int32)
    jb, sh = wl_nbr_j >> 4, wl_nbr_j & 15
    f_tgt = torch.where(live, wl_nbr_i, NB)
    f_word = (jb << 12) | (w << 6) | (sh | (_FORWARD << 4))
    b_tgt = torch.where(live[:, None] & (dd < w[:, None]), jb[:, None] + dd, NB)
    b_word = ((wl_nbr_i << 12) | (sh | (1 << 6 | _BACKWARD << 4)))[:, None].expand_as(b_tgt)
    tgt = torch.cat([s_tgt.reshape(-1), f_tgt, b_tgt.reshape(-1)])
    sorted_tgt, perm = torch.sort(tgt, stable=True)
    entries = torch.cat([s_word.reshape(-1), f_word, b_word.reshape(-1)])[perm]
    offsets = torch.searchsorted(sorted_tgt, st["blocks"], out_int32=True)
    blocks = torch.cat([st["self_blocks"], w, torch.ones_like(b_tgt).reshape(-1)])
    cost = torch.zeros((NB + 1,), dtype=torch.int32, device=tgt.device).index_add_(
        0, tgt, blocks)[:NB]
    order = torch.sort(cost, descending=True, stable=True).indices.to(torch.int32)
    return offsets, entries, order


def width_index_entries(index):
    """The entries of a ``width_index`` on the host: a list over the blocks
    of [(role, start block, blocks, shx, shy), ...] in index order."""
    offsets, entries, _ = (t.cpu().long() for t in index)
    out = []
    for b in range(offsets.numel() - 1):
        ws = entries[int(offsets[b]):int(offsets[b + 1])].tolist()
        out.append([(ROLES[(x >> 4) & 3], x >> 12, (x >> 6) & 63, ((x >> 2) & 3) - 1,
                     (x & 3) - 1) for x in ws])
    return out


def _index_forces(pos, lo, index, box_length, rc_square):
    """Forces (rows 0..2, no 24, not multiplied by validity) on every slot
    from the width index, block by block from each block's own side: its
    entries' partner blocks, the self roles without the slot itself, the
    forward role with the partners' x / y shifted, the backward role with
    the block's own. The pair values are the kernel's; the sums run in
    another order."""
    dev, dt = pos.device, pos.dtype
    offsets, entries, _ = (t.to(dev).long() for t in index)
    n_ent = int(offsets[-1])
    blk = torch.repeat_interleave(torch.arange(offsets.numel() - 1, device=dev),
                                  offsets[1:] - offsets[:-1])
    w = entries[:n_ent]
    nblk = (w >> 6) & 63
    # One chunk per partner block of each entry.
    c_ent = torch.repeat_interleave(torch.arange(n_ent, device=dev), nblk)
    first = torch.cumsum(nblk, 0) - nblk
    c_q = (w >> 12)[c_ent] + torch.arange(c_ent.numel(), device=dev) - first[c_ent]
    c_blk, c_w = blk[c_ent], w[c_ent]
    L, inv_l = box_length, 1.0 / box_length
    ar = torch.arange(TILE_I, device=dev)
    f = torch.zeros((3, pos.shape[1]), dtype=dt, device=dev)
    for b0 in range(0, c_q.numel(), _INDEX_BATCH):
        sl = slice(b0, b0 + _INDEX_BATCH)
        role, cw = (c_w[sl] >> 4) & 3, c_w[sl]
        ii = c_blk[sl][:, None] * TILE_I + ar
        jj = c_q[sl][:, None] * TILE_I + ar
        offx = ((((cw >> 2) & 3) - 1).to(dt) * L)[:, None]
        offy = (((cw & 3) - 1).to(dt) * L)[:, None]
        fwd, bwd = (role == _FORWARD)[:, None], (role == _BACKWARD)[:, None]
        xi = torch.where(bwd, pos[0][ii] + offx, pos[0][ii])
        yi = torch.where(bwd, pos[1][ii] + offy, pos[1][ii])
        xj = torch.where(fwd, pos[0][jj] + offx, pos[0][jj])
        yj = torch.where(fwd, pos[1][jj] + offy, pos[1][jj])
        dx = xi[:, :, None] - xj[:, None, :]
        dy = yi[:, :, None] - yj[:, None, :]
        dz = pos[2][ii][:, :, None] - pos[2][jj][:, None, :]
        if lo is not None:
            dx = dx + (lo[0][ii][:, :, None] - lo[0][jj][:, None, :])
            dy = dy + (lo[1][ii][:, :, None] - lo[1][jj][:, None, :])
            dz = dz + (lo[2][ii][:, :, None] - lo[2][jj][:, None, :])
        dz = dz - L * torch.round(dz * inv_l)
        r2 = dx * dx + dy * dy + dz * dz
        mask = (r2 < rc_square) & ((role >= _FORWARD)[:, None, None]
                                   | (ii[:, :, None] != jj[:, None, :]))
        coef = lj_pair_terms_plain(r2, mask, False)[0]
        for row, dr in enumerate((dx, dy, dz)):
            f[row].index_add_(0, ii.reshape(-1), (coef * dr).sum(dim=2).reshape(-1))
    return f


def _chunk_plain(forces, r, v, a, dt, n_steps, r_lo, vc):
    """Step loop of the twins over a force function of (r, r_lo) (JAX kernel
    order: drift + half-kick on whole matrices, forces, a = 24 f * valid,
    kick)."""
    _check_steps(n_steps)
    extended = r_lo is not None
    half_dt = 0.5 * dt
    half_dt_sq = 0.5 * dt * dt
    for _ in range(n_steps):
        if extended:
            r, r_lo = comp_add(r, r_lo, (v + vc) * dt + a * half_dt_sq)
            v, vc = comp_add(v, vc, a * half_dt)
        else:
            r = r + v * dt + a * half_dt_sq
            v = v + a * half_dt
        a = torch.zeros_like(r)
        a[0:3] = (24.0 * forces(r, r_lo)) * r[3:4]
        if extended:
            v, vc = comp_add(v, vc, a * half_dt)
        else:
            v = v + a * half_dt
    return (r, r_lo, v, vc, a) if extended else (r, v, a)


def static_stream(valid, tbl, shf, lower, n_pencils: int, capacity: int):
    """The static chunk's partner stream, block by block, in
    ``width_index``'s form (offsets (NB+1,), entries, order (NB,), int32,
    NB = n_pencils * capacity / 128): each block whose first slot is valid
    has 9 entries, its own pencil (every partner but the slot itself), its
    4 upper neighbours (forward: partners shifted) and the 4 pencils of
    ``lower`` (backward: its slots shifted), each over that pencil's live
    stages (the leading 128-slot stages whose first slot is valid, from the
    validity row ``valid``); a block whose first slot is invalid has 9 empty
    entries. The rule of ``csrc/fused_pencil_chunk.cu``, as torch ops."""
    dev = valid.device
    P, n_sub = n_pencils, capacity // TILE_I
    first = valid.reshape(P, n_sub, TILE_I)[:, :, 0] > 0.5
    live = torch.cumprod(first.long(), dim=1).sum(dim=1)
    q = torch.arange(P, device=dev)
    k = torch.arange(4, device=dev)
    up, low = tbl.to(dev).long().reshape(P, 4), lower.to(dev).long().reshape(P, 4)
    shf = shf.to(dev).long().reshape(P, 4, 2)
    lp = low.clamp(min=0)
    pencil = torch.cat([q[:, None], up, lp], dim=1)                           # (P, 9)
    blocks = torch.where(torch.cat([q[:, None] >= 0, up >= 0, low >= 0], dim=1),
                         live[pencil], 0)
    role = torch.tensor([_SELF_DIAG] + [_FORWARD] * 4 + [_BACKWARD] * 4, device=dev)
    shx = torch.cat([torch.zeros_like(q)[:, None], shf[:, :, 0], shf[lp, k, 0]], dim=1)
    shy = torch.cat([torch.zeros_like(q)[:, None], shf[:, :, 1], shf[lp, k, 1]], dim=1)
    word = ((pencil * n_sub) << 12) | (blocks << 6) | (role << 4) | ((shx + 1) << 2) | (shy + 1)
    entries = torch.where(first[:, :, None], word[:, None, :], 0).reshape(-1).to(torch.int32)
    NB = P * n_sub
    return (torch.arange(NB + 1, dtype=torch.int32, device=dev) * 9, entries,
            torch.arange(NB, dtype=torch.int32, device=dev))


def fused_pencil_chunk_plain(r, v, a, tbl, shf, n_pencils, capacity, box_length,
                             rc_square, dt, n_steps, r_lo=None, vc=None):
    """Plain twin of ``fused_pencil_chunk``: every block from its own side
    over the live stages of its ``static_stream``."""
    stream = static_stream(r[3], tbl, shf, half_shell_lower(tbl.to(r.device), n_pencils),
                           n_pencils, capacity)
    return _chunk_plain(lambda pos, lo: _index_forces(pos, lo, stream, box_length, rc_square),
                        r, v, a, dt, n_steps, r_lo, vc)


def fused_pencil_width_chunk_plain(r, v, a, wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j,
                                   wl_nbr_off, n_pencils, capacity, box_length, rc_square,
                                   dt, n_steps, r_lo=None, vc=None):
    """Plain twin of ``fused_pencil_width_chunk``: the visits of the lists,
    block by block through their ``width_index``."""
    index = width_index(wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off, n_pencils,
                        capacity)
    return _chunk_plain(lambda pos, lo: _index_forces(pos, lo, index, box_length, rc_square),
                        r, v, a, dt, n_steps, r_lo, vc)


def _check_steps(n_steps: int) -> None:
    if not 0 <= n_steps <= MAX_PENCIL_CHUNK_STEPS:
        raise ValueError(f"n_steps={n_steps} outside [0, MAX_PENCIL_CHUNK_STEPS="
                         f"{MAX_PENCIL_CHUNK_STEPS}]")


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, element_size: int, extended: bool) -> int:
    """Blocks of the width chunk kernel that fit on the card at once
    (cached: the answer depends only on the card and the variant)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check(_cuda.library().ljmd_width_max_blocks(element_size, int(extended),
                                                          ctypes.byref(out)),
                    "fused_pencil_width_chunk occupancy query")
    if out.value < 1:
        raise RuntimeError("no block of the chunk kernel fits on this card; the grid barrier "
                           "cannot run")
    return out.value


@functools.lru_cache(maxsize=None)
def _static_occupancy(device_index: int, element_size: int, extended: bool) -> tuple:
    """(resident blocks an SM, SMs, registers a thread, spill bytes a
    thread) of the static chunk kernel (cached)."""
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        _cuda.check(_cuda.library().ljmd_pencil_chunk_occupancy(
            element_size, int(extended), out), "fused_pencil_chunk occupancy query")
    return tuple(out)


def static_plan(r, extended=False) -> dict:
    """The static chunk kernel's launch shape for slot rows ``r`` (on the
    card): S threads a slot (8, fixed in the kernel), threads a block (128 x
    S), work items (128-slot blocks), resident blocks an SM (occupancy
    API), the persistent grid, warps an SM, registers and spill bytes a
    thread."""
    _cuda.require_cuda_rows("static_plan", r)
    items = r.shape[1] // TILE_I
    per_sm, sms, regs, spill = _static_occupancy(r.device.index, r.element_size(),
                                                 bool(extended))
    if per_sm < 1:
        raise RuntimeError("no block of the chunk kernel fits on this card; the grid barrier "
                           "cannot run")
    s = _cuda.library().ljmd_pencil_chunk_slices()
    return {"slices": s, "threads": TILE_I * s, "items": items, "blocks_per_sm": per_sm,
            "sms": sms, "blocks": min(items, per_sm * sms),
            "warps_per_sm": per_sm * TILE_I * s // 32, "regs": regs, "spill_bytes": spill}


def width_grid(r, extended=False) -> dict:
    """The width chunk kernel's launch shape for slot rows ``r`` (on the
    card): threads a block (128 slots x 4), work items (128-slot blocks),
    blocks the card holds at once, and the persistent grid."""
    _cuda.require_cuda_rows("width_grid", r)
    items = r.shape[1] // TILE_I
    resident = _max_blocks(r.device.index, r.element_size(), bool(extended))
    return {"threads": _cuda.library().ljmd_width_block_threads(),
            "items": items, "resident_blocks": resident, "blocks": min(items, resident)}


# The last lists the width chunk indexed and their indexes: a rebin builds
# new lists, so each index is derived once per list build; a few are kept, so
# that R one-system engines taking turns (a replica loop) do not rebuild them.
_INDEX_CACHE: list = []
_INDEX_CACHE_SIZE = 16


def _index_of(lists, n_pencils, capacity):
    key = (n_pencils, capacity, tuple(t._version for t in lists))
    for hit in _INDEX_CACHE:
        if hit[1] == key and all(a is b for a, b in zip(hit[0], lists)):
            return hit[2]
    index = width_index(*lists, n_pencils, capacity)
    _INDEX_CACHE.insert(0, (lists, key, index))
    del _INDEX_CACHE[_INDEX_CACHE_SIZE:]
    return index


def _prepare(name, r, v, a, int_tables, n_pencils, capacity, n_steps, r_lo, vc):
    """Checks, the two position planes (step s reads plane s & 1 and writes
    the other; rows 3..7, validity and ids, are the same in both) and the
    outputs of one chunk launch."""
    extended = r_lo is not None
    _cuda.require_cuda_rows(name, *((r, r_lo, v, vc, a) if extended else (r, v, a)))
    _check_steps(n_steps)
    ns = r.shape[1]
    if ns != n_pencils * capacity or capacity % TILE_I:
        raise ValueError(f"{name}: {ns} slots != n_pencils * capacity "
                         f"({n_pencils} * {capacity}, a multiple of {TILE_I})")
    for t in int_tables:
        if t.device != r.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: tables and lists must be contiguous int32 on {r.device}")
    rbuf = torch.stack([r, r])
    lobuf = torch.stack([r_lo, r_lo]) if extended else None
    return rbuf, lobuf, v.clone(), vc.clone() if extended else None, a.clone()


def _outputs(rbuf, lobuf, v_out, vc_out, a_out, n_steps):
    last = n_steps % 2
    if lobuf is not None:
        return rbuf[last], lobuf[last], v_out, vc_out, a_out
    return rbuf[last], v_out, a_out


def _launch_static(r, v, a, tbl, shf, n_pencils, capacity, box_length, rc_square, dt, n_steps,
                   r_lo, vc, grid_cap=None, name="fused_pencil_chunk"):
    """One launch of the static chunk kernel, counted as ``name``.
    ``grid_cap`` caps the persistent grid (each block then takes more work
    items): tests and the smoke script only."""
    rbuf, lobuf, v_out, vc_out, a_out = _prepare(name, r, v, a, (tbl, shf), n_pencils,
                                                 capacity, n_steps, r_lo, vc)
    extended = lobuf is not None
    if tbl.shape != (4 * n_pencils,) or shf.shape != (8 * n_pencils,):
        raise ValueError(f"{name}: tables must be ({4 * n_pencils},) and ({8 * n_pencils},)")
    if n_steps > 0:
        lib = _cuda.library()
        if capacity // TILE_I > lib.ljmd_pencil_chunk_max_sub():
            raise ValueError(f"{name}: capacity {capacity} above "
                             f"{TILE_I * lib.ljmd_pencil_chunk_max_sub()}")
        lower = _lower_of(tbl, n_pencils)
        plan = static_plan(r, extended)
        blocks = plan["blocks"]
        if grid_cap is not None:
            blocks = max(1, min(blocks, int(grid_cap)))
        with torch.cuda.device(r.device):
            code = getattr(lib, f"ljmd_fused_pencil_chunk_{_cuda.dtype_suffix(r.dtype)}")(
                rbuf.data_ptr(), lobuf.data_ptr() if extended else None,
                v_out.data_ptr(), vc_out.data_ptr() if extended else None, a_out.data_ptr(),
                tbl.data_ptr(), shf.data_ptr(), lower.data_ptr(), n_pencils, capacity,
                float(box_length), 1.0 / float(box_length), float(rc_square), float(dt),
                0.5 * dt, 0.5 * dt * dt, n_steps, int(extended), blocks, _cuda.stream_handle(r))
        _cuda.LAUNCHES.bump(name)
        _cuda.check(code, name)
    return _outputs(rbuf, lobuf, v_out, vc_out, a_out, n_steps)


def _launch_width(r, v, a, lists, n_pencils, capacity, box_length, rc_square, dt, n_steps,
                  r_lo, vc, grid_cap=None, name="fused_pencil_width_chunk"):
    """One launch of the width chunk kernel, counted as ``name``.
    ``grid_cap`` (tests and the smoke script only) caps the persistent
    grid, so that each block takes several work items."""
    rbuf, lobuf, v_out, vc_out, a_out = _prepare(name, r, v, a, lists, n_pencils, capacity,
                                                 n_steps, r_lo, vc)
    extended = lobuf is not None
    if n_steps > 0:
        off, ent, order = _index_of(lists, n_pencils, capacity)
        blocks = width_grid(r, extended)["blocks"]
        if grid_cap is not None:
            blocks = max(1, min(blocks, int(grid_cap)))
        lib = _cuda.library()
        with torch.cuda.device(r.device):
            code = getattr(lib, f"ljmd_fused_pencil_width_chunk_{_cuda.dtype_suffix(r.dtype)}")(
                rbuf.data_ptr(), lobuf.data_ptr() if extended else None,
                v_out.data_ptr(), vc_out.data_ptr() if extended else None, a_out.data_ptr(),
                off.data_ptr(), ent.data_ptr(), order.data_ptr(), n_pencils, capacity,
                float(box_length), 1.0 / float(box_length), float(rc_square), float(dt),
                0.5 * dt, 0.5 * dt * dt, n_steps, int(extended), blocks,
                _cuda.stream_handle(r))
        _cuda.LAUNCHES.bump(name)
        _cuda.check(code, name)
    return _outputs(rbuf, lobuf, v_out, vc_out, a_out, n_steps)


def _stacked(name, n_pencils, replicas):
    """(pencils of the slot matrix, the launch's counter name) for one grid
    or, ``replicas=R``, a stack of R grids side by side."""
    if replicas is None:
        return n_pencils, name
    if replicas < 1:
        raise ValueError(f"{name}: replicas must be >= 1")
    return n_pencils * replicas, name + "_replicas"


def fused_pencil_chunk(r, v, a, tbl, shf, n_pencils, capacity, box_length, rc_square, dt,
                       n_steps, r_lo=None, vc=None, replicas=None):
    """Advance ``n_steps`` Verlet steps of the slot layout over the
    half-shell tables, every pencil at full capacity (module docstring).
    One launch on CUDA tensors; the plain twin on CPU tensors.
    ``replicas=R``: the rows are R grids of ``n_pencils`` pencils side by
    side, with ``replica_tables``' tables (``ops/pencil_sweep.py``): one
    launch for all R (counted as ``fused_pencil_chunk_replicas``)."""
    n_pencils, name = _stacked("fused_pencil_chunk", n_pencils, replicas)
    if r.device.type == "cpu":
        return fused_pencil_chunk_plain(r, v, a, tbl, shf, n_pencils, capacity, box_length,
                                        rc_square, dt, n_steps, r_lo, vc)
    if r.device.type != "cuda":
        raise ValueError(f"fused_pencil_chunk: unsupported device {r.device}")
    return _launch_static(r, v, a, tbl, shf, n_pencils, capacity, box_length, rc_square, dt,
                          n_steps, r_lo, vc, name=name)


def fused_pencil_width_chunk(r, v, a, wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off,
                             n_pencils, capacity, box_length, rc_square, dt, n_steps,
                             r_lo=None, vc=None, replicas=None):
    """``fused_pencil_chunk`` with every visit at its pencils' active width,
    driven by the ``build_width_lists`` lists through their ``width_index``
    (derived on the device once per list build: no host read). One launch
    on CUDA tensors; the plain twin on CPU tensors. ``replicas=R``: R grids
    of ``n_pencils`` pencils side by side, the lists built over all R *
    n_pencils pencils (``replica_tables``' tables, the stack's counts): one
    launch for all R (counted as ``fused_pencil_width_chunk_replicas``)."""
    n_pencils, name = _stacked("fused_pencil_width_chunk", n_pencils, replicas)
    lists = (wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off)
    if r.device.type == "cpu":
        return fused_pencil_width_chunk_plain(r, v, a, *lists, n_pencils, capacity, box_length,
                                              rc_square, dt, n_steps, r_lo, vc)
    if r.device.type != "cuda":
        raise ValueError(f"fused_pencil_width_chunk: unsupported device {r.device}")
    return _launch_width(r, v, a, lists, n_pencils, capacity, box_length, rc_square, dt,
                         n_steps, r_lo, vc, name=name)
