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
half-shell tables. ``fused_pencil_width_chunk`` runs every visit at the
pencil's 128-granular active width, driven by the five visit lists of
``build_width_lists`` (built from the current bin's counts, valid until the
next rebin). Returns (r, v, a) or, extended, (r, r_lo, v, vc, a).

On CUDA tensors each chunk is ONE cooperative launch of
``csrc/fused_pencil_chunk.cu`` (tables or lists read on the device); on CPU
tensors the plain twins run a Python step loop over ``accumulate_visits``.
The TPU kernel's ``mxu_reduce`` is an MXU layout experiment and is not
ported.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.fused import comp_add
from ljmd_tpu_torch.ops.pencil_sweep import TILE_I, accumulate_visits, table_visits

__all__ = [
    "MAX_PENCIL_CHUNK_STEPS",
    "build_width_lists",
    "fused_pencil_chunk",
    "fused_pencil_chunk_plain",
    "fused_pencil_width_chunk",
    "fused_pencil_width_chunk_plain",
    "width_visits",
]

MAX_PENCIL_CHUNK_STEPS = 128


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
    class form (reads the lists on the host: this is the twin's)."""
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


def _chunk_plain(classes, r, v, a, box_length, rc_square, dt, n_steps, r_lo, vc):
    """Step loop of the twins over fixed visit classes (JAX kernel order:
    drift + half-kick on whole matrices, sweep, a = 24 f * valid, kick)."""
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
        f = torch.zeros_like(r)
        for ista, jsta, shx, shy, width, tri in classes:
            accumulate_visits(f, r, r_lo, ista, jsta, shx, shy, width, tri, box_length,
                              rc_square, False)
        a = (24.0 * f) * r[3:4]
        if extended:
            v, vc = comp_add(v, vc, a * half_dt)
        else:
            v = v + a * half_dt
    return (r, r_lo, v, vc, a) if extended else (r, v, a)


def fused_pencil_chunk_plain(r, v, a, tbl, shf, n_pencils, capacity, box_length,
                             rc_square, dt, n_steps, r_lo=None, vc=None):
    """Plain twin of ``fused_pencil_chunk``: every pencil at full capacity."""
    classes = table_visits(n_pencils, capacity, tbl.cpu(), shf.cpu())
    return _chunk_plain(classes, r, v, a, box_length, rc_square, dt, n_steps, r_lo, vc)


def fused_pencil_width_chunk_plain(r, v, a, wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j,
                                   wl_nbr_off, n_pencils, capacity, box_length, rc_square,
                                   dt, n_steps, r_lo=None, vc=None):
    """Plain twin of ``fused_pencil_width_chunk``: the visits of the lists."""
    classes = width_visits(wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off,
                           n_pencils, capacity)
    return _chunk_plain(classes, r, v, a, box_length, rc_square, dt, n_steps, r_lo, vc)


def _check_steps(n_steps: int) -> None:
    if not 0 <= n_steps <= MAX_PENCIL_CHUNK_STEPS:
        raise ValueError(f"n_steps={n_steps} outside [0, MAX_PENCIL_CHUNK_STEPS="
                         f"{MAX_PENCIL_CHUNK_STEPS}]")


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, element_size: int, extended: bool, width: bool) -> int:
    """Blocks of the chunk kernel that fit on the card at once (cached: the
    answer depends only on the card and the variant)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check(_cuda.library().ljmd_pencil_max_blocks(element_size, int(extended),
                                                           int(width), ctypes.byref(out)),
                    "fused_pencil_chunk occupancy query")
    return out.value


def _launch(name, r, v, a, tables, lists, n_pencils, capacity, box_length, rc_square, dt,
            n_steps, r_lo, vc):
    extended = r_lo is not None
    _cuda.require_cuda_rows(name, *((r, r_lo, v, vc, a) if extended else (r, v, a)))
    _check_steps(n_steps)
    ns = r.shape[1]
    if ns != n_pencils * capacity or capacity % TILE_I:
        raise ValueError(f"{name}: {ns} slots != n_pencils * capacity "
                         f"({n_pencils} * {capacity}, a multiple of {TILE_I})")
    for t in tables + lists:
        if t.device != r.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: tables and lists must be contiguous int32 on {r.device}")
    suffix = _cuda.dtype_suffix(r.dtype)
    lib = _cuda.library()
    # Two position planes: step s reads plane s & 1 and writes the other;
    # rows 3..7 (validity, ids) are the same in both.
    rbuf = torch.stack([r, r])
    lobuf = torch.stack([r_lo, r_lo]) if extended else None
    v_out, a_out = v.clone(), a.clone()
    vc_out = vc.clone() if extended else None
    if n_steps > 0:
        width = bool(lists)
        blocks = n_pencils * capacity // lib.ljmd_pencil_tile_slots()
        max_blocks = _max_blocks(r.device.index, r.element_size(), extended, width)
        if max_blocks < 1:
            raise RuntimeError(f"{name}: no block of the kernel fits on this card; "
                               "the grid barrier cannot run")
        nul = [None] * 5
        tbl, shf = tables if tables else (None, None)
        with torch.cuda.device(r.device):
            code = getattr(lib, f"ljmd_fused_pencil_chunk_{suffix}")(
                rbuf.data_ptr(), lobuf.data_ptr() if extended else None,
                v_out.data_ptr(), vc_out.data_ptr() if extended else None, a_out.data_ptr(),
                tbl.data_ptr() if tbl is not None else None,
                shf.data_ptr() if shf is not None else None,
                *([t.data_ptr() for t in lists] if width else nul),
                int(width), n_pencils, capacity, float(box_length), 1.0 / float(box_length),
                float(rc_square), float(dt), 0.5 * dt, 0.5 * dt * dt, n_steps,
                int(extended), min(blocks, max_blocks), _cuda.stream_handle(r))
        _cuda.LAUNCHES.bump(name)
        _cuda.check(code, name)
    last = n_steps % 2
    if extended:
        return rbuf[last], lobuf[last], v_out, vc_out, a_out
    return rbuf[last], v_out, a_out


def fused_pencil_chunk(r, v, a, tbl, shf, n_pencils, capacity, box_length, rc_square, dt,
                       n_steps, r_lo=None, vc=None):
    """Advance ``n_steps`` Verlet steps of the slot layout over the
    half-shell tables, every pencil at full capacity (module docstring).
    One launch on CUDA tensors; the plain twin on CPU tensors."""
    if r.device.type == "cpu":
        return fused_pencil_chunk_plain(r, v, a, tbl, shf, n_pencils, capacity, box_length,
                                        rc_square, dt, n_steps, r_lo, vc)
    if r.device.type != "cuda":
        raise ValueError(f"fused_pencil_chunk: unsupported device {r.device}")
    return _launch("fused_pencil_chunk", r, v, a, (tbl, shf), (), n_pencils, capacity,
                   box_length, rc_square, dt, n_steps, r_lo, vc)


def fused_pencil_width_chunk(r, v, a, wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off,
                             n_pencils, capacity, box_length, rc_square, dt, n_steps,
                             r_lo=None, vc=None):
    """``fused_pencil_chunk`` with every visit at its pencils' active width,
    driven by the ``build_width_lists`` lists (read on the device: no host
    read). One launch on CUDA tensors; the plain twin on CPU tensors."""
    lists = (wl_self, wl_self_cnt, wl_nbr_i, wl_nbr_j, wl_nbr_off)
    if r.device.type == "cpu":
        return fused_pencil_width_chunk_plain(r, v, a, *lists, n_pencils, capacity, box_length,
                                              rc_square, dt, n_steps, r_lo, vc)
    if r.device.type != "cuda":
        raise ValueError(f"fused_pencil_width_chunk: unsupported device {r.device}")
    return _launch("fused_pencil_width_chunk", r, v, a, (), lists, n_pencils, capacity,
                   box_length, rc_square, dt, n_steps, r_lo, vc)
