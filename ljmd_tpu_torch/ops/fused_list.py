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

On a CUDA tensor each chunk is ONE cooperative launch of
``csrc/fused_dense_chunk_list.cu``; on a CPU tensor the plain twin expands
the lists into dense (n_pad, n_pad) coverage and round masks and runs a
Python step loop over them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.fused import MAX_CHUNK_STEPS, comp_add
from ljmd_tpu_torch.ops.pair_terms import lj_pair_terms_plain

__all__ = ["fused_dense_chunk_list", "fused_dense_chunk_list_plain", "list_coverage"]

# The kernel's list granule: visits start and end on 128-column blocks.
LIST_TILE_I = 128


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
    the host: this is the twin's, not the card path's."""
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


def _list_sweep(pos, lo, both, mx, mz, upper, box_length, rc_square, want_obs):
    """Forces / 24 on every column from the covered pairs (pair-twice over
    ``both``), and, when ``want_obs``, the e/du/ddu partials of the pairs
    in ``upper`` summed on their row side: (8, n_pad) rows 0..2 / 3..5."""
    x = pos[0:3]
    d = x[:, :, None] - x[:, None, :]
    if lo is not None:
        xl = lo[0:3]
        d = d + (xl[:, :, None] - xl[:, None, :])
    inv_l = 1.0 / box_length

    def mic(c):
        return c - box_length * torch.round(c * inv_l)

    dx = torch.where(mx, mic(d[0]), d[0])
    dy = mic(d[1])
    dz = torch.where(mz, mic(d[2]), d[2])
    r2 = dx * dx + dy * dy + dz * dz
    in_range = r2 < rc_square
    coef = lj_pair_terms_plain(r2, both & in_range, want_observables=False)[0]
    force = torch.zeros_like(pos)
    force[0] = (coef * dx).sum(dim=-1)
    force[1] = (coef * dy).sum(dim=-1)
    force[2] = (coef * dz).sum(dim=-1)
    obs = None
    if want_obs:
        _, du, e, ddu = lj_pair_terms_plain(r2, upper & in_range, want_observables=True)
        obs = torch.zeros_like(pos)
        obs[3], obs[4], obs[5] = e.sum(dim=-1), du.sum(dim=-1), ddu.sum(dim=-1)
    return force, obs


def fused_dense_chunk_list_plain(r, v, a, tiles, tcounts, n, box_length, rc_square,
                                 dt, n_steps, tile_i=128, tile_j=512, r_lo=None,
                                 vc=None, obs_last=False):
    """Plain twin of ``fused_dense_chunk_list``: the visit lists expanded
    into dense coverage (``list_coverage``) and a Python loop of Verlet
    steps over it."""
    if not 0 <= n_steps <= MAX_CHUNK_STEPS:
        raise ValueError(f"n_steps={n_steps} outside [0, MAX_CHUNK_STEPS={MAX_CHUNK_STEPS}]")
    extended = r_lo is not None
    cover, mx, mz = list_coverage(tiles, tcounts, n, r.shape[1], tile_i, tile_j)
    both, mx, mz = cover | cover.T, mx | mx.T, mz | mz.T
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
        force, o = _list_sweep(r, r_lo, both, mx, mz, cover, box_length, rc_square, want_obs)
        a = 24.0 * force
        if extended:
            v, vc = comp_add(v, vc, a * half_dt)
        else:
            v = v + a * half_dt
        if want_obs:
            obs = o
    out = (r, r_lo, v, vc, a) if extended else (r, v, a)
    return out + (obs,) if obs_last else out


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, element_size: int, extended: bool) -> int:
    """Blocks of the list kernel that fit on the card at once (cached: the
    answer depends only on the card and the variant)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check(_cuda.library().ljmd_list_max_blocks(element_size, int(extended),
                                                          ctypes.byref(out)),
                    "fused_dense_chunk_list occupancy query")
    return out.value


def _launch(r, v, a, tiles, tcounts, n, box_length, rc_square, dt, n_steps,
            tile_i, tile_j, r_lo, vc, obs_last):
    extended = r_lo is not None
    name = "fused_dense_chunk_list"
    _cuda.require_cuda_rows(name, *((r, r_lo, v, vc, a) if extended else (r, v, a)))
    n_pad = r.shape[1]
    if not 0 <= n_steps <= MAX_CHUNK_STEPS:
        raise ValueError(f"n_steps={n_steps} outside [0, MAX_CHUNK_STEPS={MAX_CHUNK_STEPS}]")
    if not 0 <= n <= n_pad:
        raise ValueError(f"{name}: n={n} outside [0, n_pad={n_pad}]")
    n_tails = _check_lists(tiles, tcounts, n_pad, tile_i, tile_j)
    for t in (tiles, tcounts):
        if t.device != r.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: tiles / tcounts must be contiguous int32 on {r.device}")
    suffix = _cuda.dtype_suffix(r.dtype)
    lib = _cuda.library()
    rbuf = torch.zeros((2, 8, n_pad), dtype=r.dtype, device=r.device)
    rbuf[0].copy_(r)
    lobuf = None
    if extended:
        lobuf = torch.zeros_like(rbuf)
        lobuf[0].copy_(r_lo)
    v_out, a_out = v.clone(), a.clone()
    vc_out = vc.clone() if extended else None
    obs = torch.zeros_like(r) if obs_last else None
    if n_steps > 0:
        blocks = n_pad // lib.ljmd_list_tile_cols()
        max_blocks = _max_blocks(r.device.index, r.element_size(), extended)
        if blocks > max_blocks:
            raise RuntimeError(
                f"{name}: n_pad={n_pad} needs {blocks} co-resident blocks but this "
                f"card holds at most {max_blocks}; the grid barrier cannot run")
        with torch.cuda.device(r.device):
            code = getattr(lib, f"ljmd_fused_dense_chunk_list_{suffix}")(
                rbuf.data_ptr(), lobuf.data_ptr() if extended else None,
                v_out.data_ptr(), vc_out.data_ptr() if extended else None,
                a_out.data_ptr(), obs.data_ptr() if obs_last else None,
                tiles.data_ptr(), tcounts.data_ptr(), tiles.shape[1], n_tails,
                tile_j // tile_i, n, n_pad, float(box_length), 1.0 / float(box_length),
                float(rc_square), float(dt), 0.5 * dt, 0.5 * dt * dt, n_steps,
                int(obs_last), int(extended), _cuda.stream_handle(r))
        _cuda.LAUNCHES.bump(name)
        _cuda.check(code, name)
    last = n_steps % 2
    out = ((rbuf[last], lobuf[last], v_out, vc_out, a_out) if extended
           else (rbuf[last], v_out, a_out))
    return out + (obs,) if obs_last else out


def fused_dense_chunk_list(r, v, a, tiles, tcounts, n, box_length, rc_square, dt,
                           n_steps, tile_i=128, tile_j=512, r_lo=None, vc=None,
                           obs_last=False):
    """Advance ``n_steps`` (<= MAX_CHUNK_STEPS) Verlet steps over the visit
    lists. Returns (r, v, a) or, with ``r_lo``/``vc``, (r, r_lo, v, vc, a),
    plus the obs rows when ``obs_last``. One kernel launch on CUDA tensors;
    the counts are read on the device."""
    if r.device.type == "cpu":
        return fused_dense_chunk_list_plain(r, v, a, tiles, tcounts, n, box_length,
                                            rc_square, dt, n_steps, tile_i, tile_j,
                                            r_lo, vc, obs_last)
    if r.device.type != "cuda":
        raise ValueError(f"fused_dense_chunk_list: unsupported device {r.device}")
    return _launch(r, v, a, tiles, tcounts, n, box_length, rc_square, dt, n_steps,
                   tile_i, tile_j, r_lo, vc, obs_last)
