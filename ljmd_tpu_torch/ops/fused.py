"""Fused multi-step Verlet chunks (counterpart of ``ops/pallas_fused.py``:
``fused_dense_chunk``, ``fused_dense_chunk_ext``, ``fused_dense_chunk_flags``,
``wrap_positions_ext``, ``MAX_CHUNK_STEPS``).

A chunk advances ``n_steps`` velocity-Verlet steps on (8, n_pad) row
matrices (rows 0..2 = x/y/z, rows 3..7 and columns >= n zero; ``a`` holds
24-prefactored accelerations consistent with ``r``). Positions are NOT
wrapped inside a chunk: the caller wraps once afterwards and carries the
unwrap update ``ru += r_end - r`` exactly.

On a CUDA tensor each chunk is ONE cooperative launch of
``csrc/fused_dense_chunk.cu`` over a persistent grid (as many blocks as the
card keeps resident, each taking its 32-particle tiles in turn); on a CPU
tensor the plain twins below run a Python step loop over the dense sweep with
the same updates. ``fused_dense_chunk_flags`` gates each pair on the
activity flag of the (tile_i, tile_j) tile the TPU kernel computes it in.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.pair_sweep import pair_forces_plain

__all__ = [
    "MAX_CHUNK_STEPS",
    "comp_add",
    "fused_dense_chunk",
    "fused_dense_chunk_ext",
    "fused_dense_chunk_flags",
    "fused_dense_chunk_plain",
    "fused_dense_chunk_ext_plain",
    "fused_dense_chunk_flags_plain",
    "tile_gate",
    "wrap_positions_ext",
]

# Position drift per chunk is bounded by v_max * dt * MAX_CHUNK_STEPS; at
# liquid state points (v_max ~ 4 sigma/tau, dt <= 0.005) 256 steps keep
# coordinates within ~2L of the box, preserving f32 position resolution.
MAX_CHUNK_STEPS = 256


def comp_add(x: torch.Tensor, c: torch.Tensor, delta: torch.Tensor):
    """Neumaier-compensated x += delta: returns (new_x, new_c) with c
    accumulating the rounding error, so x + c tracks the exact sum."""
    y = delta + c
    t = x + y
    big_x = torch.abs(x) >= torch.abs(y)
    c_new = torch.where(big_x, (x - t) + y, (y - t) + x)
    return t, c_new


def wrap_positions_ext(hi: torch.Tensor, lo: torch.Tensor, box_length: float):
    """Wrap two-float positions into [0, L) without losing the remainder:
    hi' = hi - k*L with the subtraction's rounding error folded into lo.
    k*L is exact for the small |k| (<= 2) that occur between wraps."""
    k = torch.floor(hi * (1.0 / box_length))
    d = k * box_length
    s = hi - d
    big = torch.abs(hi) >= torch.abs(d)
    err = torch.where(big, (hi - s) - d, (-d - s) + hi)
    return s, lo + err


def _check_steps(n_steps: int) -> None:
    if not 0 <= n_steps <= MAX_CHUNK_STEPS:
        raise ValueError(f"n_steps={n_steps} outside [0, MAX_CHUNK_STEPS={MAX_CHUNK_STEPS}]")


def fused_dense_chunk_plain(r, v, a, n, box_length, rc_square, dt, n_steps, gate=None):
    """Plain twin of ``fused_dense_chunk``: a Python loop of Verlet steps
    over the dense force sweep (over the pairs of ``gate``, if given)."""
    _check_steps(n_steps)
    half_dt = 0.5 * dt
    half_dt_sq = 0.5 * dt * dt
    for _ in range(n_steps):
        r = r + v * dt + a * half_dt_sq
        v = v + a * half_dt
        a = 24.0 * pair_forces_plain(r, n, box_length, rc_square, gate=gate)
        v = v + a * half_dt
    return r, v, a


def fused_dense_chunk_ext_plain(r, r_lo, v, vc, a, n, box_length, rc_square,
                                dt, n_steps, gate=None):
    """Plain twin of ``fused_dense_chunk_ext``: two-float positions,
    compensated velocities, displacements corrected by the remainder rows."""
    _check_steps(n_steps)
    half_dt = 0.5 * dt
    half_dt_sq = 0.5 * dt * dt
    for _ in range(n_steps):
        r, r_lo = comp_add(r, r_lo, (v + vc) * dt + a * half_dt_sq)
        v, vc = comp_add(v, vc, a * half_dt)
        a = 24.0 * pair_forces_plain(r, n, box_length, rc_square, lo=r_lo, gate=gate)
        v, vc = comp_add(v, vc, a * half_dt)
    return r, r_lo, v, vc, a


def _check_flags(name, flags, n_pad, tile_i, tile_j, device):
    """What the flag tiling must be: tile_i and tile_j multiples of 128 that
    divide n_pad, and one int32 flag per (tile_i, tile_j) tile."""
    if tile_i % 128 or tile_j % 128 or n_pad % tile_i or n_pad % tile_j:
        raise ValueError(f"{name}: tile_i={tile_i} and tile_j={tile_j} must be multiples "
                         f"of 128 that divide n_pad={n_pad}")
    want = (n_pad // tile_i) * (n_pad // tile_j)
    if flags.dim() != 1 or flags.numel() != want:
        raise ValueError(f"{name}: flags must be ({want},), one per (tile_i, tile_j) tile; "
                         f"got {tuple(flags.shape)}")
    if flags.dtype != torch.int32 or flags.device != device:
        raise ValueError(f"{name}: flags must be int32 on {device}")


def tile_gate(flags, n, n_pad, tile_i=128, tile_j=512):
    """(n, n) bool: the pairs the flags keep. The TPU kernel computes the
    pair i < j in tile (it(i), jt(j)) only, so both (i, j) and (j, i) take
    that tile's flag."""
    f = flags.reshape(n_pad // tile_i, n_pad // tile_j) > 0
    idx = torch.arange(n, device=flags.device)
    upper = f[(idx // tile_i)[:, None], (idx // tile_j)[None, :]]
    return torch.where(idx[None, :] > idx[:, None], upper, upper.T)


def fused_dense_chunk_flags_plain(r, v, a, flags, n, box_length, rc_square, dt, n_steps,
                                  tile_i=128, tile_j=512, r_lo=None, vc=None):
    """Plain twin of ``fused_dense_chunk_flags``: the dense step loop over
    the pairs of ``tile_gate``."""
    _check_flags("fused_dense_chunk_flags", flags, r.shape[1], tile_i, tile_j, r.device)
    gate = tile_gate(flags, n, r.shape[1], tile_i, tile_j)
    if r_lo is not None:
        return fused_dense_chunk_ext_plain(r, r_lo, v, vc, a, n, box_length, rc_square, dt,
                                           n_steps, gate=gate)
    return fused_dense_chunk_plain(r, v, a, n, box_length, rc_square, dt, n_steps, gate=gate)


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int, element_size: int, extended: bool, flagged: bool) -> int:
    """Blocks of the dense chunk kernel that fit on the card at once (cached:
    the answer depends only on the card and the variant)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _cuda.check(_cuda.library().ljmd_fused_max_blocks(element_size, int(extended),
                                                           int(flagged), ctypes.byref(out)),
                    "fused_dense_chunk occupancy query")
    return out.value


def _launch(name: str, extended: bool, r, r_lo, v, vc, a, n, box_length,
            rc_square, dt, n_steps, flags=None, tile_i=128, tile_j=512,
            grid_cap=None):
    """One launch of the kernel. ``grid_cap`` (tests and the smoke script
    only) caps the persistent grid below what the card holds, so that each
    block takes several tiles."""
    tensors = (r, r_lo, v, vc, a) if extended else (r, v, a)
    _cuda.require_cuda_rows(name, *tensors)
    _check_steps(n_steps)
    n_pad = r.shape[1]
    if not 0 <= n <= n_pad:
        raise ValueError(f"{name}: n={n} outside [0, n_pad={n_pad}]")
    if flags is not None:
        _check_flags(name, flags, n_pad, tile_i, tile_j, r.device)
        flags = flags.contiguous()
    suffix = _cuda.dtype_suffix(r.dtype)
    lib = _cuda.library()
    # Step s reads plane s % 2 and writes plane (s + 1) % 2.
    rbuf = torch.zeros((2, 8, n_pad), dtype=r.dtype, device=r.device)
    rbuf[0].copy_(r)
    lobuf = None
    if extended:
        lobuf = torch.zeros_like(rbuf)
        lobuf[0].copy_(r_lo)
    v_out, a_out = v.clone(), a.clone()
    vc_out = vc.clone() if extended else None
    if n_steps == 0:
        return rbuf[0], lobuf[0] if extended else None, v_out, vc_out, a_out
    blocks = min(n_pad // lib.ljmd_fused_tile_cols(),
                 _max_blocks(r.device.index, r.element_size(), extended, flags is not None))
    if grid_cap is not None:
        blocks = max(1, min(blocks, int(grid_cap)))
    with torch.cuda.device(r.device):
        code = getattr(lib, f"ljmd_fused_dense_chunk_{suffix}")(
            rbuf.data_ptr(), lobuf.data_ptr() if extended else None,
            v_out.data_ptr(), vc_out.data_ptr() if extended else None,
            a_out.data_ptr(), n, n_pad, float(box_length),
            1.0 / float(box_length), float(rc_square), float(dt),
            0.5 * dt, 0.5 * dt * dt, n_steps, int(extended),
            flags.data_ptr() if flags is not None else None, tile_i, tile_j, blocks,
            _cuda.stream_handle(r),
        )
    _cuda.LAUNCHES.bump(name)
    _cuda.check(code, name)
    last = n_steps % 2
    return rbuf[last], lobuf[last] if extended else None, v_out, vc_out, a_out


def fused_dense_chunk(r, v, a, n, box_length, rc_square, dt, n_steps):
    """Advance ``n_steps`` (<= MAX_CHUNK_STEPS) Verlet steps; returns
    (r_end unwrapped, v, a). One kernel launch on CUDA tensors."""
    if r.device.type == "cpu":
        return fused_dense_chunk_plain(r, v, a, n, box_length, rc_square, dt, n_steps)
    if r.device.type != "cuda":
        raise ValueError(f"fused_dense_chunk: unsupported device {r.device}")
    r_end, _, v, _, a = _launch("fused_dense_chunk", False, r, None, v, None, a,
                                n, box_length, rc_square, dt, n_steps)
    return r_end, v, a


def fused_dense_chunk_ext(r, r_lo, v, vc, a, n, box_length, rc_square, dt,
                          n_steps):
    """Extended-precision chunk: returns (r, r_lo, v, vc, a) after
    ``n_steps``. One kernel launch on CUDA tensors."""
    if r.device.type == "cpu":
        return fused_dense_chunk_ext_plain(r, r_lo, v, vc, a, n, box_length,
                                           rc_square, dt, n_steps)
    if r.device.type != "cuda":
        raise ValueError(f"fused_dense_chunk_ext: unsupported device {r.device}")
    return _launch("fused_dense_chunk_ext", True, r, r_lo, v, vc, a, n,
                   box_length, rc_square, dt, n_steps)


def fused_dense_chunk_flags(r, v, a, flags, n, box_length, rc_square, dt, n_steps,
                            tile_i=128, tile_j=512, r_lo=None, vc=None):
    """``fused_dense_chunk`` over the pairs of the active (tile_i, tile_j)
    tiles (``flags`` > 0; the flags must hold for the whole chunk). Returns
    (r, v, a), or with ``r_lo``/``vc`` (r, r_lo, v, vc, a). One kernel launch
    on CUDA tensors."""
    if r.device.type == "cpu":
        return fused_dense_chunk_flags_plain(r, v, a, flags, n, box_length, rc_square, dt,
                                             n_steps, tile_i, tile_j, r_lo, vc)
    if r.device.type != "cuda":
        raise ValueError(f"fused_dense_chunk_flags: unsupported device {r.device}")
    extended = r_lo is not None
    out = _launch("fused_dense_chunk_flags", extended, r, r_lo, v, vc, a, n, box_length,
                  rc_square, dt, n_steps, flags, tile_i, tile_j)
    return out if extended else (out[0], out[2], out[4])
