"""The cell-pair engine's rebin of its slot carry (counterpart of
``ljmd_tpu/ops/cell_list.py:307-356`` ``rebin_gather_parts`` / ``rebin_gather``
with the engine's wrap, gathers and sentinels around them,
``ljmd_tpu/models/engine.py:1253-1270, 1405-1420``).

``rebin_slots`` re-bins (8, n_slots) slot rows into their pencils:

- rows 0..2 of ``r`` wrapped into [0, L) (``wrap``; the compensated engine
  wraps its two-float positions itself and passes ``wrap=False``);
- each valid slot keyed by its pencil, stably sorted by key (ranks within a
  pencil follow the old slot order), the particles past a pencil's capacity
  dropped with the overflow flag set;
- the new ``r``: the wrapped coordinates, validity 1, the particle id, rows
  5..7 zero, and in empty slots the sentinel x of ``sentinel_fill``; each of
  ``others`` (ru, v, a, the remainders): rows 0..2 moved with their particle,
  rows 3..7 zero;
- ``counts`` (int32, a pencil) and the new sticky flag: ``overflow`` or a
  pencil past capacity or, with ``drift_ref``, a particle whose xy drift
  since ``drift_ref`` passed ``drift_thresh`` (the engine's drift check of the
  ``always`` trigger, folded in);
- the running drift max: with ``drift_ref`` and ``drift_max`` (a replica's
  each), ``torch.maximum(drift_max, the largest squared xy drift)``, the
  engine's running max of a chunk's drift; else None.

On CUDA tensors it is two launches (``csrc/pencil_rebin.cu``: a key pass and
a gather that is a stable counting sort, counted as ``rebin_keys`` and
``rebin_gather``, ``*_replicas`` for a stack) and the outputs' allocations, no
host read, at any grid size. On CPU tensors, or with ``z_order`` (the
z-banded sweep's (pencil, z) ranks), the plain twin: the torch chain
``wrap_positions`` -> ``rebin_gather_parts`` -> the two gathers ->
``sentinel_fill`` -> the counts, whose bits the kernels give.

``replicas=R``: R grids side by side ((8, R * n_slots)), each rebinned as
its own (the keys offset by q * n_pencils), ``overflow`` (R,).
"""

from __future__ import annotations

import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.cell_list import PencilGrid, rebin_gather_parts
from ljmd_tpu_torch.ops.geometry import minimum_image, wrap_positions
from ljmd_tpu_torch.ops.pencil_sweep import SENT_BASE, sentinel_fill

__all__ = ["REBIN_TILE", "drift_flag", "drift_max2", "drift_moved2", "rebin_slots",
           "rebin_slots_plain"]

# Slots a block of the key pass keys (a multiple of 128): the gather's unit
# of skipping, one histogram row a tile.
REBIN_TILE = 512
_MAX_OTHERS = 5


def drift_moved2(r: torch.Tensor, ref: torch.Tensor, box_length: float,
                 rows: slice = slice(0, 2)) -> torch.Tensor:
    """Each slot's squared minimum-image drift from ``ref`` over ``rows``
    (xy by default), times its validity: the cell-pair engine's drift
    measure."""
    d = minimum_image(r[rows] - ref[rows], box_length)
    return torch.sum(d * d, dim=0) * r[3]


def drift_max2(r: torch.Tensor, ref: torch.Tensor, box_length: float,
               replicas: int | None = None) -> torch.Tensor:
    """The largest squared minimum-image xy drift of a valid slot from
    ``ref``, one a replica (NaN where a drift is)."""
    moved2 = drift_moved2(r, ref, box_length)
    if replicas is None:
        return torch.max(moved2)
    return torch.amax(moved2.reshape(replicas, -1), dim=1)


def drift_flag(r: torch.Tensor, ref: torch.Tensor, box_length: float, thresh: float,
               replicas: int | None = None) -> torch.Tensor:
    """Whether a valid slot's minimum-image xy drift from ``ref`` passes
    ``thresh`` (squared): the cell-pair engine's check, one flag a replica."""
    return drift_max2(r, ref, box_length, replicas) > thresh


def _permute(r8, others, order, src, valid_new):
    """Two gathers (sorted order, then the structured src) of the rows that
    carry data: coordinates and ids of r, rows 0..2 of the others; validity
    comes from valid_new, rows 5..7 are zero throughout. An empty slot's
    gather may read another replica's particle: zeroed."""
    dtype, dev = r8.dtype, r8.device
    vmask = valid_new.to(dtype)
    parts = [r8[0:3], r8[4:5]] + [o[0:3] for o in others]
    stacked = torch.where(valid_new[None, :], torch.cat(parts, dim=0)[:, order][:, src], 0.0)
    pad3 = torch.zeros((3, r8.shape[1]), dtype=dtype, device=dev)
    pad5 = torch.zeros((5, r8.shape[1]), dtype=dtype, device=dev)
    r8p = torch.cat([stacked[0:3], vmask[None, :], stacked[3:4], pad3], dim=0)
    return r8p, [torch.cat([stacked[4 + 3 * i:7 + 3 * i], pad5], dim=0)
                 for i in range(len(others))]


def rebin_slots_plain(r, others, grid: PencilGrid, overflow, replicas=None, wrap=True,
                      z_order=False, drift_ref=None, drift_thresh=0.0, drift_max=None):
    """The plain twin of ``rebin_slots`` (module docstring): ``(r_new,
    others_new, counts, overflow_new, drift_max_new)``."""
    if drift_max is not None and drift_ref is None:
        raise ValueError("rebin_slots: drift_max needs drift_ref")
    if drift_ref is not None:
        moved = drift_max2(r, drift_ref, grid.box_length, replicas)
        overflow = overflow | (moved > drift_thresh)
        if drift_max is not None:
            drift_max = torch.maximum(drift_max, moved)
    if wrap:
        r = r.clone()
        r[0:3] = wrap_positions(r[0:3], grid.box_length)
    order, src, valid_new, ovf = rebin_gather_parts(r, r[3], grid, z_order=z_order,
                                                    replicas=replicas)
    r8p, permuted = _permute(r, others, order, src, valid_new)
    r8p = sentinel_fill(r8p, r8p[3], grid.capacity, None if replicas is None else grid.n_pencils)
    counts = r8p[3].reshape(-1, grid.capacity).sum(dim=1).to(torch.int32)
    return r8p, permuted, counts, overflow | ovf, drift_max


def _launch(r, others, grid: PencilGrid, overflow, replicas, wrap, drift_ref, drift_thresh,
            drift_max):
    reps = 1 if replicas is None else replicas
    ns, n_pencils = grid.n_slots, grid.n_pencils
    check = drift_ref is not None
    if drift_max is not None and (not check or drift_max.numel() != reps
                                  or drift_max.dtype != r.dtype or drift_max.device != r.device):
        raise ValueError(f"rebin_slots: drift_max must be {reps} {r.dtype} on {r.device}, "
                         "with drift_ref")
    _cuda.require_cuda_rows("rebin_slots", r, *others, *([drift_ref] if check else []))
    if r.shape[1] != reps * ns:
        raise ValueError(f"rebin_slots: {r.shape[1]} slots != {reps} x {ns}")
    if len(others) > _MAX_OTHERS:
        raise ValueError(f"rebin_slots: at most {_MAX_OTHERS} carried fields")
    if overflow.dtype != torch.bool or overflow.numel() != reps or overflow.device != r.device:
        raise ValueError(f"rebin_slots: overflow must be {reps} bool on {r.device}")
    dev = r.device
    n_tiles = -(-ns // REBIN_TILE)
    n_hist = reps * n_tiles * n_pencils
    scratch = torch.empty((reps * ns + n_hist + reps * n_tiles,), dtype=torch.int32, device=dev)
    r_out = torch.empty_like(r)
    outs = [torch.empty_like(o) for o in others]
    counts = torch.empty((reps * n_pencils,), dtype=torch.int32, device=dev)
    ovf_in = overflow.contiguous()
    ovf_out = torch.empty_like(ovf_in)
    keep = drift_max is not None
    if keep:
        dmax_in = drift_max.contiguous()
        dmax_out = torch.empty_like(dmax_in)
        tile_max = torch.empty((reps * n_tiles,), dtype=r.dtype, device=dev)
    pad = [None] * (_MAX_OTHERS - len(others))
    keys = scratch.data_ptr()
    box = float(grid.box_length)
    with torch.cuda.device(dev):
        code = getattr(_cuda.library(), f"ljmd_pencil_rebin_{_cuda.dtype_suffix(r.dtype)}")(
            r.data_ptr(), drift_ref.data_ptr() if check else None,
            *[o.data_ptr() for o in others], *pad, len(others),
            r_out.data_ptr(), *[o.data_ptr() for o in outs], *pad,
            ovf_in.data_ptr(), ovf_out.data_ptr(), keys, keys + 4 * reps * ns,
            keys + 4 * (reps * ns + n_hist), counts.data_ptr(),
            tile_max.data_ptr() if keep else None, dmax_in.data_ptr() if keep else None,
            dmax_out.data_ptr() if keep else None, ns, reps, grid.m_xy,
            grid.capacity, REBIN_TILE, int(wrap), int(check), box, 1.0 / box,
            grid.m_xy / box, float(drift_thresh), SENT_BASE, _cuda.stream_handle(r))
    suffix = "" if replicas is None else "_replicas"
    _cuda.LAUNCHES.bump("rebin_keys" + suffix)
    _cuda.LAUNCHES.bump("rebin_gather" + suffix)
    _cuda.check(code, "rebin_slots")
    return r_out, outs, counts, ovf_out, dmax_out if keep else None


def rebin_slots(r, others, grid: PencilGrid, overflow, replicas=None, wrap=True,
                z_order=False, drift_ref=None, drift_thresh=0.0, drift_max=None):
    """Rebin the slot rows ``r`` and the carried fields ``others`` (module
    docstring): ``(r_new, others_new, counts, overflow_new,
    drift_max_new)``. Two kernel launches on CUDA tensors (without
    ``z_order``); the plain twin otherwise."""
    if r.device.type == "cuda" and not z_order:
        return _launch(r, list(others), grid, overflow, replicas, wrap, drift_ref, drift_thresh,
                       drift_max)
    return rebin_slots_plain(r, others, grid, overflow, replicas, wrap, z_order, drift_ref,
                             drift_thresh, drift_max)
