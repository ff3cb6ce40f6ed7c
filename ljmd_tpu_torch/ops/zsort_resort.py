"""The zsort engine's resort of its carry (counterpart of the JAX engine's
``_sort`` and ``_lists``, ``ljmd_tpu/models/engine.py:686`` and ``:632``, with
``compute_tile_flags``, ``ljmd_tpu/ops/pallas_fused.py:269``, between them).

``zsort_resort`` re-sorts the (8, n_pad) rows of one system, or the (R, 8,
n_pad) rows of a stack of R replicas, each its own:

- each column keyed by a packed unique int32: z quantized to ``zq_bits``
  (with ``slab_sort`` the x-slab above it), padding (``ids < 0``) the top
  key, the column index in the low ``bits_pad`` bits, and sorted;
- rows 0..2 of r, ru, v and a (and of rlo, vc in the extended mode) and the
  ids moved with their column, rows 3..7 zero (outside the extended mode rlo
  and vc are returned as they came: zero throughout);
- the visit lists (``ops/window_lists.py``) of the sorted rows' tile flags
  at 128 x 128 (window ``geo.window``, x tested with slabs, the crossing
  margin 0.6 x skin);
- ``resorts`` + 1, where given;
- with ``check`` = (r_ref, invalid, travel2), the engine's travel check
  from the rows before the sort: the largest minimum-image
  squared travel along the sorted axes (z; max of x and z with slabs) over
  valid columns, into the sticky ``invalid`` (past ``geo.invalid_thresh``)
  and the running maximum ``travel2``, one of each a replica.

On CUDA tensors it is two launches (``csrc/zsort_resort.cu``: a
sort-and-gather kernel, a block a replica, counted as ``zsort_sort`` or
``zsort_sort_replicas``, also ``zsort_sort_global`` where the keys pass the
kernel's shared memory; and kernel 9's pack with its flags worked out from
the sorted tiles' intervals, counted as ``zsort_pack`` / ``zsort_pack_replicas``)
and the outputs' allocations: no host read, no ``torch.sort``, no
``compute_tile_flags``, at any n_pad the pack takes. On CPU tensors the
plain twin ``zsort_resort_plain``, the torch chain whose bits the kernels
give.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from ljmd_tpu_torch.ops import _cuda
from ljmd_tpu_torch.ops.geometry import minimum_image
from ljmd_tpu_torch.ops.window_lists import (_pack_max_rows, build_window_lists,
                                              compute_tile_flags, list_layout)

__all__ = ["ZSORT_TILE_I", "ZSortGeometry", "ZSortResorted", "travel_moved2", "zsort_resort",
           "zsort_resort_plain"]

# The window lists' block granule (the JAX engine's tile_i).
ZSORT_TILE_I = 128


@dataclasses.dataclass(frozen=True)
class ZSortGeometry:
    """The zsort engine's static choices for one config
    (``models/engine.py`` ``zsort_geometry``)."""

    sort_skin: float
    window: float
    invalid_thresh: float
    n_slabs: int
    slab_sort: bool
    tile_j: int
    n_pad: int
    bits_pad: int
    zq_bits: int
    fused_viable: bool


class ZSortResorted(NamedTuple):
    """``zsort_resort``'s outputs; ``resorts``, ``invalid`` and ``travel2``
    are None where their inputs were not given."""

    r: torch.Tensor
    ru: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    ids: torch.Tensor
    rlo: torch.Tensor
    vc: torch.Tensor
    tiles: torch.Tensor
    tcounts: torch.Tensor
    resorts: Optional[torch.Tensor]
    invalid: Optional[torch.Tensor]
    travel2: Optional[torch.Tensor]


def travel_moved2(r: torch.Tensor, r_ref: torch.Tensor, ids: torch.Tensor, box_length: float,
                  slab_sort: bool):
    """The travel check's measure: each replica's largest squared
    minimum-image travel from ``r_ref`` along the sorted axes over valid
    columns."""
    d = minimum_image(r[..., 0:3, :] - r_ref[..., 0:3, :], box_length)
    valid = (ids >= 0).to(r.dtype)
    dz2 = d[..., 2, :] * d[..., 2, :]
    moved = torch.maximum(d[..., 0, :] * d[..., 0, :], dz2) if slab_sort else dz2
    return torch.amax(moved * valid, dim=-1)


def zsort_resort_plain(r, ru, v, a, ids, rlo, vc, geo: ZSortGeometry, n: int, box_length: float,
                       extended: bool, resorts=None, check=None) -> ZSortResorted:
    """The plain twin of ``zsort_resort`` (module docstring): the torch
    chain of the engine's check, sort and lists."""
    L = box_length
    invalid = travel2 = None
    if check is not None:
        r_ref, invalid, travel2 = check
        moved2 = travel_moved2(r, r_ref, ids, L, geo.slab_sort)
        invalid, travel2 = invalid | (moved2 > geo.invalid_thresh), torch.maximum(travel2, moved2)
    n_pad, zq_bits, bits_pad = geo.n_pad, geo.zq_bits, geo.bits_pad
    col = torch.arange(n_pad, dtype=torch.int32, device=r.device)
    # Packed unique int32 keys (index in the low bits): torch.sort is then
    # deterministic, and a replica's order is its own alone. Quantization
    # only orders z within a bucket.
    zq = torch.clamp((r[..., 2, :] * ((1 << zq_bits) / L)).to(torch.int32), 0,
                     (1 << zq_bits) - 1)
    if geo.slab_sort:
        xb = torch.clamp((r[..., 0, :] * (geo.n_slabs / L)).to(torch.int32), 0, geo.n_slabs - 1)
        kq = (xb << zq_bits) | zq
    else:
        kq = zq
    kq = torch.where(ids >= 0, kq, (1 << (30 - bits_pad)) - 1)  # padding last
    packed = torch.sort((kq << bits_pad) | col, dim=-1).values
    order = (packed & ((1 << bits_pad) - 1)).long()
    # Permute only the data-carrying rows 0..2 (rows 3..7 are zero, and
    # rlo / vc are zero outside the extended mode).
    parts = [r[..., 0:3, :], ru[..., 0:3, :], v[..., 0:3, :], a[..., 0:3, :]]
    if extended:
        parts += [rlo[..., 0:3, :], vc[..., 0:3, :]]
    stacked = torch.cat(parts, dim=-2)
    if r.dim() == 2:
        stacked, ids = stacked[:, order], ids[order]
    else:
        stacked = torch.take_along_dim(stacked, order[:, None, :], dim=-1)
        ids = torch.take_along_dim(ids, order, dim=-1)
    pad5 = torch.zeros(r.shape[:-2] + (5, n_pad), dtype=r.dtype, device=r.device)

    def emb(k):
        return torch.cat([stacked[..., 3 * k:3 * k + 3, :], pad5], dim=-2)

    rlo2, vc2 = (emb(4), emb(5)) if extended else (rlo, vc)
    r8 = emb(0)
    flags = compute_tile_flags(r8, n, ZSORT_TILE_I, ZSORT_TILE_I, L, geo.window,
                               x_window=geo.window if geo.slab_sort else None,
                               cross_margin=0.6 * geo.sort_skin)
    tiles, tcounts = build_window_lists(flags, n, n_pad, ZSORT_TILE_I, geo.tile_j,
                                        zero_fill=False)
    return ZSortResorted(r8, emb(1), emb(2), emb(3), ids, rlo2, vc2, tiles, tcounts,
                         None if resorts is None else resorts + 1, invalid, travel2)


def _pointers(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _launch(r, ru, v, a, ids, rlo, vc, geo: ZSortGeometry, n, box_length, extended, resorts,
            check) -> ZSortResorted:
    stacked = r.dim() == 3
    fields = [r, ru, v, a] + ([rlo, vc] if extended else [])
    refs = [check[0]] if check is not None else []
    _cuda.require_cuda_rows("zsort_resort", *fields, *refs, replicas=stacked)
    reps = r.shape[0] if stacked else 1
    batch = r.shape[:-2]
    n_pad = r.shape[-1]
    if n_pad != geo.n_pad or not 0 <= n <= n_pad:
        raise ValueError(f"zsort_resort: rows of {n_pad} columns for n_pad={geo.n_pad}, n={n}")
    ids = ids.contiguous()
    if ids.dtype != torch.int32 or ids.shape != batch + (n_pad,) or ids.device != r.device:
        raise ValueError(f"zsort_resort: ids must be {batch + (n_pad,)} int32 on {r.device}")
    dev, dtype = r.device, r.dtype
    n_b = n_pad // ZSORT_TILE_I
    if n_b > _pack_max_rows():
        raise ValueError(f"zsort_resort: {n_b} block rows > the pack kernel's {_pack_max_rows()}")
    n_tails, n_rows, max_t, n_cats = list_layout(n_pad, ZSORT_TILE_I, geo.tile_j, True)
    # r apart from the rest: the carry's r_ref keeps the new r alive through
    # the next chunk, while the chunk replaces ru, v and a.
    outs = [torch.empty_like(r), *torch.empty((len(fields) - 1,) + r.shape, dtype=dtype,
                                               device=dev)]
    ids_out = torch.empty_like(ids)
    tiles = torch.empty(batch + (n_rows, max_t), dtype=torch.int32, device=dev)
    tcounts = torch.empty(batch + (n_cats,), dtype=torch.int32, device=dev)
    ivl = torch.empty((reps, 4, n_b), dtype=dtype, device=dev)
    p2 = 1 << max(7, (n_pad - 1).bit_length())
    glob = p2 > _shared_keys()
    keys = torch.empty((reps, p2), dtype=torch.int32, device=dev) if glob else None
    resorts_out = None if resorts is None else torch.empty_like(resorts)
    invalid_out = travel2_out = None
    ptr = _cuda.ptr
    if check is not None:
        r_ref, invalid, travel2 = check
        if invalid.dtype != torch.bool or invalid.shape != batch or \
                travel2.dtype != dtype or travel2.shape != batch:
            raise ValueError(f"zsort_resort: invalid / travel2 must be {batch} bool / {dtype}")
        invalid_out, travel2_out = torch.empty_like(invalid), torch.empty_like(travel2)
        chk = (ptr(r_ref), ptr(invalid), ptr(invalid_out), ptr(travel2), ptr(travel2_out))
    else:
        chk = (None,) * 5
    if resorts is not None and (resorts.dtype != torch.int32 or resorts.shape != batch):
        raise ValueError(f"zsort_resort: resorts must be {batch} int32")
    L = float(box_length)
    cross = 0.6 * geo.sort_skin
    with torch.cuda.device(dev):
        code = getattr(_cuda.library(), f"ljmd_zsort_resort_{_cuda.dtype_suffix(dtype)}")(
            _pointers(fields), _pointers(outs), len(fields), ids.data_ptr(),
            ids_out.data_ptr(), ptr(resorts), ptr(resorts_out), *chk, ivl.data_ptr(),
            ptr(keys), tiles.data_ptr(), tcounts.data_ptr(), n, n_pad, reps, int(stacked),
            geo.zq_bits, geo.bits_pad, geo.n_slabs, int(geo.slab_sort), int(check is not None),
            geo.tile_j, n_tails, max_t, (1 << geo.zq_bits) / L, geo.n_slabs / L, L, 1.0 / L,
            geo.invalid_thresh, geo.window, cross, L - cross, L - geo.window,
            _cuda.stream_handle(r))
    suffix = "_replicas" if stacked else ""
    _cuda.LAUNCHES.bump("zsort_sort" + suffix)
    if glob:
        _cuda.LAUNCHES.bump("zsort_sort_global")
    _cuda.LAUNCHES.bump("zsort_pack" + suffix)
    _cuda.check(code, "zsort_resort")
    rlo2, vc2 = (outs[4], outs[5]) if extended else (rlo, vc)
    return ZSortResorted(outs[0], outs[1], outs[2], outs[3], ids_out, rlo2, vc2, tiles, tcounts,
                         resorts_out, invalid_out, travel2_out)


@functools.lru_cache(maxsize=1)
def _shared_keys() -> int:
    """The sort kernel's most keys in shared memory, asked of the library
    once."""
    return _cuda.library().ljmd_zsort_sort_shared_keys()


def zsort_resort(r, ru, v, a, ids, rlo, vc, geo: ZSortGeometry, n: int, box_length: float,
                 extended: bool, resorts=None, check=None) -> ZSortResorted:
    """Resort the zsort carry's rows and rebuild its visit lists (module
    docstring). Two kernel launches on CUDA tensors; the plain twin
    otherwise. ``check`` = (r_ref, invalid, travel2) folds the engine's
    travel check in."""
    if r.device.type == "cuda":
        return _launch(r, ru, v, a, ids, rlo, vc, geo, n, box_length, extended, resorts, check)
    return zsort_resort_plain(r, ru, v, a, ids, rlo, vc, geo, n, box_length, extended, resorts,
                              check)
