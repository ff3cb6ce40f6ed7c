"""State carried between the JAX package and this port, as numpy arrays.

``jax.random`` and ``torch.Generator`` never draw the same numbers, so
parity checks start both packages from one numpy state:

- ``MDState`` fields as (N, 3) arrays, or an ensemble's as (R, N, 3) (JAX's
  vmapped states; ``state_from_numpy`` / ``state_to_numpy``);
- ``RowCarry`` fields as (8, n_pad) row matrices, re-padded between the JAX
  engine's padding and this port's (``row_carry_from_numpy`` /
  ``row_carry_to_numpy``);
- ``ZSortCarry`` fields as they are (both packages pad the zsort engine to
  the same n_pad): the sorted column order, the ids, the visit lists, the
  sticky flag and the port's resort count and largest travel (0 from a JAX
  carry)
  (``zsort_carry_from_numpy`` / ``zsort_carry_to_numpy``);
- ``PencilCarry`` fields as they are (both packages lay the slots out
  alike): the slot rows, the counts, the z-band's window tables and the
  width lists, and the sticky overflow flag (``pencil_carry_from_numpy`` /
  ``pencil_carry_to_numpy``); a batched carry's per-replica fields in the
  JAX package's vmapped layout, (R, 8, n_slots) rows, (R, n_pencils) counts
  and (R,) flags, each replica's slice its one-system field
  (``pencil_replicas_to_numpy`` / ``pencil_replicas_from_numpy``);
- the neighbor engine's carry, (MDState, NeighborList): the list's indices,
  reference positions and sticky overflow flag (``neighbor_list_from_numpy``,
  ``neighbor_carry_from_numpy``);
- the particle-sharded engine's carry (``parallel/spatial.py``): a JAX
  sharded MDState, or its compensated (MDState, rc, vc), as global (N, 3)
  arrays, to the tuple of a mesh's per-rank carries and back
  (``spatial_carry_from_numpy`` / ``spatial_carry_to_numpy``);
- the sharded pencil engine's carry (``parallel/spatial_pencil.py``): a JAX
  ``ShardedPencilCarry`` as global (8, n_slots) arrays, (n_pencils,) counts
  and the flag, to the per-rank strips with their strip-plus-halo counts and
  back (``sharded_pencil_carry_from_numpy`` /
  ``sharded_pencil_carry_to_numpy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ljmd_tpu_torch.models.engine import ROW_PAD, PencilCarry, RowCarry, ZSortCarry
from ljmd_tpu_torch.ops.fused_pencil import build_width_lists
from ljmd_tpu_torch.ops.neighbor import NeighborList
from ljmd_tpu_torch.parallel.spatial_pencil import ShardedPencilCarry, augmented_counts
from ljmd_tpu_torch.state import MDState

__all__ = [
    "PENCIL_FIELDS",
    "PENCIL_REPLICA_FIELDS",
    "ROW_FIELDS",
    "STATE_FIELDS",
    "ZSORT_FIELDS",
    "neighbor_carry_from_numpy",
    "neighbor_list_from_numpy",
    "row_carry_from_numpy",
    "row_carry_to_numpy",
    "sharded_pencil_carry_from_numpy",
    "sharded_pencil_carry_to_numpy",
    "spatial_carry_from_numpy",
    "spatial_carry_to_numpy",
    "state_from_numpy",
    "pencil_carry_from_numpy",
    "pencil_carry_to_numpy",
    "pencil_replicas_from_numpy",
    "pencil_replicas_to_numpy",
    "state_to_numpy",
    "zsort_carry_from_numpy",
    "zsort_carry_to_numpy",
]

STATE_FIELDS = ("r", "ru", "v", "a")
ROW_FIELDS = ("r", "ru", "v", "a", "rc", "vc")
ZSORT_FIELDS = ("r", "ru", "v", "a", "ids", "r_ref", "tiles", "tcounts", "invalid",
                "rlo", "vc", "resorts", "travel2", "skips")
_ZSORT_INT = ("ids", "tiles", "tcounts", "resorts")
# Fields of the port's carry that the JAX carry lacks, with their trailing
# shapes and dtypes.
_ZSORT_PORT_ONLY = {"resorts": ((), np.int32), "travel2": ((), np.float64),
                    "skips": ((2,), np.int64)}
PENCIL_FIELDS = tuple(f.name for f in dataclasses.fields(PencilCarry))
_PENCIL_INT = ("counts", "win_a", "win_b", "use_b", "wl_self", "wl_self_cnt", "wl_nbr_i",
               "wl_nbr_j", "wl_nbr_off")


def state_from_numpy(arrays, dtype=torch.float64, device="cpu") -> MDState:
    """MDState from a mapping (or object with attributes) of (N, 3) arrays,
    or of an ensemble's (R, N, 3) arrays (e.g. the JAX package's vmapped
    initial states), all of one shape."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    fields = [np.array(get(k)) for k in STATE_FIELDS]
    shape = fields[0].shape
    if len(shape) not in (2, 3) or shape[-1] != 3 or any(f.shape != shape for f in fields):
        raise ValueError(f"expected (N, 3) or (R, N, 3) state arrays of one shape, got "
                         f"{[f.shape for f in fields]}")
    return MDState(*(torch.as_tensor(f, dtype=dtype, device=device) for f in fields))


def state_to_numpy(state: MDState) -> dict:
    """{field: (N, 3) or (R, N, 3) float array} of an MDState, on the host."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in STATE_FIELDS}


def _repad(rows: np.ndarray, n: int, n_pad: int) -> np.ndarray:
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[0] != 8 or rows.shape[1] < n:
        raise ValueError(f"expected (8, >= {n}) rows, got {rows.shape}")
    if np.any(rows[3:]) or np.any(rows[:, n:]):
        raise ValueError("rows 3..7 and columns >= n of a row matrix must be zero")
    out = np.zeros((8, n_pad), dtype=rows.dtype)
    out[:, :n] = rows[:, :n]
    return out


def row_carry_from_numpy(arrays, n: int, dtype=torch.float64, device="cpu") -> RowCarry:
    """RowCarry from (8, n_pad_src) arrays (a mapping, or an object with
    attributes, e.g. the JAX package's RowCarry after ``np.asarray``),
    re-padded to this port's ``ROW_PAD`` multiple."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    n_pad = -(-n // ROW_PAD) * ROW_PAD
    return RowCarry(*(torch.as_tensor(_repad(get(k), n, n_pad), dtype=dtype, device=device)
                      for k in ROW_FIELDS))


def row_carry_to_numpy(carry: RowCarry, n: int, n_pad: int) -> dict:
    """{field: (8, n_pad) array} of a RowCarry, re-padded to ``n_pad``
    columns (e.g. the JAX engine's)."""
    return {k: _repad(getattr(carry, k).detach().cpu().numpy(), n, n_pad)
            for k in ROW_FIELDS}


def _carry_from_numpy(cls, fields, int_fields, flag, arrays, dtype, device, scalars=(),
                      counts=()):
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))

    def conv(k):
        x = np.array(get(k))
        if k in int_fields:
            return torch.as_tensor(x, dtype=torch.int32, device=device)
        if k in counts:
            return torch.as_tensor(x, dtype=torch.int64, device=device)
        if k == flag:
            return torch.as_tensor(x, dtype=torch.bool, device=device)
        if k in scalars:
            return torch.as_tensor(x, dtype=dtype, device=device)
        if x.ndim != 2 or x.shape[0] != 8:
            raise ValueError(f"{k}: expected (8, n) rows, got {x.shape}")
        return torch.as_tensor(x, dtype=dtype, device=device)

    return cls(**{k: conv(k) for k in fields})


def zsort_carry_from_numpy(arrays, dtype=torch.float64, device="cpu") -> ZSortCarry:
    """ZSortCarry from arrays (a mapping, or an object with attributes, e.g.
    the JAX package's ZSortCarry): float rows in ``dtype``, ids / tiles /
    tcounts / resorts int32, ``invalid`` bool, ``travel2`` in ``dtype``,
    ``skips`` int64; nothing is re-ordered or re-padded. A source without
    ``resorts``, ``travel2`` and ``skips`` (the JAX carry has none of them)
    starts them at 0."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    fields = {k: get(k) for k in ZSORT_FIELDS if k not in _ZSORT_PORT_ONLY}
    shape = np.shape(fields["invalid"])
    for k, (tail, kind) in _ZSORT_PORT_ONLY.items():
        fields[k] = get(k) if _has(arrays, k) else np.zeros(shape + tail, dtype=kind)
    return _carry_from_numpy(ZSortCarry, ZSORT_FIELDS, _ZSORT_INT, "invalid", fields, dtype,
                             device, scalars=("travel2",), counts=("skips",))


def zsort_carry_to_numpy(carry: ZSortCarry) -> dict:
    """{field: array} of a ZSortCarry, on the host."""
    return {k: getattr(carry, k).detach().cpu().numpy() for k in ZSORT_FIELDS}


def _has(arrays, k) -> bool:
    return k in arrays if isinstance(arrays, dict) else hasattr(arrays, k)


def pencil_carry_from_numpy(arrays, dtype=torch.float64, device="cpu") -> PencilCarry:
    """PencilCarry from arrays (a mapping, or an object with attributes, e.g.
    the JAX package's PencilCarry): float rows in ``dtype``, counts, window
    tables and width lists int32, ``overflow`` bool; slots as they are. A
    source without ``drift2`` (the JAX carry has none) starts it at 0."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    fields = {k: get(k) for k in PENCIL_FIELDS if k != "drift2"}
    fields["drift2"] = (get("drift2") if _has(arrays, "drift2")
                        else np.zeros(np.shape(fields["overflow"])))
    return _carry_from_numpy(PencilCarry, PENCIL_FIELDS, _PENCIL_INT, "overflow", fields,
                             dtype, device, scalars=("drift2",))


def pencil_carry_to_numpy(carry: PencilCarry) -> dict:
    """{field: array} of a PencilCarry, on the host."""
    return {k: getattr(carry, k).detach().cpu().numpy() for k in PENCIL_FIELDS}


_PENCIL_ROWS = ("r", "ru", "v", "a", "r_ref", "rc", "vc")
_PENCIL_WINS = ("win_a", "win_b", "use_b")
# The fields a batched cell-pair carry holds per replica (the width lists
# are the stack's own).
PENCIL_REPLICA_FIELDS = _PENCIL_ROWS + ("counts", "overflow", "drift2") + _PENCIL_WINS


def pencil_replicas_to_numpy(carry: PencilCarry, replicas: int) -> dict:
    """{field: array} of a batched ``PencilCarry`` (the flat stack of
    ``_cellpair_engine(..., replicas=R)``) in the JAX package's vmapped
    layout: slot rows (R, 8, n_slots), counts (R, n_pencils), the flag
    and the running drift max (R,), the z-band's window tables (R, n_slots / 128 * 9); ``[q]`` of each
    is replica q's one-system field. The width lists are the stack's and
    are left out."""
    out = {k: getattr(carry, k).detach().reshape(8, replicas, -1).transpose(0, 1).cpu().numpy()
           for k in _PENCIL_ROWS}
    for k in ("counts",) + _PENCIL_WINS:
        out[k] = getattr(carry, k).detach().reshape(replicas, -1).cpu().numpy()
    out["overflow"] = carry.overflow.detach().reshape(replicas).cpu().numpy()
    out["drift2"] = carry.drift2.detach().reshape(replicas).cpu().numpy()
    return out


def pencil_replicas_from_numpy(arrays, tables=None, dtype=torch.float64,
                               device="cpu") -> PencilCarry:
    """A batched ``PencilCarry`` from per-replica arrays (a mapping or an
    object with attributes, e.g. the JAX package's vmapped carry): slot rows
    (R, 8, n_slots) side by side as (8, R * n_slots), counts (R, n_pencils)
    one after another, the flags (R,) and the running drift max (R,; 0
    where the source has none, as the JAX carry); the width lists built from the
    stack's counts over ``tables`` (the engine's ``replica_tables``, as
    (tbl, shf)), or left empty without; the z-band's window tables (R,
    n_slots / 128 * 9) one after another."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    rows = {k: np.array(get(k)) for k in _PENCIL_ROWS}
    reps, _, ns = rows["r"].shape
    fields = {k: torch.as_tensor(x.transpose(1, 0, 2).reshape(8, reps * ns), dtype=dtype,
                                 device=device).contiguous() for k, x in rows.items()}
    counts = np.array(get("counts"))
    n_pencils = counts.shape[1]
    fields["counts"] = torch.as_tensor(counts.reshape(-1), dtype=torch.int32, device=device)
    fields["overflow"] = torch.as_tensor(np.array(get("overflow")).reshape(reps),
                                         dtype=torch.bool, device=device)
    drift2 = np.array(get("drift2")) if _has(arrays, "drift2") else np.zeros(reps)
    fields["drift2"] = torch.as_tensor(drift2.reshape(reps), dtype=dtype, device=device)
    zero = torch.zeros((1,), dtype=torch.int32, device=device)
    lists = (zero,) * 5
    if tables is not None:
        lists = build_width_lists(fields["counts"], *tables, reps * n_pencils, ns // n_pencils)
    for k in _PENCIL_WINS:
        fields[k] = torch.as_tensor(np.array(get(k)).reshape(-1), dtype=torch.int32,
                                    device=device)
    return PencilCarry(**fields,
                       **dict(zip(("wl_self", "wl_self_cnt", "wl_nbr_i", "wl_nbr_j",
                                   "wl_nbr_off"), lists)))


def neighbor_list_from_numpy(arrays, dtype=torch.float64, device="cpu") -> NeighborList:
    """NeighborList from arrays (a mapping, or an object with attributes,
    e.g. the JAX package's NeighborList): idx int32, r_ref in ``dtype``,
    overflow bool."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    return NeighborList(
        idx=torch.as_tensor(np.array(get("idx")), dtype=torch.int32, device=device),
        r_ref=torch.as_tensor(np.array(get("r_ref")), dtype=dtype, device=device),
        overflow=torch.as_tensor(np.array(get("overflow")), dtype=torch.bool, device=device))


def neighbor_carry_from_numpy(carry, dtype=torch.float64, device="cpu"):
    """The neighbor engine's (MDState, NeighborList) carry from a pair of
    the same (e.g. the JAX engine's carry)."""
    state, nbrs = carry
    return (state_from_numpy(state, dtype, device),
            neighbor_list_from_numpy(nbrs, dtype, device))


def spatial_carry_from_numpy(carry, mesh, dtype=torch.float64) -> tuple:
    """The local ranks' carries of the particle-sharded engine from a global
    MDState (a mapping or object of (N, 3) arrays, e.g. the JAX engine's
    sharded carry) or a compensated (state, rc, vc) triple; rank s gets rows
    [s N/d, (s+1) N/d)."""
    compensated = isinstance(carry, tuple)
    state = state_from_numpy(carry[0] if compensated else carry, dtype, mesh.device)
    shards = [MDState(*parts) for parts in zip(*(mesh.split(getattr(state, k), 0)
                                                   for k in STATE_FIELDS))]
    if not compensated:
        return tuple(shards)
    rc, vc = (mesh.split(torch.as_tensor(np.array(x), dtype=dtype, device=mesh.device), 0)
              for x in carry[1:])
    return tuple(zip(shards, rc, vc))


def spatial_carry_to_numpy(carry, mesh):
    """The global arrays of a particle-sharded carry: {field: (N, 3)}, or
    ({field: (N, 3)}, rc, vc) when compensated (the JAX engine's layout)."""
    compensated = isinstance(carry[0], tuple)
    shards = [c[0] for c in carry] if compensated else list(carry)

    def glob(parts):
        return mesh.gather(parts, 0).detach().cpu().numpy()

    state = {k: glob([getattr(s, k) for s in shards]) for k in STATE_FIELDS}
    if not compensated:
        return state
    return state, glob([c[1] for c in carry]), glob([c[2] for c in carry])


_SHARDED_ROWS = ("r", "ru", "v", "a", "r_ref", "rc", "vc")


def sharded_pencil_carry_from_numpy(arrays, mesh, m_xy: int, dtype=torch.float64) -> tuple:
    """The local ranks' ``ShardedPencilCarry`` from global arrays (a mapping
    or object, e.g. the JAX engine's carry): (8, n_slots) rows cut into
    strips, the (m_xy^2,) counts into strip-plus-halo counts."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    rows = {k: mesh.split(torch.as_tensor(np.array(get(k)), dtype=dtype, device=mesh.device),
                          1) for k in _SHARDED_ROWS}
    counts = torch.as_tensor(np.array(get("counts")), dtype=torch.int32, device=mesh.device)
    every = augmented_counts(counts, m_xy, mesh.size)
    flag = torch.as_tensor(np.array(get("overflow")), dtype=torch.bool, device=mesh.device)
    return tuple(ShardedPencilCarry(counts=every[s], overflow=flag,
                                    **{k: rows[k][i] for k in _SHARDED_ROWS})
                 for i, s in enumerate(mesh.local_ranks))


def sharded_pencil_carry_to_numpy(carries, mesh, m_xy: int) -> dict:
    """{field: global array} of the sharded pencil engine's carry: (8,
    n_slots) rows, the (m_xy^2,) counts (each strip's own, in rank order),
    the flag."""
    out = {k: mesh.gather([getattr(c, k) for c in carries], 1).detach().cpu().numpy()
           for k in _SHARDED_ROWS}
    own = [c.counts[:c.counts.numel() - m_xy] for c in carries]
    out["counts"] = mesh.gather(own, 0).detach().cpu().numpy()
    out["overflow"] = bool(carries[0].overflow)
    return out
