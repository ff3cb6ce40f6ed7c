"""State carried between the JAX package and this port, as numpy arrays.

``jax.random`` and ``torch.Generator`` never draw the same numbers, so
parity checks start both packages from one numpy state:

- ``MDState`` fields as (N, 3) arrays (``state_from_numpy`` /
  ``state_to_numpy``);
- ``RowCarry`` fields as (8, n_pad) row matrices, re-padded between the JAX
  engine's padding and this port's (``row_carry_from_numpy`` /
  ``row_carry_to_numpy``);
- ``ZSortCarry`` fields as they are (both packages pad the zsort engine to
  the same n_pad): the sorted column order, the ids, the visit lists and
  the sticky flag (``zsort_carry_from_numpy`` / ``zsort_carry_to_numpy``);
- ``PencilCarry`` fields as they are (both packages lay the slots out
  alike): the slot rows, the counts, window tables and width lists, and the
  sticky overflow flag (``pencil_carry_from_numpy`` /
  ``pencil_carry_to_numpy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ljmd_tpu_torch.models.engine import ROW_PAD, PencilCarry, RowCarry, ZSortCarry
from ljmd_tpu_torch.state import MDState

__all__ = [
    "PENCIL_FIELDS",
    "ROW_FIELDS",
    "STATE_FIELDS",
    "ZSORT_FIELDS",
    "row_carry_from_numpy",
    "row_carry_to_numpy",
    "state_from_numpy",
    "pencil_carry_from_numpy",
    "pencil_carry_to_numpy",
    "state_to_numpy",
    "zsort_carry_from_numpy",
    "zsort_carry_to_numpy",
]

STATE_FIELDS = ("r", "ru", "v", "a")
ROW_FIELDS = ("r", "ru", "v", "a", "rc", "vc")
ZSORT_FIELDS = ("r", "ru", "v", "a", "ids", "r_ref", "tiles", "tcounts", "invalid",
                "rlo", "vc")
_ZSORT_INT = ("ids", "tiles", "tcounts")
PENCIL_FIELDS = tuple(f.name for f in dataclasses.fields(PencilCarry))
_PENCIL_INT = ("counts", "win_a", "win_b", "use_b", "wl_self", "wl_self_cnt", "wl_nbr_i",
               "wl_nbr_j", "wl_nbr_off")


def state_from_numpy(arrays, dtype=torch.float64, device="cpu") -> MDState:
    """MDState from a mapping (or object with attributes) of (N, 3) arrays."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))
    return MDState(*(torch.as_tensor(np.array(get(k)), dtype=dtype, device=device)
                     for k in STATE_FIELDS))


def state_to_numpy(state: MDState) -> dict:
    """{field: (N, 3) float array} of an MDState, on the host."""
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


def _carry_from_numpy(cls, fields, int_fields, flag, arrays, dtype, device):
    get = arrays.__getitem__ if isinstance(arrays, dict) else (lambda k: getattr(arrays, k))

    def conv(k):
        x = np.array(get(k))
        if k in int_fields:
            return torch.as_tensor(x, dtype=torch.int32, device=device)
        if k == flag:
            return torch.as_tensor(x, dtype=torch.bool, device=device)
        if x.ndim != 2 or x.shape[0] != 8:
            raise ValueError(f"{k}: expected (8, n) rows, got {x.shape}")
        return torch.as_tensor(x, dtype=dtype, device=device)

    return cls(**{k: conv(k) for k in fields})


def zsort_carry_from_numpy(arrays, dtype=torch.float64, device="cpu") -> ZSortCarry:
    """ZSortCarry from arrays (a mapping, or an object with attributes, e.g.
    the JAX package's ZSortCarry): float rows in ``dtype``, ids / tiles /
    tcounts int32, ``invalid`` bool; nothing is re-ordered or re-padded."""
    return _carry_from_numpy(ZSortCarry, ZSORT_FIELDS, _ZSORT_INT, "invalid", arrays, dtype,
                             device)


def zsort_carry_to_numpy(carry: ZSortCarry) -> dict:
    """{field: array} of a ZSortCarry, on the host."""
    return {k: getattr(carry, k).detach().cpu().numpy() for k in ZSORT_FIELDS}


def pencil_carry_from_numpy(arrays, dtype=torch.float64, device="cpu") -> PencilCarry:
    """PencilCarry from arrays (a mapping, or an object with attributes, e.g.
    the JAX package's PencilCarry): float rows in ``dtype``, counts, window
    tables and width lists int32, ``overflow`` bool; slots as they are."""
    return _carry_from_numpy(PencilCarry, PENCIL_FIELDS, _PENCIL_INT, "overflow", arrays,
                             dtype, device)


def pencil_carry_to_numpy(carry: PencilCarry) -> dict:
    """{field: array} of a PencilCarry, on the host."""
    return {k: getattr(carry, k).detach().cpu().numpy() for k in PENCIL_FIELDS}
