"""Checkpoints (counterpart of ``ljmd_tpu/io/checkpoint.py``).

- ``save_rv_init`` / ``load_rv_init``: the reference's warmup -> production
  snapshot ``rv_init.dat`` in the Fortran binary format, so either package
  (and the reference's own tooling) can start from the other's snapshot.
- ``save_checkpoint`` / ``load_checkpoint``: the streaming driver's
  mid-production checkpoint (absent in the reference, SURVEY §5.4), a
  ``.npz`` holding everything a bit-exact resume needs.

The state, means and series go under the JAX package's keys (``r ru v a
step means_count means_moments means_shift series sample_idx``), so each
package reads the other's state. The engine carry goes under keys the JAX
loader does not read: ``torch_carry_class`` (the carry's class name),
``torch_carry_structure`` (its classes and field names, nested),
``torch_carry_fields`` (each tensor's path) and ``torch_carry__<i>`` (the
tensors). The JAX package stores its carry as bare leaves (``carry_n``,
``carry_<i>``), which this loader does not read either: neither package
restores the other's carry, whose leaves could match in count and shape
without meaning the same thing.

A checkpoint is written to a temporary file in its directory, fsynced, and
renamed over the old one (``os.replace``): a kill mid-write leaves the last
checkpoint whole.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from ljmd_tpu_torch.io.fortran_records import read_rv_init, write_rv_init
from ljmd_tpu_torch.state import MDState
from ljmd_tpu_torch.stats.moments import MeansAccum

__all__ = ["Checkpoint", "CarryArrays", "flatten_carry", "unflatten_carry", "save_checkpoint",
           "load_checkpoint", "save_rv_init", "load_rv_init"]


@dataclasses.dataclass
class CarryArrays:
    """An engine carry, flattened field by field (``flatten_carry``):
    ``cls`` the carry's class name, ``structure`` its nested classes and
    field names, ``fields`` each tensor's path, ``arrays`` the tensors as
    host arrays, in that order."""

    cls: str
    structure: str
    fields: list
    arrays: list


@dataclasses.dataclass
class Checkpoint:
    state: MDState
    step: int
    means: Optional[MeansAccum]
    sample_count: int
    # The streaming driver's extras (models/streaming.py): the sampled series
    # so far (host float64, (5, n_done)) and the resume point.
    series: Optional[np.ndarray] = None
    sample_idx: int = 0
    # The engine carry, for a bit-exact resume of the binned engines, whose
    # slot order after a rebin depends on the order before it: re-binning
    # the particle-order MDState gives another within-pencil order and hence
    # another summation order.
    carry: Optional[CarryArrays] = None


def _flatten(node: Any, path: str, out: list) -> str:
    if isinstance(node, torch.Tensor):
        out.append((path, node))
        return "T"
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        parts = [f"{f.name}={_flatten(getattr(node, f.name), f'{path}{f.name}.', out)}"
                 for f in dataclasses.fields(node)]
        return f"{type(node).__name__}({','.join(parts)})"
    if isinstance(node, tuple):
        parts = [_flatten(x, f"{path}{i}.", out) for i, x in enumerate(node)]
        return f"tuple({','.join(parts)})"
    raise TypeError(f"cannot flatten an engine carry holding {type(node).__name__} "
                    f"at {path.rstrip('.') or '<root>'}: fields must be tensors, "
                    "dataclasses or tuples")


def flatten_carry(carry: Any) -> tuple[str, list]:
    """(structure, [(path, tensor), ...]) of an engine carry: dataclasses by
    field, tuples by index, down to tensors. Anything else raises
    TypeError."""
    leaves: list = []
    structure = _flatten(carry, "", leaves)
    return structure, leaves


def unflatten_carry(template: Any, tensors: list) -> Any:
    """``template`` with its tensors replaced, in ``flatten_carry`` order."""
    it = iter(tensors)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{f.name: build(getattr(node, f.name))
                                                for f in dataclasses.fields(node)})
        return tuple(build(x) for x in node)

    return build(template)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(
    path: str,
    state: MDState,
    step: int,
    means: Optional[MeansAccum] = None,
    series: Optional[np.ndarray] = None,
    sample_idx: Optional[int] = None,
    carry: Any = None,
) -> int:
    """Write a checkpoint atomically (module docstring). ``series`` /
    ``sample_idx`` are the streaming driver's resume point, ``carry`` the
    engine carry (``flatten_carry``). Returns the bytes written."""
    arrays = {k: _host(getattr(state, k)) for k in ("r", "ru", "v", "a")}
    arrays["step"] = np.asarray(step, dtype=np.int64)
    if means is not None:
        arrays["means_count"] = _host(means.count)
        arrays["means_moments"] = _host(means.moments)
        arrays["means_shift"] = _host(means.shift)
    if series is not None:
        arrays["series"] = np.asarray(series, dtype=np.float64)
    if sample_idx is not None:
        arrays["sample_idx"] = np.asarray(sample_idx, dtype=np.int64)
    if carry is not None:
        structure, leaves = flatten_carry(carry)
        arrays["torch_carry_class"] = np.asarray(type(carry).__name__)
        arrays["torch_carry_structure"] = np.asarray(structure)
        arrays["torch_carry_fields"] = np.asarray([p.rstrip(".") for p, _ in leaves])
        for i, (_, t) in enumerate(leaves):
            arrays[f"torch_carry__{i}"] = _host(t)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=".checkpoint_", suffix=".npz.tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return os.path.getsize(path)


def load_checkpoint(path: str, dtype=None, device="cpu") -> Checkpoint:
    """Load a checkpoint of either package onto ``device``; with ``dtype``
    the state is cast (the means keep their stored dtype). The carry is read
    only from the port's keys (module docstring)."""
    dev = torch.device(device)

    def tensor(a, cast=None):
        return torch.as_tensor(np.array(a), dtype=cast, device=dev)

    with np.load(path) as z:
        state = MDState(*(tensor(z[k], dtype) for k in ("r", "ru", "v", "a")))
        step = int(z["step"])
        means, count = None, 0
        if "means_moments" in z:
            moments = tensor(z["means_moments"])
            means = MeansAccum(
                count=tensor(z["means_count"]), moments=moments,
                shift=(tensor(z["means_shift"]) if "means_shift" in z
                       else torch.zeros(moments.shape[1:], dtype=moments.dtype, device=dev)))
            count = int(z["means_count"])
        series = z["series"].copy() if "series" in z else None
        sample_idx = int(z["sample_idx"]) if "sample_idx" in z else 0
        carry = None
        if "torch_carry_structure" in z:
            fields = [str(f) for f in z["torch_carry_fields"]]
            carry = CarryArrays(cls=str(z["torch_carry_class"]),
                                structure=str(z["torch_carry_structure"]), fields=fields,
                                arrays=[z[f"torch_carry__{i}"].copy()
                                        for i in range(len(fields))])
    return Checkpoint(state=state, step=step, means=means, sample_count=count,
                      series=series, sample_idx=sample_idx, carry=carry)


def save_rv_init(path: str, state: MDState) -> None:
    """Write positions + velocities (float64 records) in the reference
    format."""
    write_rv_init(path, state.r.detach().cpu().numpy().astype(np.float64),
                  state.v.detach().cpu().numpy().astype(np.float64))


def load_rv_init(path: str, n: int, dtype=torch.float32, device="cpu") -> MDState:
    """Read an rv_init.dat into an MDState with ru = r and zero
    accelerations: the caller evaluates the initial forces, as the reference
    does (md_simulation_program.f90:221-236)."""
    r, v = read_rv_init(path, n)
    r_t = torch.as_tensor(r, dtype=dtype, device=device)
    return MDState(r=r_t, ru=r_t.clone(), v=torch.as_tensor(v, dtype=dtype, device=device),
                   a=torch.zeros_like(r_t))
