"""Finding a cell by its name. ``BENCHMARK.json`` at the root of the
checkout names each cell's configuration and traffic; each lives in a file
of its own under this folder, found by that name:

- ``configs/<config>.json``: the port's ``SimConfig`` fields as run, beside
  notes on the source and the cut (keys that are not fields are notes);
- ``workloads/<traffic>.json``: what a run asks of the system: ``replicas``
  and ``output_interval``;
- ``limits/<cell>.json``: the limit of each number the correctness check
  compares (``check.NAMES``);
- ``metrics/<metric>.py``: a reader, ``read(ctx)``, of each metric.

A later cell or metric is added by adding files and entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

from ljmd_tpu_torch.config import SimConfig

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
_FIELDS = {f.name for f in dataclasses.fields(SimConfig) if f.init}


@dataclasses.dataclass(frozen=True)
class Cell:
    """One cell as a run takes it: the configuration with the traffic's
    interval and the run's seed, the replica count, and the metrics and
    limits that apply."""

    name: str
    cfg: SimConfig
    replicas: int
    chips: int
    end_to_end: tuple
    per_layer: tuple
    limits: dict


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(name: str, seed: int, output_interval: int | None = None) -> SimConfig:
    """The configuration ``name`` with ``seed`` (and the traffic's
    interval, where given)."""
    raw = _json(HERE / "configs" / f"{name}.json")
    fields = {k: v for k, v in raw.items() if k in _FIELDS}
    fields["seed"] = int(seed)
    if output_interval is not None:
        fields["output_interval"] = int(output_interval)
    return SimConfig(**fields)


def load_traffic(name: str) -> dict:
    return _json(HERE / "workloads" / f"{name}.json")


def load_limits(cell: str) -> dict:
    return _json(HERE / "limits" / f"{cell}.json")


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"ljbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, seed: int, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if not entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = entries[0]
    traffic = load_traffic(entry["traffic"])
    cfg = load_config(entry["config"], seed, traffic["output_interval"])
    return Cell(
        name=workload, cfg=cfg, replicas=int(traffic["replicas"]), chips=int(entry["chips"]),
        end_to_end=tuple(m for m in bench["end_to_end"] if applies(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"] if applies(m, workload)),
        limits=load_limits(workload))
