"""BENCHMARK.json and the files it names: every cell, configuration,
traffic, limit and metric reader found by its name, and the contract's
shape rules."""

import json
import re
from pathlib import Path

import pytest

from ljbench import check
from ljbench.spec import HERE, ROOT, applies, load_cell, load_config, reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["ljbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "ljbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    cells = len(BENCH["workloads"])
    # A full check of 24 cells must fit: 2 + 14 x 24 runs, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, cells // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_text_fields():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names)
    assert len(set(e["name"] for e in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
                 + [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"particle_steps_per_s", "cycle_ms_p95", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
    assert {m["name"] for m in BENCH["per_layer"]} == {
        "cycle_ms_p50", "device_ops_per_step", "device_idle_pct", "pair_roofline_pct"}
    for cell in CELLS:
        assert any(applies(m, cell) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads_by_name(cell):
    c = load_cell(cell, 2 ** 31 + 12345)
    assert c.cfg.seed == 2 ** 31 + 12345 and c.replicas >= 1 and c.chips in (1, 4)
    assert set(c.limits) == set(check.NAMES)
    assert {m["name"] for m in c.end_to_end} == {"particle_steps_per_s", "cycle_ms_p95", "setup_s"}
    for m in c.end_to_end + c.per_layer:
        assert callable(reader(m["name"]))


def test_configs_as_published():
    """Each configuration file holds its example's values but for the keys
    ``reduced`` names (and the seed, which each run's --seed replaces)."""
    published = {"bl5_n62500_f32": "n62500_large.json"}
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"ljbench/configs/{c['name']}.json" and (ROOT / c["file"]).is_file()
        mine = json.loads((ROOT / c["file"]).read_text())
        theirs = json.loads((ROOT / "examples" / published[c["name"]]).read_text())
        for key, value in theirs.items():
            if key in c["reduced"] or key == "seed":
                continue
            assert mine[key] == value, key
        cfg = load_config(c["name"], 7)
        assert cfg.dtype == "float32" and abs(cfg.density - 0.8442) < 1e-6 and abs(cfg.rc - 2.5) < 1e-9


def test_every_file_under_the_folder_is_named_by_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
