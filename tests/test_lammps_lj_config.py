"""LAMMPS's LJ benchmark (``bench/in.lj``) at x = y = z = 2 as the port runs
it: the benchmark's configuration (``ljbench/configs/lammps_lj_256k_f32.json``),
the published run (``examples/lammps_lj_256k.json``) and its geometry hold
together, on the CPU.
"""

import dataclasses
import json
import math
import os

import pytest
import torch

from ljbench.reference import lj
from ljbench.spec import load_cell, load_config
from ljmd_tpu_torch.config import load_config as load_example
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops.cell_list import capacity_from_state, make_pencil_grid, pencil_capacity

ROOT = os.path.join(os.path.dirname(__file__), "..")
NAME = "lammps_lj_256k_f32"
SPACING = (4.0 / 0.8442) ** (1.0 / 3.0)  # in.lj's lattice fcc 0.8442


@pytest.fixture(scope="module")
def cfg():
    return load_config(NAME, 87287)


def test_config_and_example_are_one_run(cfg):
    """Every field of the published run equals the benchmark's (the seed is
    the source's 87287, which a run's --seed replaces)."""
    example = load_example(os.path.join(ROOT, "examples", "lammps_lj_256k.json"))
    for f in dataclasses.fields(cfg):
        assert getattr(example, f.name) == getattr(cfg, f.name), f.name


def test_geometry_of_in_lj_at_256k(cfg):
    """40^3 FCC cells at rho* 0.8442: N = 256,000, L = 67.1838, rc 2.5 with
    no tail correction, skin 0.3, dt 0.005, float32, no warmup; 23 x 23
    pencils of 2.921 (half slack 0.2105); the lattice's xy columns bunch to
    360-640 a pencil, so its census (and the static rule) gives capacity
    768; ``auto`` picks the cell-pair engine on a card."""
    assert cfg.n == 256_000 and cfg.num_cells == 40
    assert cfg.box_length == pytest.approx(40 * SPACING, rel=1e-14)
    assert cfg.rc == pytest.approx(2.5, rel=1e-14) and cfg.density == pytest.approx(0.8442)
    assert (cfg.neighbor_skin, cfg.dt, cfg.dtype, cfg.warmup_steps) == (0.3, 0.005, "float32", 0)
    assert not cfg.use_tail_corrections
    r_list = cfg.rc + cfg.neighbor_skin
    grid = make_pencil_grid(cfg.n, cfg.box_length, r_list, cfg.density)
    assert grid.m_xy == 23
    assert 0.5 * (grid.pencil_width - cfg.rc) == pytest.approx(0.21052, abs=1e-5)
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64)
    assert capacity_from_state(cfg.box_length, r_list, r) == 768
    assert pencil_capacity(cfg.n, cfg.density, cfg.box_length, grid.m_xy) == 768
    assert pe.auto_backend(cfg, True, 50) == "cellpair"


def test_target_energy_is_the_lattice_at_t_1_44(cfg):
    """U an atom at the lattice by the plain reference (minimum image, rc
    2.5, no tail) at k = 6, which any k >= 3 shares: -6.7734; the target is
    N U + 1.5 (N - 1) 1.44 (LAMMPS's 3N - 3 degrees of freedom)."""
    k = 6
    L = k * SPACING
    r = fcc_lattice(k, L, dtype=torch.float64)[None]
    _, obs, _ = lj.state_observables(r, torch.zeros_like(r), L, 2.5, L ** 3, tail=False)
    u = float(obs[0, 0]) / r.shape[1]
    assert u == pytest.approx(-6.7734, abs=5e-5)
    assert cfg.target_total_energy == pytest.approx(cfg.n * u + 1.5 * (cfg.n - 1) * 1.44,
                                                    abs=0.01)


def test_benchmark_names_the_configuration_and_its_cuts():
    """``BENCHMARK.json`` names the file, its source and the keys cut from
    it (the scale and the run length); the cell runs it one system at a
    time, sampled every 50 steps."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next(c for c in bench["configs"] if c["name"] == NAME)
    assert entry["file"] == f"ljbench/configs/{NAME}.json"
    assert entry["reduced"] == ["num_cells", "total_steps"]
    assert "in.lj" in entry["source"] and "Speed_bench" in entry["source"]
    cell = load_cell("lj256k.single.i50", 3)
    assert (cell.replicas, cell.chips, cell.cfg.output_interval) == (1, 1, 50)
    assert cell.cfg.n == 256_000 and math.isclose(cell.cfg.box_length, 67.1838476553003)
