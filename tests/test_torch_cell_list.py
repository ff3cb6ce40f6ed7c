"""The port's pencil binning (``ljmd_tpu_torch/ops/cell_list.py``), the
half-shell tables and sentinels (``ops/pencil_sweep.py``), the width lists
(``ops/fused_pencil.py``) and the pencil-carry conversion, against the JAX
package on the CPU. None of these reaches a Pallas kernel, and every
comparison is exact: they are integer layouts and sorts.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu.ops import pallas_pencil_fused as jpf
from ljmd_tpu_torch.config import SimConfig, load_config
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import fused_pencil as pfp
from ljmd_tpu_torch.ops import pencil_sweep as pps
from ljmd_tpu_torch.state import MDState
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")

# (n, L, r_list, positions): tests/test_cellpair.py's N=500 box (3x3 pencils)
# with uniform positions, and tests/test_pencil_fused.py's jittered lattice
# (4x4 pencils, capacity 256).
GEOMS = {
    "n500_uniform": (500, 9.1, 2.9, "uniform"),
    "n2048_lattice": (2048, 13.4, 2.9, "lattice"),
}


def _positions(n, L, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, L, (n, 3))
    k = round((n / 4) ** (1 / 3))
    r = np.asarray(j_fcc_lattice(k, L, dtype=jnp.float64))
    return (r + rng.normal(0, 0.05, size=(n, 3))) % L


def _grids(n, L, r_list):
    return jcl.make_pencil_grid(n, L, r_list, n / L**3), pcl.make_pencil_grid(n, L, r_list, n / L**3)


def _slot_rows(r, jgrid):
    """JAX slot layout of (N, 3) positions: rows, validity, ids, sentinels."""
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns = jgrid.n_slots
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    ids = jnp.zeros((ns + 1,)).at[slot].set(jnp.arange(r.shape[0], dtype=r8.dtype))[:ns]
    r8 = r8.at[3].set(valid).at[4].set(ids)
    return np.array(jp2.sentinel_fill(r8, valid, jgrid.capacity))


@pytest.mark.parametrize("geom", list(GEOMS))
def test_bin_to_slots_matches_jax(geom):
    n, L, r_list, kind = GEOMS[geom]
    jgrid, pgrid = _grids(n, L, r_list)
    assert (pgrid.m_xy, pgrid.capacity, pgrid.n_slots) == (jgrid.m_xy, jgrid.capacity,
                                                           jgrid.n_slots)
    r = _positions(n, L, kind, 1)
    want, wovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    got, govf = pcl.bin_to_slots(torch.as_tensor(r), pgrid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool(govf) == bool(wovf) is False
    # a pencil past its capacity overflows in both
    r1 = r.copy()
    r1[: pgrid.capacity + 1, :2] = 0.5
    assert bool(pcl.bin_to_slots(torch.as_tensor(r1), pgrid)[1])
    assert bool(jcl.bin_to_slots(jnp.asarray(r1), jgrid)[1])


@pytest.mark.parametrize("moves", ["scattered", "crowded"])
@pytest.mark.parametrize("geom", list(GEOMS))
def test_rebin_gather_matches_jax(geom, moves):
    """The rebin's order, sources and validity, exactly; positions moved off
    their bins first so that the permutation is not the identity. In the
    crowded case one pencil receives more particles than its capacity, so
    both packages must drop the same victims and set overflow."""
    n, L, r_list, kind = GEOMS[geom]
    jgrid, pgrid = _grids(n, L, r_list)
    r8 = _slot_rows(_positions(n, L, kind, 2), jgrid)
    rng = np.random.default_rng(3)
    r8[0:3] = np.where(r8[3] > 0.5, (r8[0:3] + rng.normal(0, 0.7, r8[0:3].shape)) % L, r8[0:3])
    if moves == "crowded":
        movers = np.flatnonzero(r8[3] > 0.5)[: pgrid.capacity + 3]
        r8[0:2, movers] = 0.25 * L / pgrid.m_xy
    want = jcl.rebin_gather_parts(jnp.asarray(r8), jnp.asarray(r8[3]), jgrid, z_order=False)
    got = pcl.rebin_gather_parts(torch.as_tensor(r8), torch.as_tensor(r8[3]), pgrid)
    assert bool(got[3]) == bool(want[3]) == (moves == "crowded")
    for g, w, name in zip(got, want, ("order", "src", "valid_new", "overflow")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    w_old, w_valid, _ = jcl.rebin_gather(jnp.asarray(r8), jnp.asarray(r8[3]), jgrid,
                                         z_order=False)
    g_old, g_valid, _ = pcl.rebin_gather(torch.as_tensor(r8), torch.as_tensor(r8[3]), pgrid)
    np.testing.assert_array_equal(g_old.numpy(), np.asarray(w_old))
    np.testing.assert_array_equal(g_valid.numpy(), np.asarray(w_valid))


def test_pencil_capacity_and_census_match_jax():
    """pencil_capacity (with its FCC lattice bound), capacity_from_state and
    make_pencil_grid at BASELINE config 5 and small boxes."""
    n62500 = load_config(os.path.join(EXAMPLES, "n62500_large.json"))
    r_list = n62500.rc + n62500.neighbor_skin
    for n, L, m in ((62500, n62500.box_length, 14), (65536, 42.66, 14), (500, 9.1, 3),
                    (2048, 13.4, 4), (864, 10.0776, 3)):
        assert pcl.pencil_capacity(n, 0.8, L, m) == jcl.pencil_capacity(n, 0.8, L, m)
    grid = pcl.make_pencil_grid(n62500.n, n62500.box_length, r_list, n62500.density)
    assert grid.m_xy == 14 and grid.n_pencils == 196
    want = jcl.make_pencil_grid(n62500.n, n62500.box_length, r_list, n62500.density)
    assert (grid.m_xy, grid.capacity) == (want.m_xy, want.capacity)
    rng = np.random.default_rng(11)
    for pos in (rng.uniform(0, 12.0, (600, 3)), np.full((600, 3), 0.5),
                _positions(2048, 13.4, "lattice", 4)):
        L = 13.4 if pos.shape[0] == 2048 else 12.0
        want = jcl.capacity_from_state(L, 3.0, pos)
        assert pcl.capacity_from_state(L, 3.0, torch.as_tensor(pos)) == want
        assert pcl.capacity_from_state(L, 3.0, pos) == want
    with pytest.raises(ValueError, match="pencils"):
        pcl.make_pencil_grid(32, 5.0, 2.9, 0.5)


@pytest.mark.parametrize("geom", list(GEOMS))
def test_tables_and_sentinels_match_jax(geom):
    n, L, r_list, kind = GEOMS[geom]
    jgrid, pgrid = _grids(n, L, r_list)
    for got, want in zip(pps.build_half_shell_tables(pgrid), jp2.build_half_shell_tables(jgrid)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    r8 = _slot_rows(_positions(n, L, kind, 5), jgrid)
    raw = r8.copy()
    raw[0:3] = np.where(r8[3] > 0.5, r8[0:3], 7.0)
    got = pps.sentinel_fill(torch.as_tensor(raw), torch.as_tensor(raw[3]), pgrid.capacity)
    want = jp2.sentinel_fill(jnp.asarray(raw), jnp.asarray(raw[3]), jgrid.capacity)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got32 = pps.sentinel_fill(torch.as_tensor(raw, dtype=torch.float32),
                              torch.as_tensor(raw[3], dtype=torch.float32), pgrid.capacity)
    np.testing.assert_array_equal(got32.numpy(), np.asarray(want).astype(np.float32))


COUNT_CASES = {
    # tests/test_pencil_fused.py's synthetic counts: empty, full, 128, 129
    "synthetic_4x4_c256": (4, 256, "synthetic"),
    # BASELINE config 5's grid at the census capacity 512 and at 384
    "config5_c512": (14, 512, "fluid"),
    "config5_c384": (14, 384, "fluid"),
    "n500_3x3_c128": (3, 128, "fluid"),
}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_build_width_lists_equal_jax_element_for_element(case):
    m, cap, kind = COUNT_CASES[case]
    grid = pcl.PencilGrid(m_xy=m, capacity=cap, box_length=3.0 * m)
    P = grid.n_pencils
    rng = np.random.default_rng(m * cap)
    if kind == "synthetic":
        counts = rng.integers(0, cap + 1, size=P).astype(np.int32)
        counts[:4] = (0, cap, 128, 129)
    else:
        counts = np.clip(rng.normal(0.62 * cap, 0.06 * cap, P), 0, cap).astype(np.int32)
        counts[0] = 0
    tbl, shf = pps.build_half_shell_tables(grid)
    want = jpf.build_width_lists(jnp.asarray(counts), jnp.asarray(tbl), jnp.asarray(shf), P, cap)
    got = pfp.build_width_lists(torch.as_tensor(counts), torch.as_tensor(tbl),
                                torch.as_tensor(shf), P, cap)
    for g, w, name in zip(got, want, ("wl_self", "wl_self_cnt", "wl_nbr_i", "wl_nbr_j",
                                      "wl_nbr_off")):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_pencil_carry_conversion_round_trip():
    cfg = SimConfig(num_cells=5, box_length=9.1, rc_over_box=2.5 / 9.1, dtype="float64",
                    target_total_energy=-2000.0)
    eng = pe._cellpair_engine(cfg, "cpu", width_lists=True)
    r = torch.as_tensor(_positions(500, 9.1, "uniform", 6))
    c, _ = eng.init(MDState(r=r, ru=r, v=torch.zeros_like(r), a=torch.zeros_like(r)))
    arrays = convert.pencil_carry_to_numpy(c)
    assert set(arrays) == set(convert.PENCIL_FIELDS) and len(convert.PENCIL_FIELDS) == 18
    back = convert.pencil_carry_from_numpy(arrays)
    for k in convert.PENCIL_FIELDS:
        assert torch.equal(getattr(back, k), getattr(c, k)), k
    assert back.counts.dtype == torch.int32 and back.overflow.dtype == torch.bool
    assert back.wl_nbr_j.dtype == torch.int32
    with pytest.raises(ValueError, match="rows"):
        convert.pencil_carry_from_numpy({**arrays, "v": arrays["v"][0:3]})
