"""The plan rules of the full 9-neighbour pencil sweep (kernel 11) and of the
rect-Newton hop (kernel 7), as plain torch on the CPU, float64:

- ``full_stage_plan`` (each 128-slot i-slice's 9 neighbours and the partner
  stages below each partner's count) against a brute-force listing on a 4x4
  pencil grid at capacities 256 and 384, with an emptied pencil, a short one
  (under 128 slots) and one at capacity;
- the full sweep's twin, which runs through that plan, against the JAX
  package's ``pallas_pencil_sweep`` in interpret mode, with sentinels, one
  pencil emptied and one cut under 128 slots (the test asserts that stages
  were skipped), observables on and off;
- ``rect_newton_blocks`` (the live blocks of both roles, the kernel's rule,
  whose count the card tests hold the kernel's plan to) against a
  brute-force test of every block, over ranges with ``i_lo`` on and off a
  tile boundary, ``j_hi = 0``, ``i_lo = n_i`` and the d=4 gated half hop;
- the rect-Newton twin over the active range against the JAX
  package's ``pallas_pair_sweep_rect_newton`` in interpret mode on the row
  blocks of a jittered FCC lattice cut into 4 ranks, in lattice order (a
  rank's rows are a slab: blocks 0 and 2 lie farther apart than the cutoff)
  and shuffled, at the full hop and both sides of the gated half hop.

Inputs are made with numpy from seeds. Tolerances: the sweep rtol 1e-10 /
atol 1e-12 of each row's scale (tests/test_zband.py:79, as
tests/test_torch_pencil_full.py uses them), the rect-Newton twin rtol = atol
= 1e-9 (tests/test_torch_rect.py's): the pair arithmetic is the same and
only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_lj as jpl
from ljmd_tpu.ops import pallas_pencil as jpp
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import pair_sweep as prs
from ljmd_tpu_torch.ops import pencil_sweep as pps

torch.set_num_threads(1)

N, L, R_LIST, RC2 = 2048, 13.4, 2.9, 6.25
SWEEP_RTOL, SWEEP_ATOL = 1e-10, 1e-12


def _counts(p, cap, seed):
    """Per-pencil counts with an empty (1), a short (2: 77 slots), a full
    (3) and random pencils."""
    cnt = np.random.default_rng(seed).integers(1, cap + 1, size=p)
    cnt[1], cnt[2], cnt[3] = 0, 77, cap
    return cnt


@pytest.mark.parametrize("cap", [256, 384])
def test_full_stage_plan_matches_brute_force(cap):
    m, n_sub = 4, cap // 128
    tbl = pcl.PencilGrid(m_xy=m, capacity=cap, box_length=L).neighbor_table().reshape(-1)
    cnt = _counts(m * m, cap, seed=cap)
    plan = pps.full_stage_plan(torch.as_tensor(cnt), torch.as_tensor(tbl), m * m, cap)
    t9 = tbl.reshape(m * m, 9)
    stages = kept = 0
    for q in range(m * m):
        for b in range(n_sub):
            t = q * n_sub + b
            live = b * 128 < cnt[q]
            assert bool(plan["item_live"][t]) == live
            for k in range(9):
                j = int(t9[q, k])
                assert int(plan["pencil"][t, k]) == j
                for c in range(n_sub):
                    assert int(plan["start"][t, k, c]) == j * cap + c * 128
                    want = live and cnt[j] > 0 and c * 128 < cnt[j]
                    assert bool(plan["keep"][t, k, c]) == want
                    stages += live and cnt[j] > 0
                    kept += want
    assert (plan["stages"], plan["kept"]) == (stages, kept)
    assert plan["past_count"] == stages - kept > 0
    assert plan["items"] == sum(-(-int(c) // 128) for c in cnt)


@pytest.fixture(scope="module")
def slots():
    """tests/test_torch_pencil_full.py's jittered lattice (N=2048, L=13.4,
    4x4 pencils of capacity 256) binned by JAX, pencil 1 emptied and pencil
    2 cut to 77 slots (slots stay packed rank-first), sentinels in every
    empty slot."""
    rng = np.random.default_rng(3)
    r = (np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64)) + rng.normal(0, 0.05, (N, 3))) % L
    jgrid = jcl.make_pencil_grid(N, L, R_LIST, N / L**3)
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns, cap = jgrid.n_slots, jgrid.capacity
    r8 = np.array(jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns])
    valid = np.array(jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns])
    pencil, rank = np.arange(ns) // cap, np.arange(ns) % cap
    valid[(pencil == 1) | ((pencil == 2) & (rank >= 77))] = 0.0
    r8[3] = valid
    r8 = np.array(jp2.sentinel_fill(jnp.asarray(r8), jnp.asarray(valid), cap))
    counts = valid.reshape(jgrid.n_pencils, cap).sum(1).astype(np.int32)
    assert counts[1] == 0 and counts[2] == 77
    return jgrid, pcl.make_pencil_grid(N, L, R_LIST, N / L**3), r8, counts


@pytest.mark.parametrize("want_obs", [True, False])
def test_full_sweep_twin_with_skips_matches_pallas(slots, want_obs):
    jgrid, pgrid, r8, counts = slots
    tbl = torch.as_tensor(pps.build_tile_table(pgrid))
    plan = pps.full_stage_plan(torch.as_tensor(counts), tbl, pgrid.n_pencils, pgrid.capacity)
    assert plan["past_count"] > 0 and plan["items"] < pgrid.n_slots // 128
    want = np.asarray(jpp.pallas_pencil_sweep(
        jnp.asarray(r8), jnp.asarray(jpp.build_tile_table(jgrid)), jnp.asarray(counts), jgrid,
        RC2, interpret=True, want_observables=want_obs))
    got = pps.pencil_sweep(torch.as_tensor(r8), tbl, torch.as_tensor(counts),
                           torch.as_tensor(pps.build_shift_table(pgrid)), pgrid, RC2,
                           want_obs).numpy()
    for row in range(8):
        err = float(np.abs(got[row] - want[row]).max())
        assert err <= SWEEP_ATOL + SWEEP_RTOL * float(np.abs(want[row]).max()), (row, err)
    assert not np.any(got[:, r8[3] == 0]), "invalid slots must be exactly zero"


# (n_i, n_j, i_lo, j_hi): full ranges, i_lo on and off a tile boundary, the
# gated half hop's two sides at d=4 (1000 a rank), j_hi = 0, i_lo = n_i,
# unequal blocks.
RANGES = [(200, 200, 0, 200), (200, 200, 64, 200), (200, 200, 77, 131), (1000, 1000, 500, 1000),
          (1000, 1000, 0, 500), (200, 200, 0, 0), (200, 200, 200, 200), (130, 250, 129, 1)]


@pytest.mark.parametrize("tile", [1, 8, 32, 64])
@pytest.mark.parametrize("rng_", RANGES, ids=[f"{a}x{b}_{c}_{d}" for a, b, c, d in RANGES])
def test_rect_newton_blocks_match_brute_force(rng_, tile):
    n_i, n_j, i_lo, j_hi = rng_
    got_i, got_j = prs.rect_newton_blocks(n_i, n_j, i_lo, j_hi, tile)

    def brute(n_rows, lo, hi, p_lo, p_hi):
        pad = -(-n_rows // 128) * 128
        return [b for b in range(pad // tile)
                if p_lo < p_hi and any(lo <= i < hi for i in range(b * tile, (b + 1) * tile))]

    assert got_i.tolist() == brute(n_i, i_lo, n_i, 0, j_hi)
    assert got_j.tolist() == brute(n_j, 0, j_hi, i_lo, n_i)


def test_rect_newton_refuses_ranges_outside_the_rows():
    pos = torch.zeros((8, 128), dtype=torch.float64)
    for i_lo, j_hi in ((-1, 100), (101, 100), (0, 101), (0, -1)):
        with pytest.raises(ValueError, match="active range"):
            prs.pair_sweep_rect_newton(pos, pos, 100, 100, 0, 100, L, RC2, i_lo, j_hi)


@pytest.fixture(scope="module")
def rank_blocks():
    """The jittered N=2048 lattice (L=13.4) in its own order and shuffled,
    each cut into 4 ranks of 512 rows, as (8, 512) numpy blocks."""
    rng = np.random.default_rng(11)
    r = (np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64)) + rng.normal(0, 0.05, (N, 3))) % L
    out = {}
    for order, x in (("lattice", r), ("shuffled", r[np.random.default_rng(5).permutation(N)])):
        blocks = []
        for s in range(4):
            b = np.zeros((8, 512))
            b[0:3] = x[s * 512:(s + 1) * 512].T
            blocks.append(b)
        out[order] = blocks
    return out


# (name, j block, i_lo, j_hi): the full hop from rank 1 and the two sides of
# the gated half hop between blocks 0 and 2 (d=4).
HOPS = [("hop", 1, 0, 512), ("half_low", 2, 256, 512), ("half_high", 2, 0, 256)]


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("order", ["lattice", "shuffled"])
@pytest.mark.parametrize("hop", HOPS, ids=[h[0] for h in HOPS])
def test_rect_newton_twin_on_rank_blocks_matches_pallas(rank_blocks, hop, order, want_obs):
    _, jb, i_lo, j_hi = hop
    blocks = rank_blocks[order]
    pos_i, pos_j = (blocks[0], blocks[jb]) if hop[0] != "half_high" else (blocks[jb], blocks[0])
    gi0, gj0 = (0, jb * 512) if hop[0] != "half_high" else (jb * 512, 0)
    want_i, want_j = jpl.pallas_pair_sweep_rect_newton(
        jnp.asarray(pos_i), jnp.asarray(pos_j), 512, 512, gi0, gj0, L, RC2, i_lo=i_lo,
        j_hi=j_hi, tile_i=128, tile_j=128, interpret=True, want_observables=want_obs)
    got_i, got_j = prs.pair_sweep_rect_newton(torch.as_tensor(pos_i), torch.as_tensor(pos_j), 512,
                                              512, gi0, gj0, L, RC2, i_lo, j_hi, want_obs)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=1e-9, atol=1e-9)
    assert not np.any(got_j.numpy()[3:]), "acc_j rows 3..7 must be exactly 0"
    apart = order == "lattice" and hop[0] != "hop"
    assert apart == (not np.any(got_i.numpy()[0:3])), "slabs 0 and 2 lie apart in lattice order"
