"""The launch rule of the row-sweep kernel that runs the tri sweep (kernel 2)
and the ring's rect sweep (kernel 6), as plain Python on the CPU, and both
twins against the JAX package's Pallas kernels at a rank's shapes, float64:

- ``rows_sweep_slices`` (S, the threads a row) at the main path's shapes on
  an H100's 132 SMs at 3 blocks an SM: N=4000 -> 16, the 1000-row self block
  and the 1000 x 1000 hop -> 64, the 2000 x 2000 hop -> 32, 250 rows and
  N=500 -> 128, N=864 -> 64; the smallest S where the rows are far larger
  than the card; and the rule against a brute-force search over S;
- the ordered sweep's S (kernel 5 runs the rect sweep's kernel with i = j):
  N=4000 -> 16, N=864 -> 64, N=500 -> 128, through the same rule;
- ``rows_sweep_blocks`` (the live blocks) against a brute-force test of
  every block of the padded rows;
- the tri twin against ``pallas_pair_sweep_tri`` in interpret mode on a
  250-row self block (rank 0 of the N=500 box over 2 ranks), and the rect
  twin against ``pallas_pair_sweep_rect`` at the 2-rank hop and self offset,
  on rank blocks of a jittered FCC lattice in its own order and shuffled,
  observables on and off; the ordered twin against ``pallas_pair_sweep``
  on the whole N=500 box.

Tolerances rtol = atol = 1e-9 (tests/test_torch_rect.py's): the pair
arithmetic is the same and only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import pallas_lj as jpl
from ljmd_tpu_torch.ops import pair_sweep as prs

torch.set_num_threads(1)

SMS, PER_SM = 132, 3

# (rows, partners, S): the tri sweep at N=4000, 864 and 500 and the 1000- and
# 250-row self blocks; the rect sweep's 1000 x 1000 and 2000 x 2000 hops.
MAIN_PATH = [(4000, 4000, 16), (864, 864, 64), (500, 500, 128), (1000, 1000, 64),
             (250, 250, 128), (2000, 2000, 32)]


@pytest.mark.parametrize("per_sm", [PER_SM, 8])
@pytest.mark.parametrize("case", MAIN_PATH, ids=[f"{a}x{b}" for a, b, _ in MAIN_PATH])
def test_rows_sweep_slices_at_the_main_path_shapes(case, per_sm):
    """A card that holds more than 3 resident blocks an SM is capped at 3."""
    n_rows, n_cols, want = case
    s = prs.rows_sweep_slices(n_rows, n_cols, per_sm, SMS)
    assert s == want
    assert prs.rows_sweep_blocks(n_rows, n_cols, 256 // s) <= PER_SM * SMS


# The ordered sweep (kernel 5) over whole boxes: N rows against themselves.
ORDERED = [(4000, 16), (864, 64), (500, 128)]


@pytest.mark.parametrize("per_sm", [PER_SM, 8])
@pytest.mark.parametrize("case", ORDERED, ids=[f"N={n}" for n, _ in ORDERED])
def test_ordered_sweep_slices_at_the_main_path_shapes(case, per_sm):
    """``pair_sweep_plan`` asks the rect rule with the rows as their own
    partners; the tri sweep (kernel 2) gets the same S, so their forces are
    summed in one order."""
    n, want = case
    assert prs.rows_sweep_slices(n, n, per_sm, SMS) == want
    assert prs.rows_sweep_blocks(n, n, 256 // want) <= PER_SM * SMS


@pytest.mark.parametrize("case", [(10**6, 10**6, 4), (200_000, 50, 4), (1000, 20, 16),
                                  (0, 0, 4), (100, 0, 4), (8000, 8000, 8)])
def test_rows_sweep_slices_edges(case):
    """Rows far larger than the card take the smallest S; a short partner
    range caps S (a partner a thread); 8000 rows no longer fit S = 16."""
    n_rows, n_cols, want = case
    assert prs.rows_sweep_slices(n_rows, n_cols, PER_SM, SMS) == want


@pytest.mark.parametrize("sms,per_sm", [(SMS, PER_SM), (16, 1)])
def test_rows_sweep_slices_is_the_largest_fitting_power_of_two(sms, per_sm):
    def brute_live(n_rows, n_cols, tile):
        pad = max(128, -(-n_rows // 128) * 128)
        return sum(1 for b in range(pad // tile)
                   if n_cols > 0 and any(i < n_rows for i in range(b * tile, (b + 1) * tile)))

    for n in range(0, 6200, 97):
        for n_cols in (n, max(0, n // 3)):
            fits = [s for s in (4, 8, 16, 32, 64, 128)
                    if brute_live(n, n_cols, 256 // s) <= per_sm * sms and n_cols >= s]
            assert prs.rows_sweep_slices(n, n_cols, per_sm, sms) == max(fits, default=4), n


@pytest.mark.parametrize("tile", [2, 16, 64])
@pytest.mark.parametrize("shape", [(250, 250), (1000, 1000), (130, 250), (128, 1), (77, 0)])
def test_rows_sweep_blocks_match_brute_force(shape, tile):
    n_rows, n_cols = shape
    pad = -(-n_rows // 128) * 128
    want = [b for b in range(pad // tile)
            if n_cols > 0 and any(i < n_rows for i in range(b * tile, (b + 1) * tile))]
    assert prs.rows_sweep_blocks(n_rows, n_cols, tile) == len(want)


# The N=500 reference box (L=10, rc=4.9) over 2 ranks: 250 rows a rank.
L, RC2, N, NI = 10.0, 4.9 * 4.9, 500, 250


@pytest.fixture(scope="module")
def rank_blocks():
    """The jittered N=500 lattice in its own order and shuffled, each cut
    into 2 ranks of 250 rows, as (8, 256) numpy blocks."""
    rng = np.random.default_rng(17)
    r = (np.asarray(j_fcc_lattice(5, L, dtype=jnp.float64)) + rng.normal(0, 0.05, (N, 3))) % L
    out = {}
    for order, x in (("lattice", r), ("shuffled", r[np.random.default_rng(7).permutation(N)])):
        blocks = []
        for s in range(2):
            b = np.zeros((8, 256))
            b[0:3, :NI] = x[s * NI:(s + 1) * NI].T
            blocks.append(b)
        out[order] = blocks
    return out


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("order", ["lattice", "shuffled"])
def test_tri_twin_on_a_self_block_matches_pallas(rank_blocks, order, want_obs):
    pos = rank_blocks[order][0]
    want = np.asarray(jpl.pallas_pair_sweep_tri(jnp.asarray(pos), NI, L, RC2, tile_i=128,
                                                tile_j=128, interpret=True,
                                                want_observables=want_obs))
    got = prs.pair_sweep_tri(torch.as_tensor(pos), NI, L, RC2, want_observables=want_obs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert not np.any(got[6:]) and not np.any(got[:, NI:])
    assert np.any(got[3]) == want_obs


# (name, i block, j block): rank 1's self offset and its hop to block 0.
HOPS = [("self", 1, 1), ("hop", 1, 0)]


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("order", ["lattice", "shuffled"])
@pytest.mark.parametrize("hop", HOPS, ids=[h[0] for h in HOPS])
def test_rect_twin_on_rank_blocks_matches_pallas(rank_blocks, hop, order, want_obs):
    _, si, sj = hop
    pos_i, pos_j = rank_blocks[order][si], rank_blocks[order][sj]
    want = np.asarray(jpl.pallas_pair_sweep_rect(
        jnp.asarray(pos_i), jnp.asarray(pos_j), NI, NI, si * NI, sj * NI, L, RC2, tile_i=128,
        tile_j=128, interpret=True, want_observables=want_obs))
    got = prs.pair_sweep_rect(torch.as_tensor(pos_i), torch.as_tensor(pos_j), NI, NI, si * NI,
                              sj * NI, L, RC2, want_obs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert not np.any(got[6:]) and not np.any(got[:, NI:])
    assert np.any(got[0:3])


@pytest.fixture(scope="module")
def n500_box():
    """The whole jittered N=500 lattice (L=10, rc=4.9) as (8, 512) rows."""
    rng = np.random.default_rng(19)
    r = (np.asarray(j_fcc_lattice(5, L, dtype=jnp.float64)) + rng.normal(0, 0.05, (N, 3))) % L
    pos = np.zeros((8, 512))
    pos[0:3, :N] = r.T
    return pos


@pytest.mark.parametrize("want_obs", [True, False])
def test_ordered_twin_on_the_n500_box_matches_pallas(n500_box, want_obs):
    """Kernel 5's twin at the reference box, every row against
    ``pallas_pair_sweep`` in interpret mode; rows 0..2 equal the tri twin's
    and rows 3..5 sum twice its pair-once totals."""
    want = np.asarray(jpl.pallas_pair_sweep(jnp.asarray(n500_box), N, L, RC2, tile_i=128,
                                            tile_j=128, interpret=True,
                                            want_observables=want_obs))
    pos = torch.as_tensor(n500_box)
    got = prs.pair_sweep(pos, N, L, RC2, want_observables=want_obs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert not np.any(got[6:]) and not np.any(got[:, N:])
    assert np.any(got[3]) == want_obs
    tri = prs.pair_sweep_tri(pos, N, L, RC2, want_observables=want_obs).numpy()
    np.testing.assert_allclose(got[0:3], tri[0:3], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got[3:6].sum(1), 2 * tri[3:6].sum(1), rtol=1e-9, atol=1e-9)
