"""The twins of the multi-device path's kernels against the JAX package's
Pallas kernels in interpret mode, float64 on the CPU:

- ``pair_sweep_rect_plain`` / ``pair_sweep_rect_newton_plain``
  (``ops/pair_sweep.py``) against ``pallas_pair_sweep_rect`` /
  ``pallas_pair_sweep_rect_newton``: the self block (gi0 == gj0), a hop
  between blocks, blocks of unequal size whose padding is not a tile
  multiple, the gated half hop from both of its ranks, observables on and
  off;
- ``pencil_sweep_hs_plain(n_pencils_i=...)`` (``ops/pencil_sweep.py``)
  against ``pallas_pencil_sweep_mono(n_pencils_i=...)`` on a strip plus its
  halo, the strips of both ranks of a 2-rank split.

Inputs are jittered FCC lattices from a numpy seed. The tolerances are
tests/test_pallas_lj.py's (rtol = atol = 1e-9) for the rect sweeps and
tests/test_torch_pencil.py's (1e-12 of each row's scale) for the strip: the
pair arithmetic is the same and only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_lj as jpl
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu.parallel import spatial_pencil as jsp
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import pair_sweep as pps
from ljmd_tpu_torch.ops import pencil_sweep as pen
from ljmd_tpu_torch.parallel import spatial_pencil as psp

torch.set_num_threads(1)

L, RC2 = 6.8, 6.25


@pytest.fixture(scope="module")
def blocks():
    """A jittered N=256 FCC fluid (L=6.8) as two (8, pad) row blocks of the
    first 100 and the next 156 particles, in numpy."""
    rng = np.random.default_rng(11)
    r = np.asarray(j_fcc_lattice(4, L, dtype=jnp.float64))
    r = (r + rng.normal(0, 0.06, r.shape)) % L

    def rows(x, pad):
        out = np.zeros((8, pad))
        out[0:3, :len(x)] = x.T
        return out

    return rows(r[:100], 128), rows(r[100:], 256)


# (name, n_j, gi0, gj0, j block): the self block, a hop, unequal blocks.
RECT = [("self", 100, 100, 100, 0), ("hop", 100, 0, 100, 0), ("unequal", 156, 0, 100, 1)]


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("case", RECT, ids=[c[0] for c in RECT])
def test_rect_twin_matches_pallas(blocks, case, want_obs):
    _, n_j, gi0, gj0, jb = case
    pos_i, pos_j = blocks[0], blocks[jb]
    want = jpl.pallas_pair_sweep_rect(jnp.asarray(pos_i), jnp.asarray(pos_j), 100, n_j, gi0, gj0,
                                      L, RC2, tile_i=128, tile_j=128, interpret=True,
                                      want_observables=want_obs)
    got = pps.pair_sweep_rect(torch.as_tensor(pos_i), torch.as_tensor(pos_j), 100, n_j, gi0,
                              gj0, L, RC2, want_obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    assert not np.any(got.numpy()[:, 100:]) and not np.any(got.numpy()[6:])


# (name, gj0, i_lo, j_hi): the self offset, a full hop, the gated half hop
# on its low rank (i rows >= n/2) and on its high rank (j rows < n/2).
NEWTON = [("self", 0, 0, 100), ("full", 100, 0, 100), ("half_low", 100, 50, 100),
          ("half_high", 100, 0, 50)]


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("case", NEWTON, ids=[c[0] for c in NEWTON])
def test_rect_newton_twin_matches_pallas(blocks, case, want_obs):
    _, gj0, i_lo, j_hi = case
    pos_i = blocks[0]
    pos_j = pos_i if gj0 == 0 else blocks[1][:, :128].copy()
    if gj0:
        pos_j[:, 100:] = 0.0
    want_i, want_j = jpl.pallas_pair_sweep_rect_newton(
        jnp.asarray(pos_i), jnp.asarray(pos_j), 100, 100, 0, gj0, L, RC2, i_lo=i_lo,
        j_hi=j_hi, tile_i=128, tile_j=128, interpret=True, want_observables=want_obs)
    got_i, got_j = pps.pair_sweep_rect_newton(torch.as_tensor(pos_i), torch.as_tensor(pos_j),
                                              100, 100, 0, gj0, L, RC2, i_lo, j_hi, want_obs)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=1e-9, atol=1e-9)
    assert not np.any(got_j.numpy()[3:]), "acc_j rows 3..7 must be exactly 0"


N, LP, R_LIST = 2048, 13.4, 2.9


@pytest.fixture(scope="module")
def strips():
    """tests/test_torch_pencil.py's slot state (N=2048, 4x4 pencils of
    capacity 256, sentinels) cut into the two strips of a 2-rank split,
    each with its halo (the next rank's first x-column)."""
    rng = np.random.default_rng(3)
    grid = jcl.make_pencil_grid(N, LP, R_LIST, N / LP**3)
    r = np.asarray(j_fcc_lattice(8, LP, dtype=jnp.float64))
    r = (r + rng.normal(0, 0.05, size=(N, 3))) % LP
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), grid)
    assert not bool(ovf)
    ns, cap, m = grid.n_slots, grid.capacity, grid.m_xy
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    r8 = np.asarray(jp2.sentinel_fill(r8.at[3].set(valid), valid, cap))
    counts = np.array(valid.reshape(grid.n_pencils, cap).sum(1).astype(jnp.int32))
    p_loc = (m // 2) * m
    w = p_loc * cap
    out = []
    for s in range(2):
        nxt = (s + 1) % 2
        r_aug = np.concatenate([r8[:, s * w:(s + 1) * w], r8[:, nxt * w:nxt * w + m * cap]], 1)
        out.append(dict(r_aug=r_aug, counts_i=counts[s * p_loc:(s + 1) * p_loc],
                        counts_aug=np.asarray(psp.augmented_counts(torch.as_tensor(counts),
                                                                   m, 2)[s]),
                        shf=jsp._device_shift_tables(m, m // 2, 2)[s]))
    tbl = jsp._local_half_shell_table(m, m // 2)
    assert np.array_equal(tbl, psp._local_half_shell_table(m, m // 2))
    return grid, p_loc, tbl, out


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("rank", [0, 1])
def test_strip_sweep_twin_matches_mono(strips, rank, want_obs):
    """The repaired n_pencils_i: i over the strip, j over strip and halo,
    the output at the augmented matrix's full width (the halo's columns
    hold the strip's reactions)."""
    jgrid, p_loc, tbl, per_rank = strips
    s = per_rank[rank]
    want = jp2.pallas_pencil_sweep_mono(
        jnp.asarray(s["r_aug"]), jnp.asarray(tbl), jnp.asarray(s["counts_i"]),
        jnp.asarray(s["shf"]), jgrid, RC2, interpret=True, want_observables=want_obs,
        approx_reciprocal=False, n_pencils_i=p_loc) * s["r_aug"][3:4]
    pgrid = pcl.make_pencil_grid(N, LP, R_LIST, N / LP**3)
    got = pen.pencil_sweep_hs(torch.as_tensor(s["r_aug"]), torch.as_tensor(tbl),
                              torch.as_tensor(s["counts_aug"]), torch.as_tensor(s["shf"]), pgrid,
                              RC2, want_obs, n_pencils_i=p_loc)
    assert got.shape == s["r_aug"].shape
    want = np.asarray(want)
    for row in range(8):
        scale = max(1.0, float(np.abs(want[row]).max()))
        assert float(np.abs(got[row].numpy() - want[row]).max()) <= 1e-12 * scale
    assert np.any(got.numpy()[0:3, p_loc * jgrid.capacity:]), "the halo got no reactions"
