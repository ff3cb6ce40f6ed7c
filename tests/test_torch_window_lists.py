"""The zsort engine's tile flags, visit-list pack and fused list chunk
(``ljmd_tpu_torch/ops/window_lists.py``, ``ops/fused_list.py``) against the
JAX package's (``ljmd_tpu/ops/pallas_fused.py``), float64 on the CPU; the
pack also in its CUDA kernel's form (``build_window_lists_bitmask``) on
random, empty, all-active, one-a-row and band-to-the-end flags.

The JAX Pallas kernels run in interpret mode, as tests/test_tile_lists.py
and tests/test_fused.py run them. Tolerances: flags and lists are integers
and must be equal; the chunk agrees to rtol 1e-10 (the per-pair arithmetic
is the same, the summation order differs: the port sums pair-twice, the TPU
kernel scatters pair-once reactions). Inputs are made with numpy from seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.ops import pallas_fused as pf
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import fused_list, window_lists
from ljmd_tpu_torch.ops.pair_sweep import pair_forces_plain

torch.set_num_threads(1)

RC = 2.5
WINDOW = RC + 1.2 * 0.6


def _sorted_fluid(num_cells, box, n_pad, seed):
    """(n, (8, n_pad) rows) of a perturbed FCC lattice in ascending-z order."""
    rng = np.random.default_rng(seed)
    r = fcc_lattice(num_cells, box, dtype=torch.float64).numpy()
    r = np.mod(r + rng.normal(scale=0.05, size=r.shape), box)
    r = r[np.argsort(r[:, 2])]
    rows = np.zeros((8, n_pad))
    rows[0:3, :len(r)] = r.T
    return len(r), rows


def _jax_flags(rows, n, box, x_window=None, window=WINDOW, cross_margin=0.36):
    return np.asarray(pf.compute_tile_flags(jnp.asarray(rows), n, 128, 128, box, window,
                                            x_window=x_window, cross_margin=cross_margin))


def _port_flags(rows, n, box, x_window=None, window=WINDOW, cross_margin=0.36):
    return window_lists.compute_tile_flags(torch.tensor(rows), n, 128, 128, box, window,
                                           x_window=x_window,
                                           cross_margin=cross_margin).numpy()


# ---------------------------------------------------------------- flags
@pytest.mark.parametrize("x_window", [None, WINDOW], ids=["pure_z", "x_window"])
@pytest.mark.parametrize("num_cells,box,n_pad", [(6, 10.0776, 896), (10, 16.796, 4096)])
def test_compute_tile_flags_matches_jax(x_window, num_cells, box, n_pad):
    n, rows = _sorted_fluid(num_cells, box, n_pad, seed=num_cells)
    want = _jax_flags(rows, n, box, x_window)
    got = _port_flags(rows, n, box, x_window)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got & 1).sum() > 0 and (got == 0).sum() > 0


def test_compute_tile_flags_circular_padding_and_slabs():
    """tests/test_fused.py's geometries: circular gaps, padding tiles, and
    x-slabs that prune tiles whose slabs cannot interact."""
    L, n_pad, n = 10.0, 1024, 896
    rows = np.zeros((8, n_pad))
    rows[2, :n] = np.linspace(0.0, L, n, endpoint=False)
    kw = dict(window=1.0, cross_margin=None)
    got = _port_flags(rows, n, L, **kw)
    np.testing.assert_array_equal(got, _jax_flags(rows, n, L, **kw))
    f = got.reshape(8, 8)
    assert f[0, 3] == 0 and f[2, 3] == 5 and f[0, 6] == 7 and f[7].sum() == 0
    slabs = np.zeros((8, 512))
    slabs[0] = np.repeat([0.5 + 2 * k for k in range(4)], 128)
    got = _port_flags(slabs, 512, L, x_window=1.0, **kw)
    np.testing.assert_array_equal(got, _jax_flags(slabs, 512, L, x_window=1.0, **kw))
    f = got.reshape(4, 4)
    assert f[0, 1] == 0 and f[0, 0] == 7 and f[2, 2] == 3 and f[0, 3] == 0


# ---------------------------------------------------------------- pack
def _random_flags(n_pad, seed):
    n_i = n_pad // 128
    return np.random.default_rng(seed).integers(0, 8, size=(n_i * n_i,)).astype(np.int32)


def _realistic_flags(num_cells, box, n_pad, x_window=None):
    n, rows = _sorted_fluid(num_cells, box, n_pad, seed=3)
    return n, _port_flags(rows, n, box, x_window)


PACK_CASES = {
    "fluid_n864": lambda: (*_realistic_flags(6, 10.0776, 896), 896, 512),
    "fluid_n4000": lambda: (*_realistic_flags(10, 16.796, 4096), 4096, 512),
    "fluid_n4000_slab_tj768": lambda: (*_realistic_flags(10, 16.796, 4096, WINDOW), 4096, 768),
    "random_4096_tj512": lambda: (4000, _random_flags(4096, 7), 4096, 512),
    "random_512_tj512": lambda: (500, _random_flags(512, 11), 512, 512),
    "random_2048_tj384": lambda: (2048, _random_flags(2048, 23), 2048, 384),
}


def _cover_oracle(tiles, counts, n, n_pad, tj):
    """tests/test_tile_lists.py's oracle: (n_i, n_pad) count of the columns
    each i-row's visits evaluate after the padding and jmin masks; pure
    visits must lie fully above the diagonal and below n."""
    g = 128
    span = tj // g
    cover = np.zeros((n_pad // g, n_pad), dtype=int)
    n_tails = (tiles.shape[0] - 9) // 2
    for w in range(1, n_tails + 1):
        row = 9 + 2 * (w - 1)
        for k in range(counts[4 + w - 1]):
            it, sb = tiles[row, k], tiles[row + 1, k]
            assert sb * g + w * g <= n_pad
            cols = np.arange(sb * g, sb * g + w * g)
            cover[it, cols[cols < n]] += 1
    visits = []
    for cat in range(4):
        for k in range(counts[cat]):
            it, sb = tiles[2 * cat, k], tiles[2 * cat + 1, k]
            assert sb * g + tj <= n_pad
            cols = np.arange(sb * g, sb * g + tj)
            if cat == 3:
                cover[it, cols[(cols >= tiles[8, k] * g) & (cols < n)]] += 1
            else:
                assert sb * g >= (it + 1) * g and sb * g + tj <= n
                cover[it, cols] += 1
            visits.append((cat, it, sb))
    return cover, visits, span


@pytest.mark.parametrize("tail_tiles", [True, False], ids=["tails", "no_tails"])
@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_twin_matches_pallas_kernel(case, tail_tiles):
    """The twin's lists equal the Pallas kernel's element for element
    (zero_fill=True, so past the counts too), and obey the exactly-once
    coverage and round-skip contracts of tests/test_tile_lists.py."""
    n, flags, n_pad, tj = PACK_CASES[case]()
    jt, jc = pf.build_window_lists_pallas(jnp.asarray(flags), n, n_pad, 128, tj,
                                          interpret=True, zero_fill=True,
                                          tail_tiles=tail_tiles)
    tiles, counts = window_lists.build_window_lists(torch.tensor(flags), n, n_pad, 128, tj,
                                                    zero_fill=True, tail_tiles=tail_tiles)
    assert tiles.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jt))
    tiles, counts = tiles.numpy(), counts.numpy()
    cover, visits, span = _cover_oracle(tiles, counts, n, n_pad, tj)
    f2 = flags.reshape(n_pad // 128, -1)
    for it in range(f2.shape[0]):
        for b in range(f2.shape[1]):
            assert cover[it, b * 128:(b + 1) * 128].max() <= 1, (it, b, "double cover")
            if f2[it, b] > 0 and b >= it and b * 128 < n:
                real = np.arange(b * 128, min((b + 1) * 128, n))
                assert (cover[it, real] == 1).all(), (it, b, "missed")
    for cat, it, sb in visits:
        blocks = f2[it, sb:sb + span]
        live = blocks > 0
        if cat in (0, 1):
            assert not (live & ((blocks & 2) != 0)).any(), (it, sb)
        if cat == 0:
            assert not (live & ((blocks & 4) != 0)).any(), (it, sb)


def test_pack_layout_helpers():
    assert window_lists.window_max_t(4096, 128, 512) == 32 * 8
    assert window_lists.list_layout(4096, 128, 512, True) == (3, 15, 256, 7)
    assert window_lists.list_layout(4096, 128, 512, False) == (0, 9, 256, 4)
    flags = torch.tensor([0, 1, 0, 0, 0, 0, 0, 0, 5], dtype=torch.int32)
    np.testing.assert_array_equal(window_lists.row_spans(flags, 3).numpy(),
                                  [[1, 3, 2], [2, 0, 3]])
    with pytest.raises(ValueError, match="span"):
        window_lists.build_window_lists(torch.zeros(256, dtype=torch.int32), 2048, 2048,
                                        128, 9 * 128)


def _pack_pattern(name, n_b, seed):
    """(n_b * n_b,) int32 flags of one shape: random values 0..7, empty,
    all active with every round, one active block a row, or each row's
    band running from a random block to the row's end (n_b)."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n_b, n_b), dtype=np.int32)
    if name == "random":
        f = rng.integers(0, 8, size=(n_b, n_b))
    elif name == "all_active":
        f[:] = 7
    elif name == "one_a_row":
        f[np.arange(n_b), rng.integers(0, n_b, n_b)] = rng.integers(1, 8, n_b)
    elif name == "band_to_end":
        for row in range(n_b):
            f[row, rng.integers(0, n_b):] = rng.choice([1, 3, 5, 7])
    return f.reshape(-1).astype(np.int32)


PATTERNS = ["random", "empty", "all_active", "one_a_row", "band_to_end"]


@pytest.mark.parametrize("tail_tiles", [True, False], ids=["tails", "no_tails"])
@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("n_b", [7, 32, 33, 64])
def test_pack_bitmask_form_matches_twin_and_pallas(n_b, pattern, tail_tiles):
    """The CUDA kernel's form (row bitmasks walked by first set bit, a scan
    in warp order; ``build_window_lists_bitmask``) gives the sequential
    twin's lists and the Pallas kernel's (interpret mode, zero_fill=True),
    element for element, past the counts too; n < n_pad, so the padding
    masks occur, and n_b = 33 and 64 cross a 32-row warp and a mask word."""
    n_pad = 128 * n_b
    n, tj = n_pad - 50, 128 * (6 if n_b == 33 else 4)
    flags = _pack_pattern(pattern, n_b, n_b)
    got = window_lists.build_window_lists_bitmask(torch.tensor(flags), n, n_pad, 128, tj,
                                                  tail_tiles=tail_tiles)
    want = window_lists.build_window_lists_plain(torch.tensor(flags), n, n_pad, 128, tj,
                                                 tail_tiles=tail_tiles)
    jt, jc = pf.build_window_lists_pallas(jnp.asarray(flags), n, n_pad, 128, tj,
                                          interpret=True, zero_fill=True,
                                          tail_tiles=tail_tiles)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jt))
    assert (int(got[1].sum()) == 0) == (pattern == "empty")


# ---------------------------------------------------------------- chunk
@pytest.fixture(scope="module")
def chunk_inputs():
    """N=864 perturbed lattice at n_pad 896 with tile_j 256 and random block
    flags: every category (pure free / x-only / full, masked with jmin, and
    width-1 tails) occurs, which the realistic flags at this small N do not
    give (all of their visits touch the diagonal or the padding)."""
    box = 10.0776
    n, rows = _sorted_fluid(6, box, 896, seed=5)
    rng = np.random.default_rng(9)
    v = np.zeros_like(rows)
    v[0:3, :n] = rng.uniform(-1.0, 1.0, (3, n))
    a = 24.0 * pair_forces_plain(torch.tensor(rows), n, box, RC * RC).numpy()
    # compute_tile_flags values, weighted so every category occurs
    flags = np.random.default_rng(6).choice([0, 1, 3, 5, 7], p=[0.3, 0.4, 0.1, 0.1, 0.1],
                                            size=(49,)).astype(np.int32)
    tiles, counts = pf.build_window_lists_pallas(jnp.asarray(flags), n, 896, 128, 256,
                                                 interpret=True, zero_fill=True,
                                                 tail_tiles=True)
    counts_np = np.asarray(counts)
    assert (counts_np > 0).all(), counts_np
    return n, box, rows, v, a, np.asarray(tiles), counts_np


@pytest.mark.parametrize("mode", ["plain", "extended", "obs_last"])
def test_fused_list_chunk_twin_matches_jax(chunk_inputs, mode):
    n, box, rows, v, a, tiles, counts = chunk_inputs
    extended = mode.startswith("extended")
    obs_last = mode.endswith("obs_last")
    rng = np.random.default_rng(17)
    lo = rng.uniform(-1e-9, 1e-9, rows.shape) * (np.arange(896) < n) * (np.arange(8) < 3)[:, None]
    vc = rng.uniform(-1e-9, 1e-9, rows.shape) * (np.arange(896) < n) * (np.arange(8) < 3)[:, None]
    args = dict(n=n, box_length=box, rc_square=RC * RC, dt=0.004, n_steps=3, tile_i=128,
                tile_j=256, obs_last=obs_last)
    jkw = dict(r_lo=jnp.asarray(lo), vc=jnp.asarray(vc)) if extended else {}
    want = pf.fused_dense_chunk_list(jnp.asarray(rows), jnp.asarray(v), jnp.asarray(a),
                                     jnp.asarray(tiles), jnp.asarray(counts), interpret=True,
                                     j_granule=128, **args, **jkw)
    pkw = dict(r_lo=torch.tensor(lo), vc=torch.tensor(vc)) if extended else {}
    got = fused_list.fused_dense_chunk_list(torch.tensor(rows), torch.tensor(v), torch.tensor(a),
                                            torch.tensor(tiles), torch.tensor(counts),
                                            **args, **pkw)
    assert len(got) == len(want) == (5 if extended else 3) + int(obs_last)
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=1e-10 * max(1.0, np.abs(w).max()),
                                   err_msg=f"output {k}")
    if obs_last:
        obs = got[-1].numpy()
        assert np.abs(obs[3:6]).max() > 0 and not obs[[0, 1, 2, 6, 7]].any()


def test_list_coverage_is_pair_once_and_counts_every_listed_pair(chunk_inputs):
    """The twin's dense expansion: strictly upper-triangular (pair-once),
    round masks only where covered, and no pair with a padding particle."""
    n, _, _, _, _, tiles, counts = chunk_inputs
    cover, mx, mz = fused_list.list_coverage(torch.tensor(tiles), torch.tensor(counts), n,
                                             896, 128, 256)
    assert not torch.tril(cover).any()
    assert not (mx & ~cover).any() and not (mz & ~cover).any()
    assert not cover[:, n:].any() and not cover[n:].any()
    cov_oracle, _, _ = _cover_oracle(tiles, counts, n, 896, 256)
    per_row = cover.reshape(7, 128, 896).any(dim=1).numpy()
    assert ((cov_oracle > 0) >= per_row).all()
