"""The width chunk's per-block visit index (``ops/fused_pencil.py``
``width_index``), on the CPU:

- against a brute-force filter of ``width_visits``: every visit of the width
  lists that touches a 128-slot block appears in that block's entries exactly
  once, in its role (self below, self diagonal, forward, backward), with its
  partner blocks and image shift; the offsets are a CSR over the blocks and
  ``order`` ranks the blocks by partner blocks, most first. Pencil grids of
  4x4 and 5x3 (a non-square grid's half-shell tables, built here), at
  capacities 256, 384 and 512, with empty, full and 128 / 129-slot pencils;
- the width chunk's plain twin, which runs block by block through the
  index, against the JAX package's ``fused_pencil_width_chunk`` in interpret
  mode, at tests/test_torch_pencil.py's shape (N=2048 jittered FCC, L=13.4,
  4x4 pencils of capacity 256) with one pencil emptied, float64, plain and
  extended; tolerance 1e-12 of each row's scale (the pair arithmetic is the
  kernel's, only the summation order differs).

Inputs are made with numpy from a seed.
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu.ops import pallas_pencil_fused as jpf
from ljmd_tpu_torch.ops import fused_pencil as pfp
from ljmd_tpu_torch.ops import pencil_sweep as pps

torch.set_num_threads(1)

HALF_SHELL = ((0, 1), (1, -1), (1, 0), (1, 1))


def half_shell_tables(mx, my):
    """(tbl, shf) of an mx x my pencil grid (pencil ix * my + iy), the
    4 upper neighbours and their xy image shifts in units of L."""
    tbl = np.empty((mx * my, 4), dtype=np.int32)
    shf = np.empty((mx * my, 4, 2), dtype=np.int32)
    for ix in range(mx):
        for iy in range(my):
            for k, (dx, dy) in enumerate(HALF_SHELL):
                tbl[ix * my + iy, k] = ((ix + dx) % mx) * my + (iy + dy) % my
                shf[ix * my + iy, k] = ((ix + dx) // mx, (iy + dy) // my)
    return tbl.reshape(-1), shf.reshape(-1)


def expected_entries(classes, n_blocks):
    """For each block, the Counter of (role, start, blocks, shx, shy) of the
    visits in ``width_visits``' classes that touch it, by brute force."""
    want = [Counter() for _ in range(n_blocks)]
    for ista, jsta, shx, shy, width, tri in classes:
        nb = width // pps.TILE_I
        for k in range(len(ista)):
            ib, jb = int(ista[k]) // pps.TILE_I, int(jsta[k]) // pps.TILE_I
            sx, sy = int(shx[k]), int(shy[k])
            for b in range(n_blocks):
                if tri:
                    if ib <= b < ib + nb:
                        want[b][("self_diag", ib, nb, 0, 0) if b == ib
                                else ("self_below", ib, 1, 0, 0)] += 1
                else:
                    if b == ib:
                        want[b][("forward", jb, nb, sx, sy)] += 1
                    if jb <= b < jb + nb:
                        want[b][("backward", ib, 1, sx, sy)] += 1
    return want


@pytest.mark.parametrize("cap", [256, 384, 512])
@pytest.mark.parametrize("mx,my", [(4, 4), (5, 3)])
def test_width_index_is_the_visits_filtered_by_block(mx, my, cap):
    P, n_sub = mx * my, cap // pps.TILE_I
    rng = np.random.default_rng(mx * 1000 + my * 100 + cap)
    counts = rng.integers(0, cap + 1, size=P).astype(np.int32)
    counts[:4] = (0, cap, 128, 129)  # empty, full, one block, just past one
    tbl, shf = half_shell_tables(mx, my)
    lists = pfp.build_width_lists(torch.as_tensor(counts), torch.as_tensor(tbl),
                                  torch.as_tensor(shf), P, cap)
    index = pfp.width_index(*lists, P, cap)
    offsets, entries, order = index
    assert all(t.dtype == torch.int32 for t in index)
    assert offsets.shape == (P * n_sub + 1,) and order.shape == (P * n_sub,)
    assert int(offsets[0]) == 0 and bool((offsets[1:] >= offsets[:-1]).all())

    got = pfp.width_index_entries(index)
    want = expected_entries(pfp.width_visits(*lists, P, cap), P * n_sub)
    assert sum(map(len, got)) == int(offsets[-1]) == sum(sum(w.values()) for w in want)
    w_p = np.minimum((counts + 127) // 128, n_sub)
    for b in range(P * n_sub):
        assert Counter(got[b]) == want[b], b
        if b % n_sub >= w_p[b // n_sub]:
            assert not got[b], f"block {b} is past its pencil's width"  # nothing touches it

    # order: a permutation of the blocks, by partner blocks, most first
    cost = np.array([sum(e[2] for e in es) for es in got])
    order = order.numpy()
    assert sorted(order.tolist()) == list(range(P * n_sub))
    assert (np.diff(cost[order]) <= 0).all()


@pytest.fixture(scope="module")
def slots_one_empty():
    """test_torch_pencil.py's slot state with the particles of pencil 5
    removed (an empty pencil among full neighbours), in both packages."""
    n_full, L, r_list = 2048, 13.4, 2.9
    rng = np.random.default_rng(11)
    jgrid = jcl.make_pencil_grid(n_full, L, r_list, n_full / L**3)
    r = np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64))
    r = (r + rng.normal(0, 0.05, size=(n_full, 3))) % L
    pw = L / jgrid.m_xy
    pencil = (r[:, 0] // pw).astype(int) * jgrid.m_xy + (r[:, 1] // pw).astype(int)
    r = r[pencil != 5]
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns = jgrid.n_slots
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    r8 = jp2.sentinel_fill(r8.at[3].set(valid), valid, jgrid.capacity)
    v8 = jnp.zeros((8, ns)).at[0:3].set(jnp.asarray(rng.normal(0, 1.0, (3, ns)))) * valid
    counts = valid.reshape(jgrid.n_pencils, jgrid.capacity).sum(1).astype(jnp.int32)
    assert int(counts[5]) == 0 and (np.asarray(counts) > 128).any()
    tbl, shf = jp2.build_half_shell_tables(jgrid)

    def t(x):
        return torch.as_tensor(np.array(x))

    port = dict(r=t(r8), v=t(v8))
    # consistent accelerations, from the port's sweep twin, fed to both packages
    port["a"] = torch.zeros_like(port["r"])
    port["a"][0:3] = 24.0 * pps.pencil_sweep_hs(port["r"], t(tbl), t(counts), t(shf), jgrid,
                                                6.25, False)[0:3]
    port["wl"] = pfp.build_width_lists(t(counts), t(tbl), t(shf), jgrid.n_pencils,
                                       jgrid.capacity)
    jax_side = dict(r=r8, v=v8, a=jnp.asarray(port["a"].numpy()),
                    wl=jpf.build_width_lists(counts, jnp.asarray(tbl), jnp.asarray(shf),
                                             jgrid.n_pencils, jgrid.capacity))
    return jgrid, jax_side, port


@pytest.mark.parametrize("extended", [False, True])
def test_width_twin_through_the_index_matches_jax(slots_one_empty, extended):
    """3 steps of the width chunk's twin (block by block through the index)
    against JAX's kernel in interpret mode, on the valid slots."""
    jgrid, j, p = slots_one_empty
    P, cap, L, rc2, dt = jgrid.n_pencils, jgrid.capacity, 13.4, 6.25, 0.004
    jext = dict(r_lo=jnp.zeros_like(j["r"]), vc=jnp.zeros_like(j["r"])) if extended else {}
    pext = dict(r_lo=torch.zeros_like(p["r"]), vc=torch.zeros_like(p["r"])) if extended else {}
    want = jpf.fused_pencil_width_chunk(j["r"], j["v"], j["a"], *j["wl"], P, cap, L, rc2, dt,
                                        3, interpret=True, approx_reciprocal=False, **jext)
    got = pfp.fused_pencil_width_chunk(p["r"], p["v"], p["a"], *p["wl"], P, cap, L, rc2, dt,
                                       3, **pext)
    assert len(got) == len(want) == (5 if extended else 3)
    valid = np.asarray(j["r"][3])[None, :]
    for g, w in zip(got, want):
        g, w = g.numpy() * valid, np.asarray(w) * valid
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= 1e-12 * scale
    np.testing.assert_array_equal(got[0].numpy()[:, valid[0] == 0],
                                  np.asarray(j["r"])[:, valid[0] == 0])
