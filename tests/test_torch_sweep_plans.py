"""The plan rules of the half-shell sweep (kernels 13 / 14) and of the fused
list chunk (kernel 10), as plain torch on the CPU, float64:

- ``half_shell_lower`` over a strip's table (the i pencils' rows, inverted
  over strip and halo) against a brute-force inversion;
- ``hs_stage_plan`` (each pencil's 9 segments, their shifts and live
  stages, the live work items) against a brute-force listing, on a full grid
  and on a strip, with empty, short (under 128 slots) and full pencils;
- the sweep twin, which runs through that plan, against the JAX package's
  ``pallas_pencil_sweep_hs`` and ``pallas_pencil_sweep_mono`` (with
  ``n_pencils_i`` on a strip) in interpret mode, with one pencil emptied and
  one cut under 128 slots (the test asserts that stages were skipped);
- ``list_plan_stages`` (each 128-column granule's forward and backward
  stages, in list order) against a brute-force walk of the lists, on random
  and on a fluid's flags, spans 3, 4 and 6, within ``list_plan_stride``;
- the list twin, which runs through that plan, against the JAX package's
  ``fused_dense_chunk_list`` in interpret mode, plain, obs_last and
  extended, on lists with every category and tail width.

Inputs are made with numpy from seeds. Twin-against-JAX tolerance: 1e-12 of
each row's scale for the sweep, rtol 1e-10 for the chunk (the pair
arithmetic is the kernels', only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_fused as pf
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu.parallel import spatial_pencil as jsp
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import fused_list, window_lists
from ljmd_tpu_torch.ops import pencil_sweep as pps
from ljmd_tpu_torch.ops.pair_sweep import pair_forces_plain
from ljmd_tpu_torch.parallel import spatial_pencil as psp

torch.set_num_threads(1)

N, L, R_LIST, RC2 = 2048, 13.4, 2.9, 6.25
TOL = 1e-12
HALF_SHELL = ((0, 1), (1, -1), (1, 0), (1, 1))


def _tables(m):
    """(tbl, shf) of an m x m pencil grid, as the builders write them."""
    tbl = np.empty((m * m, 4), dtype=np.int32)
    shf = np.empty((m * m, 4, 2), dtype=np.int32)
    for ix in range(m):
        for iy in range(m):
            for k, (dx, dy) in enumerate(HALF_SHELL):
                tbl[ix * m + iy, k] = ((ix + dx) % m) * m + (iy + dy) % m
                shf[ix * m + iy, k] = ((ix + dx) // m, (iy + dy) // m)
    return tbl.reshape(-1), shf.reshape(-1)


def _strip(m, d=2, rank=0):
    """(tbl, shf, i pencils, all pencils) of rank's strip plus its halo."""
    m_xl = m // d
    return (psp._local_half_shell_table(m, m_xl), psp._device_shift_tables(m, m_xl, d)[rank],
            m_xl * m, (m_xl + 1) * m)


@pytest.mark.parametrize("m", [4, 6, 14])
def test_half_shell_lower_of_a_strip(m):
    tbl, _, p_i, p_all = _strip(m)
    got = pps.half_shell_lower(torch.as_tensor(tbl), p_all)
    assert got.dtype == torch.int32 and got.shape == (4 * p_all,)
    t = tbl.reshape(p_i, 4)
    for q in range(p_all):
        for k in range(4):
            owners = [p for p in range(p_i) if t[p, k] == q]
            assert len(owners) <= 1
            assert int(got[q * 4 + k]) == (owners[0] if owners else -1)


def _brute_plan(cnt, tbl, shf, p_i, p_all, cap):
    """Per pencil: the 9 segments (partner or -1, shift, live stages) and
    its live 128-slot blocks, by loops."""
    n_sub = cap // 128
    t = tbl.reshape(p_i, 4)
    s = shf.reshape(p_i, 4, 2)
    segs, items = [], []
    for q in range(p_all):
        row = [(q, (0, 0)) if q < p_i else (-1, (0, 0))]
        row += [(int(t[q, k]), tuple(s[q, k])) if q < p_i else (-1, (0, 0)) for k in range(4)]
        for k in range(4):
            own = [p for p in range(p_i) if t[p, k] == q]
            row.append((own[0], tuple(s[own[0], k])) if own else (-1, (0, 0)))
        segs.append([(j, sh, min(n_sub, -(-int(cnt[j]) // 128)) if j >= 0 else 0)
                     for j, sh in row])
        items.append([b * 128 < cnt[q] for b in range(n_sub)])
    return segs, items


def _counts(p_all, cap, seed):
    """Per-pencil counts with an empty, a short (< 128), a full and random
    pencils."""
    cnt = np.random.default_rng(seed).integers(1, cap + 1, size=p_all)
    cnt[1], cnt[2], cnt[3] = 0, 77, cap
    return cnt


@pytest.mark.parametrize("kind,m,cap", [("grid", 4, 256), ("grid", 5, 384), ("strip", 4, 384),
                                        ("strip", 6, 256)])
def test_hs_stage_plan_matches_brute_force(kind, m, cap):
    if kind == "grid":
        tbl, shf = _tables(m)
        p_i = p_all = m * m
    else:
        tbl, shf, p_i, p_all = _strip(m)
    cnt = _counts(p_all, cap, seed=m * cap)
    tt, ts = torch.as_tensor(tbl), torch.as_tensor(shf)
    plan = pps.hs_stage_plan(torch.as_tensor(cnt), tt, ts, pps.half_shell_lower(tt, p_all), p_i,
                             p_all, cap)
    segs, items = _brute_plan(cnt, tbl, shf, p_i, p_all, cap)
    n_sub = cap // 128
    assert plan["pencil"].tolist() == [[j for j, _, _ in row] for row in segs]
    assert plan["shift"].tolist() == [[list(sh) for _, sh, _ in row] for row in segs]
    assert plan["live"].tolist() == [[lv for _, _, lv in row] for row in segs]
    assert plan["item_live"].tolist() == items
    keep = plan["keep"].numpy()
    start = plan["start"].numpy()
    for q, row in enumerate(segs):
        for s, (j, _, lv) in enumerate(row):
            assert keep[q, s].tolist() == [c < lv for c in range(n_sub)]
            if j >= 0:
                assert start[q, s].tolist() == [j * cap + c * 128 for c in range(n_sub)]
    n_items = [sum(it) for it in items]
    assert plan["items"] == sum(n_items)
    assert plan["kept"] == sum(n * sum(lv for _, _, lv in row) for n, row in zip(n_items, segs))
    assert plan["full"] == sum(n * n_sub * sum(j >= 0 and cnt[j] > 0 for j, _, _ in row)
                               for n, row in zip(n_items, segs))
    assert plan["kept"] < plan["full"]
    chunks = pps.hs_chunks(plan)
    assert chunks[0].numel() == plan["kept"]


@pytest.fixture(scope="module")
def cut_slots():
    """tests/test_torch_pencil.py's slot state (N=2048, L=13.4, 4x4 pencils
    of capacity 256), with pencil 5 emptied and pencil 10 cut to 60 slots
    (the tail ranks of each dropped: slots stay packed rank-first)."""
    rng = np.random.default_rng(3)
    grid = jcl.make_pencil_grid(N, L, R_LIST, N / L**3)
    r = np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64))
    r = (r + rng.normal(0, 0.05, size=(N, 3))) % L
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), grid)
    assert not bool(ovf)
    ns, cap = grid.n_slots, grid.capacity
    r8 = np.asarray(jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns])
    valid = np.asarray(jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]).copy()
    valid[5 * cap:6 * cap] = 0.0
    valid[10 * cap + 60:11 * cap] = 0.0
    r8 = np.asarray(jp2.sentinel_fill(jnp.asarray(r8).at[3].set(valid), jnp.asarray(valid), cap))
    counts = valid.reshape(grid.n_pencils, cap).sum(1).astype(np.int32)
    assert counts[5] == 0 and counts[10] == 60
    return grid, r8, counts


@pytest.mark.parametrize("want_obs", [True, False])
def test_sweep_twin_with_skips_matches_jax(cut_slots, want_obs):
    jgrid, r8, counts = cut_slots
    tbl, shf = jp2.build_half_shell_tables(jgrid)
    want = np.asarray(jp2.pallas_pencil_sweep_hs(
        jnp.asarray(r8), jnp.asarray(tbl), jnp.asarray(counts), jnp.asarray(shf), jgrid, RC2,
        interpret=True, want_observables=want_obs, approx_reciprocal=False)) * r8[3:4]
    pgrid = pcl.make_pencil_grid(N, L, R_LIST, N / L**3)
    tt, ts, tc = (torch.as_tensor(np.asarray(x)) for x in (tbl, shf, counts))
    plan = pps.hs_stage_plan(tc, tt, ts, pps.half_shell_lower(tt, 16), 16, 16, 256)
    assert plan["kept"] < plan["full"], "no stage was skipped"
    got = pps.pencil_sweep_hs(torch.as_tensor(r8), tt, tc, ts, pgrid, RC2, want_obs).numpy()
    for row in range(8):
        scale = max(1.0, float(np.abs(want[row]).max()))
        assert float(np.abs(got[row] - want[row]).max()) <= TOL * scale, row
    assert not got[:, 5 * 256:6 * 256].any()


@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("rank", [0, 1])
def test_strip_sweep_twin_with_skips_matches_mono(cut_slots, rank, want_obs):
    jgrid, r8, counts = cut_slots
    m, cap = jgrid.m_xy, jgrid.capacity
    tbl, shf, p_i, _ = _strip(m, 2, rank)
    w = p_i * cap
    nxt = (rank + 1) % 2
    r_aug = np.concatenate([r8[:, rank * w:(rank + 1) * w], r8[:, nxt * w:nxt * w + m * cap]], 1)
    assert np.array_equal(tbl, jsp._local_half_shell_table(m, m // 2))
    want = np.asarray(jp2.pallas_pencil_sweep_mono(
        jnp.asarray(r_aug), jnp.asarray(tbl), jnp.asarray(counts[rank * p_i:(rank + 1) * p_i]),
        jnp.asarray(shf), jgrid, RC2, interpret=True, want_observables=want_obs,
        approx_reciprocal=False, n_pencils_i=p_i)) * r_aug[3:4]
    pgrid = pcl.make_pencil_grid(N, L, R_LIST, N / L**3)
    counts_aug = psp.augmented_counts(torch.as_tensor(counts), m, 2)[rank]
    got = pps.pencil_sweep_hs(torch.as_tensor(r_aug), torch.as_tensor(tbl), counts_aug,
                              torch.as_tensor(shf), pgrid, RC2, want_obs, n_pencils_i=p_i).numpy()
    for row in range(8):
        scale = max(1.0, float(np.abs(want[row]).max()))
        assert float(np.abs(got[row] - want[row]).max()) <= TOL * scale, row
    assert not got[3:, p_i * cap:].any(), "observables on the halo"


def _sorted_rows(num_cells, box, n_pad, seed):
    rng = np.random.default_rng(seed)
    r = fcc_lattice(num_cells, box, dtype=torch.float64).numpy()
    r = np.mod(r + rng.normal(scale=0.05, size=r.shape), box)
    r = r[np.argsort(r[:, 2])]
    rows = np.zeros((8, n_pad))
    rows[0:3, :len(r)] = r.T
    return len(r), rows


def _lists(kind):
    """(tiles, tcounts, n_pad, tile_j) of the port's pack twin."""
    if kind == "fluid_span4":
        n, rows = _sorted_rows(10, 16.796, 4096, seed=4)
        flags = window_lists.compute_tile_flags(torch.tensor(rows), n, 128, 128, 16.796, 3.22,
                                                cross_margin=0.36)
        n_pad, tj = 4096, 512
    else:
        n_pad, tj = (1280, 384) if kind == "random_span3" else (2048, 768)
        n = n_pad - 77
        n_b = n_pad // 128
        flags = torch.as_tensor(np.random.default_rng(n_b).choice(
            [0, 1, 3, 5, 7], p=[0.4, 0.3, 0.1, 0.1, 0.1], size=n_b * n_b).astype(np.int32))
    tiles, tcounts = window_lists.build_window_lists(flags, n, n_pad, 128, tj)
    return tiles, tcounts, n_pad, tj


def _brute_stages(tiles, tcounts, n_pad, tj):
    span = tj // 128
    n_tails = (tiles.shape[0] - 9) // 2
    t = tiles.tolist()
    per = [[] for _ in range(n_pad // 128)]
    cats = [(c, 2 * c, span) for c in range(4)] + [(4 + w - 1, 9 + 2 * (w - 1), w)
                                                   for w in range(1, n_tails + 1)]
    for cidx, row, wb in cats:
        masked, rx, rz = cidx >= 3, cidx != 0, cidx >= 2
        for k in range(int(tcounts[cidx])):
            ib, jb = t[row][k], t[row + 1][k]
            jmin = t[8][k] if cidx == 3 else 0
            meta = 2 * masked | 4 * rx | 8 * rz | (jmin << 4)
            for g in range(len(per)):
                if ib == g:
                    per[g] += [((jb + d) * 128, meta | 1) for d in range(wb)]
                if jb <= g < jb + wb:
                    per[g].append((ib * 128, meta))
    return per


@pytest.mark.parametrize("kind", ["random_span3", "fluid_span4", "random_span6"])
def test_list_plan_stages_match_brute_force(kind):
    tiles, tcounts, n_pad, tj = _lists(kind)
    offsets, col0, meta = fused_list.list_plan_stages(tiles, tcounts, n_pad, tj)
    want = _brute_stages(tiles, tcounts, n_pad, tj)
    stride = fused_list.list_plan_stride(n_pad, tj)
    assert offsets.numel() == len(want) + 1
    for g, w in enumerate(want):
        got = list(zip(col0[offsets[g]:offsets[g + 1]].tolist(),
                       meta[offsets[g]:offsets[g + 1]].tolist()))
        assert got == w, g
        assert len(w) <= stride
    assert any(len(w) > 0 for w in want)


@pytest.fixture(scope="module")
def span3_chunk():
    """N=864 at n_pad 1024 (160 padding columns) with tile_j 384 and random
    flags: every category and both tail widths occur."""
    box = 10.0776
    n, rows = _sorted_rows(6, box, 1024, seed=8)
    rng = np.random.default_rng(12)
    v = np.zeros_like(rows)
    v[0:3, :n] = rng.uniform(-1.0, 1.0, (3, n))
    a = 24.0 * pair_forces_plain(torch.tensor(rows), n, box, 6.25).numpy()
    flags = np.random.default_rng(36).choice([0, 1, 3, 5, 7], p=[0.3, 0.4, 0.1, 0.1, 0.1],
                                             size=(64,)).astype(np.int32)
    tiles, counts = pf.build_window_lists_pallas(jnp.asarray(flags), n, 1024, 128, 384,
                                                 interpret=True, zero_fill=True, tail_tiles=True)
    counts = np.asarray(counts)
    assert (counts > 0).all(), counts
    return n, box, rows, v, a, np.asarray(tiles), counts


@pytest.mark.parametrize("mode", ["plain", "obs_last", "extended"])
def test_list_twin_through_plan_matches_jax(span3_chunk, mode):
    n, box, rows, v, a, tiles, counts = span3_chunk
    extended, obs_last = mode == "extended", mode == "obs_last"
    rng = np.random.default_rng(31)
    real = (np.arange(1024) < n) * (np.arange(8) < 3)[:, None]
    lo = rng.uniform(-1e-9, 1e-9, rows.shape) * real
    vc = rng.uniform(-1e-9, 1e-9, rows.shape) * real
    args = dict(n=n, box_length=box, rc_square=6.25, dt=0.004, n_steps=1, tile_i=128,
                tile_j=384, obs_last=obs_last)
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
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                   atol=1e-10 * max(1.0, np.abs(w).max()), err_msg=f"output {k}")
