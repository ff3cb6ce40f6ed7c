"""The exact stage skips of the static pencil chunk (kernel 15) and the
z-banded sweep (kernel 12), as plain torch on the CPU, float64:

- ``half_shell_lower`` (the inverse half-shell table the static chunk reads
  its backward pencils from) against a brute-force inversion on 4x4, 5x3 and
  14x14 grids;
- ``static_stream`` (the static chunk's partner stream: every live stage of
  a block's own pencil, 4 forward and 4 backward neighbours) against a
  brute-force listing from the pencils' counts, with empty, short (under 128
  slots) and full pencils;
- the static twin, which runs through that stream, against the JAX
  package's ``fused_pencil_chunk`` in interpret mode with one pencil emptied
  and one under 128 slots, plain and extended;
- ``zband_stage_plan`` against a brute-force listing of the window stages,
  and the z-band twin, which sweeps the stages the plan keeps, against the
  JAX package's ``pallas_pencil_sweep_zband`` in interpret mode on a tall
  box where window B overlaps window A and windows run past the counts
  (the test asserts that both kinds of stage are skipped).

Inputs are made with numpy from a seed. Twin-against-JAX tolerance: 1e-12
of each row's scale (the pair arithmetic is the kernels', only the
summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_pencil as jpp
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu.ops import pallas_pencil_fused as jpf
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import fused_pencil as pfp
from ljmd_tpu_torch.ops import pencil_sweep as pps

torch.set_num_threads(1)

HALF_SHELL = ((0, 1), (1, -1), (1, 0), (1, 1))
TOL = 1e-12


def half_shell_tables(mx, my):
    """(tbl, shf) of an mx x my pencil grid (pencil ix * my + iy): the 4
    upper neighbours and their xy image shifts in units of L."""
    tbl = np.empty((mx * my, 4), dtype=np.int32)
    shf = np.empty((mx * my, 4, 2), dtype=np.int32)
    for ix in range(mx):
        for iy in range(my):
            for k, (dx, dy) in enumerate(HALF_SHELL):
                tbl[ix * my + iy, k] = ((ix + dx) % mx) * my + (iy + dy) % my
                shf[ix * my + iy, k] = ((ix + dx) // mx, (iy + dy) // my)
    return tbl.reshape(-1), shf.reshape(-1)


def _close(got, want, valid=None):
    got, want = np.asarray(got), np.asarray(want)
    if valid is not None:
        got, want = got * valid, want * valid
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("mx,my", [(4, 4), (5, 3), (14, 14)])
def test_half_shell_lower_inverts_the_table(mx, my):
    tbl, _ = half_shell_tables(mx, my)
    P = mx * my
    got = pfp.half_shell_lower(torch.as_tensor(tbl), P)
    assert got.dtype == torch.int32 and got.shape == (4 * P,)
    t = tbl.reshape(P, 4)
    for q in range(P):
        for k in range(4):
            owners = [p for p in range(P) if t[p, k] == q]
            assert owners == [int(got[q * 4 + k])]


def _packed_valid(counts, cap):
    """A validity row with counts[p] valid slots packed at the front of
    pencil p."""
    return (torch.arange(cap)[None, :] < torch.as_tensor(counts)[:, None]).double().reshape(-1)


@pytest.mark.parametrize("mx,my,cap", [(4, 4, 384), (5, 3, 512)])
def test_static_stream_lists_the_live_stages(mx, my, cap):
    """Each block with a valid first slot has its own pencil's, its 4 upper
    neighbours' and its 4 lower neighbours' live stages (ceil(count / 128)
    of them), in that order, with their roles and image shifts; a block
    past its pencil's count has none."""
    tbl, shf = half_shell_tables(mx, my)
    P, n_sub = mx * my, cap // 128
    rng = np.random.default_rng(mx * 10 + my)
    counts = rng.integers(0, cap + 1, size=P)
    counts[:4] = (0, 1, 127, cap)
    t = torch.as_tensor
    stream = pfp.static_stream(_packed_valid(counts, cap), t(tbl), t(shf),
                               pfp.half_shell_lower(t(tbl), P), P, cap)
    got = pfp.width_index_entries(stream)
    live = -(-counts // 128)
    t4, s4 = tbl.reshape(P, 4), shf.reshape(P, 4, 2)
    for q in range(P):
        for b in range(n_sub):
            want = []
            if b * 128 < counts[q]:
                want.append(("self_diag", q * n_sub, live[q], 0, 0))
                for k in range(4):
                    j = t4[q, k]
                    want.append(("forward", j * n_sub, live[j], s4[q, k, 0], s4[q, k, 1]))
                for k in range(4):
                    p = int(np.nonzero(t4[:, k] == q)[0][0])
                    want.append(("backward", p * n_sub, live[p], s4[p, k, 0], s4[p, k, 1]))
            have = [e for e in got[q * n_sub + b] if e[2] > 0]
            assert have == [w for w in want if w[2] > 0], (q, b)


@pytest.fixture(scope="module")
def slots_short():
    """tests/test_torch_pencil.py's lattice (N=2048 jittered FCC, L=13.4,
    4x4 pencils of capacity 256) with pencil 5 emptied and pencil 9 cut
    below 128 particles, in both packages, with consistent accelerations."""
    n_full, L, r_list = 2048, 13.4, 2.9
    rng = np.random.default_rng(17)
    jgrid = jcl.make_pencil_grid(n_full, L, r_list, n_full / L**3)
    r = np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64))
    r = (r + rng.normal(0, 0.05, size=(n_full, 3))) % L
    pw = L / jgrid.m_xy
    pencil = (r[:, 0] // pw).astype(int) * jgrid.m_xy + (r[:, 1] // pw).astype(int)
    keep = (pencil != 5) & ~((pencil == 9) & (np.cumsum(pencil == 9) > 100))
    r = r[keep]
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns = jgrid.n_slots
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    r8 = jp2.sentinel_fill(r8.at[3].set(valid), valid, jgrid.capacity)
    v8 = jnp.zeros((8, ns)).at[0:3].set(jnp.asarray(rng.normal(0, 1.0, (3, ns)))) * valid
    counts = np.array(valid.reshape(jgrid.n_pencils, jgrid.capacity).sum(1).astype(jnp.int32))
    assert counts[5] == 0 and 0 < counts[9] < 128 and (counts > 128).any()
    tbl, shf = jp2.build_half_shell_tables(jgrid)
    p = dict(r=torch.as_tensor(np.array(r8)), v=torch.as_tensor(np.array(v8)),
             tbl=torch.as_tensor(np.array(tbl)), shf=torch.as_tensor(np.array(shf)))
    p["a"] = torch.zeros_like(p["r"])
    p["a"][0:3] = 24.0 * pps.pencil_sweep_hs(p["r"], p["tbl"], torch.as_tensor(counts), p["shf"],
                                             jgrid, 6.25, False)[0:3]
    j = dict(r=r8, v=v8, a=jnp.asarray(p["a"].numpy()), tbl=jnp.asarray(tbl),
             shf=jnp.asarray(shf))
    return jgrid, j, p


def test_static_stream_skips_the_empty_stages(slots_short):
    """The stream of the short fixture leaves out the stages of the empty
    pencil and the second stage of the short one."""
    jgrid, _, p = slots_short
    P, cap = jgrid.n_pencils, jgrid.capacity
    offsets, entries, _ = pfp.static_stream(p["r"][3], p["tbl"], p["shf"],
                                            pfp.half_shell_lower(p["tbl"], P), P, cap)
    staged = int(((entries.long() >> 6) & 63).sum())
    live_blocks = int((p["r"][3].reshape(P, cap // 128, 128)[:, :, 0] > 0.5).sum())
    assert staged < live_blocks * 9 * (cap // 128)
    for e in pfp.width_index_entries((offsets, entries, _))[5 * (cap // 128)]:
        assert e[2] == 0  # the empty pencil's first block runs nothing


@pytest.mark.parametrize("extended", [False, True])
def test_static_twin_with_skips_matches_jax(slots_short, extended):
    """3 steps of the static twin (through the stream) against JAX's
    ``fused_pencil_chunk`` in interpret mode, on the valid slots; sentinels
    stay where they are."""
    jgrid, j, p = slots_short
    P, cap, L, rc2, dt = jgrid.n_pencils, jgrid.capacity, 13.4, 6.25, 0.004
    jext = dict(r_lo=jnp.zeros_like(j["r"]), vc=jnp.zeros_like(j["r"])) if extended else {}
    pext = dict(r_lo=torch.zeros_like(p["r"]), vc=torch.zeros_like(p["r"])) if extended else {}
    want = jpf.fused_pencil_chunk(j["r"], j["v"], j["a"], j["tbl"], j["shf"], P, cap, L, rc2,
                                  dt, 3, interpret=True, approx_reciprocal=False, **jext)
    got = pfp.fused_pencil_chunk(p["r"], p["v"], p["a"], p["tbl"], p["shf"], P, cap, L, rc2,
                                 dt, 3, **pext)
    assert len(got) == len(want) == (5 if extended else 3)
    valid = np.asarray(j["r"][3])[None, :]
    for g, w in zip(got, want):
        _close(g.numpy(), w, valid)
    np.testing.assert_array_equal(got[0].numpy()[:, valid[0] == 0],
                                  np.asarray(j["r"])[:, valid[0] == 0])


def test_zband_stage_plan_matches_brute_force():
    """The plan's kept stages and skip counts against a loop over every
    (i-slice, neighbour, window, stage) of random window tables on a 4x4
    grid of capacity 512 (window 256: starts 0, 128 or 256)."""
    rng = np.random.default_rng(5)
    m, cap, window = 4, 512, 256
    P, n_sub, n_win = m * m, cap // 128, window // 128
    T = P * n_sub
    tbl = np.array([((ix + dx) % m) * m + (iy + dy) % m for ix in range(m) for iy in range(m)
                    for dx in (-1, 0, 1) for dy in (-1, 0, 1)], dtype=np.int32)
    counts = rng.integers(0, cap + 1, size=P).astype(np.int32)
    counts[:2] = (0, 100)
    sa = (rng.integers(0, 3, size=T * 9) * 128).astype(np.int32)
    sb = (rng.integers(0, 3, size=T * 9) * 128).astype(np.int32)
    ub = rng.integers(0, 2, size=T * 9).astype(np.int32)
    t = torch.as_tensor
    plan = pps.zband_stage_plan(t(counts), t(tbl), t(sa), t(sb), t(ub), P, cap, window)
    keep, start = plan["keep"].numpy(), plan["start"].numpy()
    n = dict(stages=0, b_inside_a=0, a_past_count=0, b_past_count=0, kept=0)
    for ti in range(T):
        q, si = divmod(ti, n_sub)
        for k in range(9):
            jj = tbl[q * 9 + k]
            e = ti * 9 + k
            for w, s0 in ((0, sa[e]), (1, sb[e])):
                for i in range(n_win):
                    s = s0 + 128 * i
                    assert start[ti, k, w, i] == jj * cap + s
                    swept = si * 128 < counts[q] and counts[jj] > 0 and (w == 0 or ub[e] > 0)
                    inside = w == 1 and sa[e] <= s < sa[e] + window
                    past = s >= counts[jj]
                    n["stages"] += swept
                    n["b_inside_a"] += swept and inside
                    n["a_past_count"] += swept and w == 0 and past
                    n["b_past_count"] += swept and w == 1 and not inside and past
                    n["kept"] += swept and not inside and not past
                    assert keep[ti, k, w, i] == (swept and not inside and not past)
    assert {k: plan[k] for k in n} == n
    assert n["b_inside_a"] > 0 and n["a_past_count"] > 0 and n["b_past_count"] > 0


def test_zband_twin_with_skips_matches_jax():
    """The z-band twin (the plan's kept stages) against
    ``pallas_pencil_sweep_zband`` in interpret mode, every output row, on a
    tall box (N=1600 uniform, L=60, 3x3 pencils of capacity 512, ~178 a
    pencil, window 384) where both kinds of stage are skipped."""
    n, L, rc2 = 1600, 60.0, 6.25
    r = np.random.default_rng(23).uniform(0, L, size=(n, 3))
    jgrid = jcl.make_pencil_grid(n, L, 20.0, n / L**3, capacity=512)
    pgrid = pcl.make_pencil_grid(n, L, 20.0, n / L**3, 512)
    window = pcl.default_z_window(pgrid, n, 2.9)
    assert window == jcl.default_z_window(jgrid, n, 2.9) == 384
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns = jgrid.n_slots
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    r8 = r8.at[3].set(valid)
    counts = valid.reshape(jgrid.n_pencils, jgrid.capacity).sum(1).astype(jnp.int32)
    wa, wb, ub, ovf = jcl.compute_z_windows(r8, r8[3], counts, jgrid, window, 2.9, 128)
    assert not bool(ovf)
    tbl = jnp.asarray(jpp.build_tile_table(jgrid))
    want = jpp.pallas_pencil_sweep_zband(r8, tbl, counts, wa, wb, ub, jgrid, rc2, window,
                                         interpret=True)
    t = [torch.as_tensor(np.array(x)) for x in (r8, tbl, counts, wa, wb, ub)]
    plan = pps.zband_stage_plan(t[2], t[1], *t[3:], pgrid.n_pencils, pgrid.capacity, window)
    assert plan["b_inside_a"] > 0 and plan["a_past_count"] + plan["b_past_count"] > 0
    assert plan["kept"] == plan["stages"] - plan["b_inside_a"] - plan["a_past_count"] \
        - plan["b_past_count"]
    got = pps.pencil_sweep_zband(t[0], t[1], t[2], *t[3:], pgrid, rc2, window)
    for row in range(8):
        _close(got[row].numpy(), want[row])
