"""Kernels 11 and 12 over the replica stack of the batched cell-pair
engine's full sweeps (``_cellpair_engine(..., replicas=R)`` with
``half_shell=False`` or ``z_band=True``), float64 on the CPU with one
thread:

- kernels 11 and 12's replica launches through their twins on a flat stack
  of R grids (``replica_tables`` of the 9-neighbour tables) against
  ``jax.vmap`` of ``pallas_pencil_sweep`` / ``pallas_pencil_sweep_zband``
  in interpret mode, and each replica bit for bit against the one-grid twin;
- ``compute_z_windows`` and the z-ordered rebin over the stack against each
  replica's own and against JAX's, the window overflow one flag a replica.

The engines over the stack: tests/test_torch_cellpair_sweeps_replicas_engines.py
(against one-system engines) and tests/test_torch_cellpair_sweeps_replicas_jax.py
(against JAX's).

The sweeps' tolerances are tests/test_torch_pencil_full.py's (rtol 1e-10 /
atol 1e-12 of each array's scale); its boxes are reused: the jittered N=2048
lattice (4x4 pencils of capacity 256) and the tall N=1600 box where the
z-band is live (3x3 pencils of capacity 512, window 384).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_pencil as jpp
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import pencil_sweep as pps

torch.set_num_threads(1)

R = 2
RC2 = 6.25


def _close_scaled(got, want, rtol=1e-10, atol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= atol + rtol * float(np.abs(want).max()), err


def _slot_state(r, jgrid):
    """JAX slot rows (validity in row 3, zeros in empty slots) and counts."""
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns = jgrid.n_slots
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    r8 = r8.at[3].set(valid)
    counts = valid.reshape(jgrid.n_pencils, jgrid.capacity).sum(1).astype(jnp.int32)
    return np.array(r8), np.array(counts)


def _stack(states):
    """R JAX slot states -> (per-replica rows (R, 8, ns), counts (R, P)),
    and the port's flat stack ((8, R * ns), (R * P,))."""
    rows = np.stack([s[0] for s in states])
    counts = np.stack([s[1] for s in states])
    flat = torch.as_tensor(rows.transpose(1, 0, 2).reshape(8, -1)).contiguous()
    return rows, counts, flat, torch.as_tensor(counts.reshape(-1))


def _per_replica(x):
    """(8, R * ns) -> (R, 8, ns); (R * k,) -> (R, k)."""
    x = x.detach()
    return (x.reshape(R, -1) if x.dim() == 1 else x.reshape(8, R, -1).transpose(0, 1)).numpy()


@pytest.fixture(scope="module")
def lattice():
    """Two jitters of tests/test_torch_pencil_full.py's lattice."""
    n, L, r_list = 2048, 13.4, 2.9
    base = np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64))
    jgrid = jcl.make_pencil_grid(n, L, r_list, n / L**3)
    pgrid = pcl.make_pencil_grid(n, L, r_list, n / L**3)
    states = [_slot_state((base + np.random.default_rng(3 + q).normal(0, 0.05, (n, 3))) % L,
                          jgrid) for q in range(R)]
    return jgrid, pgrid, _stack(states)


@pytest.fixture(scope="module")
def tall():
    """The tall box twice: replica 0 with its z in two thin layers at the
    faces (a slice's margin then wraps at both, which the window flag
    raises), replica 1 uniform (live windows, some across z = 0 or L)."""
    n, L = 1600, 60.0
    rng = np.random.default_rng(0)
    r0 = rng.uniform(0, L, size=(n, 3))
    r0[:, 2] = np.where(rng.random(n) < 0.5, r0[:, 2] / L, L - r0[:, 2] / L)
    r1 = np.random.default_rng(1).uniform(0, L, size=(n, 3))
    jgrid = jcl.make_pencil_grid(n, L, 20.0, n / L**3, capacity=512)
    pgrid = pcl.make_pencil_grid(n, L, 20.0, n / L**3, 512)
    window = pcl.default_z_window(pgrid, n, 2.9)
    assert window == 384
    return jgrid, pgrid, window, _stack([_slot_state(r, jgrid) for r in (r0, r1)])


def _tables(pgrid):
    tbl = torch.as_tensor(pps.build_tile_table(pgrid))
    shf = torch.as_tensor(pps.build_shift_table(pgrid))
    return tbl, shf, pps.replica_tables(tbl, shf, pgrid.n_pencils, R)


@pytest.mark.parametrize("want_obs", [True, False])
def test_full_sweep_replicas_match_vmapped_jax(lattice, want_obs):
    """Kernel 11 over the stack against the vmapped TPU sweep on each
    replica, and each replica bit for bit against the sweep of its grid."""
    jgrid, pgrid, (rows, counts, flat, fcounts) = lattice
    tbl, shf, (tbl_r, shf_r) = _tables(pgrid)
    got = pps.pencil_sweep(flat, tbl_r, fcounts, shf_r, pgrid, RC2, want_obs, replicas=R)
    jt = jnp.asarray(jpp.build_tile_table(jgrid))
    want = jax.vmap(lambda r, c: jpp.pallas_pencil_sweep(
        r, jt, c, jgrid, RC2, interpret=True, want_observables=want_obs))(
        jnp.asarray(rows), jnp.asarray(counts))
    got_q = _per_replica(got)
    for q in range(R):
        for row in range(8):
            _close_scaled(got_q[q, row], np.asarray(want)[q, row])
        one = pps.pencil_sweep(torch.as_tensor(rows[q]), tbl, torch.as_tensor(counts[q]), shf,
                               pgrid, RC2, want_obs)
        assert torch.equal(torch.as_tensor(got_q[q]), one), q


def test_z_windows_and_rebin_over_the_stack(tall):
    """compute_z_windows over the stack: each replica's tables its own and
    JAX's, the overflow (R,) raised for replica 0 alone; the z-ordered
    rebin over the stack orders each replica as its own rebin."""
    jgrid, pgrid, window, (rows, counts, flat, fcounts) = tall
    got = pcl.compute_z_windows(flat, flat[3], fcounts, pgrid, window, 2.9, replicas=R)
    assert got[0].shape == (R * pgrid.n_slots // 128 * 9,)
    assert got[3].tolist() == [True, False]
    for q in range(R):
        one = pcl.compute_z_windows(torch.as_tensor(rows[q]), torch.as_tensor(rows[q][3]),
                                    torch.as_tensor(counts[q]), pgrid, window, 2.9)
        want = jcl.compute_z_windows(jnp.asarray(rows[q]), jnp.asarray(rows[q][3]),
                                     jnp.asarray(counts[q]), jgrid, window, 2.9, 128)
        for g, o, w in zip(got[:3], one[:3], want[:3]):
            assert torch.equal(g.reshape(R, -1)[q], o)
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
        assert bool(got[3][q]) == bool(one[3]) == bool(want[3])

    # the rebin: positions moved so that particles change pencils
    moved = flat.clone()
    moved[0:3] = torch.remainder(moved[0:3] + torch.as_tensor(
        np.random.default_rng(5).normal(0, 3.0, (3, moved.shape[1]))), 60.0)
    order, src, valid, ovf = pcl.rebin_gather_parts(moved, moved[3], pgrid, z_order=True,
                                                    replicas=R)
    ns = pgrid.n_slots
    for q in range(R):
        mine = moved[:, q * ns:(q + 1) * ns]
        o1, s1, v1, f1 = pcl.rebin_gather_parts(mine, mine[3], pgrid, z_order=True)
        sl = slice(q * ns, (q + 1) * ns)
        assert torch.equal(valid[sl], v1) and bool(ovf[q]) == bool(f1)
        assert torch.equal(order[src[sl]][v1], o1[s1][v1] + q * ns)


def test_zband_sweep_replicas_match_vmapped_jax(tall):
    """Kernel 12 over the stack with the stack's window tables against the
    vmapped TPU sweep, each replica bit for bit against its grid's, and
    against the full sweep over the stack (replica 1, whose windows cover
    its margins)."""
    jgrid, pgrid, window, (rows, counts, flat, fcounts) = tall
    tbl, shf, (tbl_r, shf_r) = _tables(pgrid)
    wa, wb, ub, _ = pcl.compute_z_windows(flat, flat[3], fcounts, pgrid, window, 2.9,
                                          replicas=R)
    got = pps.pencil_sweep_zband(flat, tbl_r, fcounts, wa, wb, ub, pgrid, RC2, window,
                                 replicas=R)
    jt = jnp.asarray(jpp.build_tile_table(jgrid))
    tabs = [jnp.asarray(_per_replica(x)) for x in (wa, wb, ub)]
    want = jax.vmap(lambda r, c, a, b, u: jpp.pallas_pencil_sweep_zband(
        r, jt, c, a, b, u, jgrid, RC2, window, interpret=True))(
        jnp.asarray(rows), jnp.asarray(counts), *tabs)
    full = pps.pencil_sweep(flat, tbl_r, fcounts, shf_r, pgrid, RC2, replicas=R)
    got_q, full_q = _per_replica(got), _per_replica(full)
    for q in range(R):
        for row in range(8):
            _close_scaled(got_q[q, row], np.asarray(want)[q, row])
            if q == 1:
                _close_scaled(got_q[q, row], full_q[q, row])
        one = pps.pencil_sweep_zband(torch.as_tensor(rows[q]), tbl, torch.as_tensor(counts[q]),
                                     *(torch.as_tensor(_per_replica(x)[q]) for x in (wa, wb, ub)),
                                     pgrid, RC2, window)
        assert torch.equal(torch.as_tensor(got_q[q]), one), q
