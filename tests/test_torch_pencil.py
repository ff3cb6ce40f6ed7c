"""The twins of the port's three pencil kernels against the JAX package's
Pallas kernels in interpret mode, float64 on the CPU:

- ``pencil_sweep_hs`` (``ops/pencil_sweep.py``) against both
  ``pallas_pencil_sweep_hs`` and ``pallas_pencil_sweep_mono``, with and
  without observables;
- ``fused_pencil_chunk`` and ``fused_pencil_width_chunk``
  (``ops/fused_pencil.py``) against their JAX kernels, plain and extended.

Inputs are tests/test_pencil_fused.py's: a jittered FCC lattice (N=2048,
L=13.4, 4x4 pencils of capacity 256, counts straddling 128 so both width
classes run), from a numpy seed. The pair arithmetic is bit-identical and
only the summation order differs, so the tolerance is that file's: 1e-12
of each row's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.models.lattice import fcc_lattice as j_fcc_lattice
from ljmd_tpu.ops import cell_list as jcl
from ljmd_tpu.ops import pallas_pencil2 as jp2
from ljmd_tpu.ops import pallas_pencil_fused as jpf
from ljmd_tpu_torch.ops import cell_list as pcl
from ljmd_tpu_torch.ops import fused_pencil as pfp
from ljmd_tpu_torch.ops import pencil_sweep as pps

torch.set_num_threads(1)

N, L, R_LIST, RC2, DT = 2048, 13.4, 2.9, 6.25, 0.004
TOL = 1e-12


@pytest.fixture(scope="module")
def slots():
    """The slot state in both packages: rows (sentinels, validity), v, a,
    counts, tables and width lists."""
    rng = np.random.default_rng(3)
    jgrid = jcl.make_pencil_grid(N, L, R_LIST, N / L**3)
    pgrid = pcl.make_pencil_grid(N, L, R_LIST, N / L**3)
    r = np.asarray(j_fcc_lattice(8, L, dtype=jnp.float64))
    r = (r + rng.normal(0, 0.05, size=(N, 3))) % L
    slot, ovf = jcl.bin_to_slots(jnp.asarray(r), jgrid)
    assert not bool(ovf)
    ns = jgrid.n_slots
    r8 = jnp.zeros((8, ns + 1)).at[0:3, slot].set(jnp.asarray(r).T)[:, :ns]
    valid = jnp.zeros((ns + 1,)).at[slot].set(1.0)[:ns]
    r8 = jp2.sentinel_fill(r8.at[3].set(valid), valid, jgrid.capacity)
    v8 = jnp.zeros((8, ns)).at[0:3].set(jnp.asarray(rng.normal(0, 1.0, (3, ns)))) * valid
    counts = valid.reshape(jgrid.n_pencils, jgrid.capacity).sum(1).astype(jnp.int32)
    w = np.asarray((counts + 127) // 128)
    assert (w == 1).any() and (w >= 2).any(), "both width classes must run"
    tbl, shf = jp2.build_half_shell_tables(jgrid)

    def t(x):
        return torch.as_tensor(np.array(x))

    port = dict(r=t(r8), v=t(v8), counts=t(counts), tbl=t(tbl), shf=t(shf))
    # consistent accelerations, from the port's twin, fed to both packages
    a8 = torch.zeros_like(port["r"])
    a8[0:3] = 24.0 * pps.pencil_sweep_hs(port["r"], port["tbl"], port["counts"], port["shf"],
                                         pgrid, RC2, False)[0:3]
    port["a"] = a8
    port["wl"] = pfp.build_width_lists(port["counts"], port["tbl"], port["shf"],
                                       pgrid.n_pencils, pgrid.capacity)
    jax_side = dict(r=r8, v=v8, a=jnp.asarray(a8.numpy()), counts=counts,
                    tbl=jnp.asarray(tbl), shf=jnp.asarray(shf),
                    wl=jpf.build_width_lists(counts, jnp.asarray(tbl), jnp.asarray(shf),
                                             jgrid.n_pencils, jgrid.capacity))
    return jgrid, pgrid, jax_side, port


def _close(got, want, valid=None):
    got, want = got.numpy(), np.asarray(want)
    if valid is not None:
        got, want = got * valid, want * valid
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (err, scale)


@pytest.mark.parametrize("want_obs", [True, False])
def test_sweep_twin_matches_hs_and_mono(slots, want_obs):
    """The port's sweep output (already multiplied by the validity row)
    against the grid and the single-program TPU kernels times that row."""
    jgrid, pgrid, j, p = slots
    kw = dict(interpret=True, want_observables=want_obs, approx_reciprocal=False)
    want_hs = jp2.pallas_pencil_sweep_hs(j["r"], j["tbl"], j["counts"], j["shf"], jgrid, RC2,
                                         **kw) * j["r"][3:4]
    want_mono = jp2.pallas_pencil_sweep_mono(j["r"], j["tbl"], j["counts"], j["shf"], jgrid,
                                             RC2, **kw) * j["r"][3:4]
    got = pps.pencil_sweep_hs(p["r"], p["tbl"], p["counts"], p["shf"], pgrid, RC2, want_obs)
    assert got.shape == p["r"].shape and got.dtype == torch.float64
    for row in range(8):
        _close(got[row], want_hs[row])
        _close(got[row], want_mono[row])
    if not want_obs:
        assert bool((got[3:] == 0).all())


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("kind", ["static", "width"])
def test_fused_twins_match_jax_kernels(slots, kind, extended):
    """3 steps of each fused twin against its JAX kernel, from one state;
    compared on the valid slots (sentinels stay where they are in both)."""
    jgrid, pgrid, j, p = slots
    P, cap = jgrid.n_pencils, jgrid.capacity
    valid = np.asarray(j["r"][3])[None, :]
    jext = dict(r_lo=jnp.zeros_like(j["r"]), vc=jnp.zeros_like(j["r"])) if extended else {}
    pext = dict(r_lo=torch.zeros_like(p["r"]), vc=torch.zeros_like(p["r"])) if extended else {}
    kw = dict(interpret=True, approx_reciprocal=False)
    if kind == "static":
        want = jpf.fused_pencil_chunk(j["r"], j["v"], j["a"], j["tbl"], j["shf"], P, cap, L,
                                      RC2, DT, 3, **kw, **jext)
        got = pfp.fused_pencil_chunk(p["r"], p["v"], p["a"], p["tbl"], p["shf"], P, cap, L,
                                     RC2, DT, 3, **pext)
    else:
        want = jpf.fused_pencil_width_chunk(j["r"], j["v"], j["a"], *j["wl"], P, cap, L, RC2,
                                            DT, 3, **kw, **jext)
        got = pfp.fused_pencil_width_chunk(p["r"], p["v"], p["a"], *p["wl"], P, cap, L, RC2,
                                           DT, 3, **pext)
    assert len(got) == len(want) == (5 if extended else 3)
    for g, w in zip(got, want):
        _close(g, w, valid)
    # sentinels never move
    np.testing.assert_array_equal(got[0].numpy()[:, valid[0] == 0],
                                  np.asarray(j["r"])[:, valid[0] == 0])


def test_fused_twin_rejects_long_chunks(slots):
    _, pgrid, _, p = slots
    with pytest.raises(ValueError, match="MAX_PENCIL_CHUNK_STEPS"):
        pfp.fused_pencil_chunk(p["r"], p["v"], p["a"], p["tbl"], p["shf"], pgrid.n_pencils,
                               pgrid.capacity, L, RC2, DT, pfp.MAX_PENCIL_CHUNK_STEPS + 1)
