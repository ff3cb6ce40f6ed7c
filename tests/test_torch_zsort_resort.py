"""The zsort engine's resort (``ljmd_tpu_torch/ops/zsort_resort.py``
``zsort_resort``) on the CPU, where it runs its plain twin
``zsort_resort_plain``:

- bit for bit the composition the engine ran before it (its closures
  ``_sort`` and ``_lists`` and its separate travel check), for
  one system and an R=3 stack, z order and (x-slab, z) order, plain and
  extended, float64 and float32, on shuffled rows with padding columns
  scattered among them, particles on both z faces and one particle of the
  last replica past the invalid bound; no kernel counted;
- against the JAX package: its zsort engine's sort (``init`` from one state:
  the rows, ids and lists) and its ``compute_tile_flags``
  (``ljmd_tpu/ops/pallas_fused.py``) on the resorted rows, packed;
- the engine's travel check, folded into the resort, against the separate
  check it replaced, in both sort orders (with slabs, travel along x
  counts), plain and extended, for one system and an R=3 stack: the sticky
  flag and the travel maximum after a chunk whose reference rows put one
  particle of the first and of the last replica past the invalid bound.

The card's kernels are held to this twin in tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _zsort_engine as j_zsort_engine
from ljmd_tpu.ops import pallas_fused as pf
from ljmd_tpu.state import MDState as JState
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import window_lists, zsort_resort
from ljmd_tpu_torch.ops._cuda import LAUNCHES
from ljmd_tpu_torch.ops.geometry import minimum_image
from ljmd_tpu_torch.state import MDState

torch.set_num_threads(1)

# tests/test_torch_zsort.py's two geometries: N=500 at rho* 0.8 in z order
# (n_pad 512, tile_j 512), and N=864 at rho* 0.8 with rc 1.3 in (x-slab, z)
# order (5 slabs, n_pad 896, tile_j 128, skin 0.55).
CASES = {
    "pure_z": (dict(num_cells=5, density=0.8, dt=0.004, target_total_energy=-2300.0), {}),
    "slab": (dict(num_cells=6, density=0.8, rc=1.3, dt=0.004, target_total_energy=-4000.0),
             dict(slab_sort=True, tile_j=128, sort_skin=0.55)),
}


def _jcfg(case, dtype="float64"):
    return config_from_density(dtype=dtype, total_steps=10, warmup_steps=0, **CASES[case][0])


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _geometry(case, cfg):
    return pe.zsort_geometry(cfg, inner_chunk=8, **CASES[case][1])


def _rows(cfg, geo, seed, dtype, plant=False):
    """(r, ru, v, a, ids, rlo, vc, r_ref) of one system in a shuffled column
    order, padding columns among the particles: a perturbed lattice, some
    particles within 1e-6 of both z faces (and at 0 and -0.0), the
    reference rows a small drift away; with ``plant`` one particle's
    reference 0.7 x skin away along z (past the invalid bound). A particle
    in the top z bucket ties with the padding's key and sorts among it by
    column (the engine keeps its particles in the columns below n, so there
    they sort first)."""
    n, L, n_pad = cfg.n, cfg.box_length, geo.n_pad
    gen = torch.Generator().manual_seed(seed)
    lattice = fcc_lattice(cfg.num_cells, L, dtype=torch.float64)
    pos = torch.remainder(lattice + 0.05 * torch.randn(lattice.shape, generator=gen,
                                                      dtype=torch.float64), L)
    pos[0:6, 2] = torch.tensor([1e-7, L - 1e-7, 0.0, -0.0, L * (1 - 1e-12), 2e-6])
    perm = torch.randperm(n_pad, generator=gen)
    ids = torch.where(perm < n, perm, -1).to(torch.int32)
    rows = []
    for k in range(6):
        x = torch.zeros((8, n_pad), dtype=torch.float64)
        src = pos if k == 0 else torch.randn((n, 3), generator=gen, dtype=torch.float64)
        if k >= 4:
            src = 1e-9 * src
        x[0:3, ids >= 0] = src.T[:, ids[ids >= 0].long()]
        rows.append(x)
    r_ref = rows[0].clone()
    r_ref[0:3] = torch.remainder(r_ref[0:3] + 0.01 * torch.randn(
        (3, n_pad), generator=gen, dtype=torch.float64), L) * (ids >= 0)
    if plant:
        col = int(torch.nonzero(ids >= 0)[3])
        r_ref[2, col] = torch.remainder(rows[0][2, col] - 0.7 * geo.sort_skin + L, L)
    r, ru, v, a, rlo, vc = (t.to(dtype) for t in rows)
    return r, ru, v, a, ids, rlo, vc, r_ref.to(dtype)


def _old_resort(r8, ru8, v8, a8, ids, rlo, vcc, geo, n, L, extended, replicas):
    """The engine's resort before ``zsort_resort``: its closures ``_sort``
    and ``_lists``, as they were."""
    n_pad, zq_bits, bits_pad = geo.n_pad, geo.zq_bits, geo.bits_pad
    batch = () if replicas is None else (replicas,)
    col = torch.arange(n_pad, dtype=torch.int32)
    zq = torch.clamp((r8[..., 2, :] * ((1 << zq_bits) / L)).to(torch.int32), 0,
                     (1 << zq_bits) - 1)
    if geo.slab_sort:
        xb = torch.clamp((r8[..., 0, :] * (geo.n_slabs / L)).to(torch.int32), 0,
                         geo.n_slabs - 1)
        kq = (xb << zq_bits) | zq
    else:
        kq = zq
    kq = torch.where(ids >= 0, kq, (1 << (30 - bits_pad)) - 1)
    packed = torch.sort((kq << bits_pad) | col, dim=-1).values
    order = (packed & ((1 << bits_pad) - 1)).long()
    parts = [r8[..., 0:3, :], ru8[..., 0:3, :], v8[..., 0:3, :], a8[..., 0:3, :]]
    if extended:
        parts += [rlo[..., 0:3, :], vcc[..., 0:3, :]]
    stacked = torch.cat(parts, dim=-2)
    if replicas is None:
        stacked, ids = stacked[:, order], ids[order]
    else:
        stacked = torch.take_along_dim(stacked, order[:, None, :], dim=-1)
        ids = torch.take_along_dim(ids, order, dim=-1)
    pad5 = torch.zeros(batch + (5, n_pad), dtype=r8.dtype)

    def emb(k):
        return torch.cat([stacked[..., 3 * k:3 * k + 3, :], pad5], dim=-2)

    rlo2, vcc2 = (emb(4), emb(5)) if extended else (rlo, vcc)
    r_new = emb(0)
    flags = window_lists.compute_tile_flags(r_new, n, 128, 128, L, geo.window,
                                            x_window=geo.window if geo.slab_sort else None,
                                            cross_margin=0.6 * geo.sort_skin)
    tiles, tcounts = window_lists.build_window_lists(flags, n, n_pad, 128, geo.tile_j)
    return r_new, emb(1), emb(2), emb(3), ids, rlo2, vcc2, tiles, tcounts


def _old_check(r, r_ref, ids, invalid, travel2, geo, L, replicas):
    """The engine's travel check before the fold (``_maybe_resort``)."""
    d = minimum_image(r[..., 0:3, :] - r_ref[..., 0:3, :], L)
    valid = (ids >= 0).to(r.dtype)
    dz2 = d[..., 2, :] * d[..., 2, :]
    x = (torch.maximum(d[..., 0, :] * d[..., 0, :], dz2) if geo.slab_sort else dz2) * valid
    moved2 = torch.max(x) if replicas is None else torch.amax(x, dim=-1)
    return invalid | (moved2 > geo.invalid_thresh), torch.maximum(travel2, moved2)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bool or not got.is_floating_point():
        assert torch.equal(got, want)
        return
    ints = torch.int64 if got.dtype == torch.float64 else torch.int32
    assert torch.equal(got.contiguous().view(ints), want.contiguous().view(ints))


def _same_lists(tiles, tcounts, want_tiles, want_counts):
    """Equal counts, and equal entries on each list's count prefix."""
    assert torch.equal(tcounts, want_counts)
    for c, k in enumerate(want_counts.tolist()):
        rows = ([2 * c, 2 * c + 1] + ([8] if c == 3 else [])) if c < 4 else \
            [9 + 2 * (c - 4), 10 + 2 * (c - 4)]
        assert torch.equal(tiles[rows, :k], want_tiles[rows, :k])


@pytest.mark.parametrize("replicas", [None, 3], ids=["one", "stacked"])
@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_plain_resort_equals_the_engine_chain(dtype, case, extended, replicas):
    cfg = _port_cfg(_jcfg(case))
    geo = _geometry(case, cfg)
    n, L = cfg.n, cfg.box_length
    reps = 1 if replicas is None else replicas
    parts = [_rows(cfg, geo, 11 + q, dtype, plant=q == reps - 1) for q in range(reps)]
    if replicas is None:
        r, ru, v, a, ids, rlo, vc, r_ref = parts[0]
    else:
        r, ru, v, a, ids, rlo, vc, r_ref = (torch.stack(ts) for ts in zip(*parts))
    if not extended:
        rlo, vc = torch.zeros_like(rlo), torch.zeros_like(vc)
    batch = () if replicas is None else (replicas,)
    invalid = torch.zeros(batch, dtype=torch.bool)
    travel2 = torch.full(batch, 1e-4, dtype=dtype)
    resorts = torch.full(batch, 7, dtype=torch.int32)
    want = _old_resort(r, ru, v, a, ids, rlo, vc, geo, n, L, extended, replicas)
    want_invalid, want_travel2 = _old_check(r, r_ref, ids, invalid, travel2, geo, L, replicas)
    assert want_invalid.flatten().tolist() == [False] * (reps - 1) + [True]
    LAUNCHES.reset()
    got = zsort_resort.zsort_resort(r, ru, v, a, ids, rlo, vc, geo, n, L, extended,
                                    resorts=resorts, check=(r_ref, invalid, travel2))
    assert sum(LAUNCHES.snapshot().values()) == 0
    for g, w in zip(got[:7], want[:7]):
        _same_bits(g, w)
    if not extended:
        assert got.rlo is rlo and got.vc is vc
    for q in range(reps):
        pick = (lambda t: t) if replicas is None else (lambda t: t[q])  # noqa: E731
        _same_lists(pick(got.tiles), pick(got.tcounts), pick(want[7]), pick(want[8]))
    _same_bits(got.invalid, want_invalid)
    _same_bits(got.travel2, want_travel2)
    _same_bits(got.resorts, resorts + 1)
    # Without the check or the counter nothing of theirs comes back.
    bare = zsort_resort.zsort_resort(r, ru, v, a, ids, rlo, vc, geo, n, L, extended)
    assert bare.resorts is None and bare.invalid is None and bare.travel2 is None
    _same_bits(bare.r, want[0])


@pytest.mark.parametrize("case", list(CASES))
def test_resort_matches_the_jax_sort_and_flags(case):
    """From one state the JAX engine's ``init`` (its packed-key sort and its
    lists) and ``zsort_resort`` give the same sorted rows, ids and lists;
    and on the resorted rows of an R=2 stack, JAX's ``compute_tile_flags``
    packed are each replica's lists."""
    jcfg = _jcfg(case)
    cfg = _port_cfg(jcfg)
    geo = _geometry(case, cfg)
    n, L, n_pad = cfg.n, cfg.box_length, geo.n_pad
    rng = np.random.default_rng(5)
    lattice = fcc_lattice(cfg.num_cells, L, dtype=torch.float64).numpy()
    pos = np.mod(lattice + rng.normal(scale=0.05, size=lattice.shape), L)
    vel = rng.normal(size=pos.shape)
    je = j_zsort_engine(jcfg, interpret=True, inner_chunk=8, **CASES[case][1])
    jc, _ = jax.jit(je.init)(JState(r=jnp.asarray(pos), ru=jnp.asarray(pos),
                                    v=jnp.asarray(vel), a=jnp.zeros_like(jnp.asarray(pos))))

    def to_rows(x):
        out = torch.zeros((8, n_pad), dtype=torch.float64)
        out[0:3, :n] = torch.as_tensor(x).T
        return out

    zero = torch.zeros((8, n_pad), dtype=torch.float64)
    col = torch.arange(n_pad, dtype=torch.int32)
    got = zsort_resort.zsort_resort(to_rows(pos), to_rows(pos), to_rows(vel), zero,
                                    torch.where(col < n, col, -1), zero, zero, geo, n, L, False)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(jc.ids))
    for name in ("r", "ru", "v"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jc, name)))
    _same_lists(got.tiles, got.tcounts, torch.as_tensor(np.array(jc.tiles)),
                torch.as_tensor(np.array(jc.tcounts)))

    # A stack: JAX's flags of each replica's resorted rows, packed.
    parts = [_rows(cfg, geo, 21 + q, torch.float64) for q in range(2)]
    r, ru, v, a, ids, rlo, vc, _ = (torch.stack(ts) for ts in zip(*parts))
    got = zsort_resort.zsort_resort(r, ru, v, a, ids, rlo, vc, geo, n, L, False)
    for q in range(2):
        flags = pf.compute_tile_flags(jnp.asarray(got.r[q].numpy()), n, 128, 128, L, geo.window,
                                      x_window=geo.window if geo.slab_sort else None,
                                      cross_margin=0.6 * geo.sort_skin)
        tiles, tcounts = window_lists.build_window_lists_plain(
            torch.as_tensor(np.asarray(flags)), n, n_pad, 128, geo.tile_j)
        _same_lists(got.tiles[q], got.tcounts[q], tiles, tcounts)


@pytest.mark.parametrize("replicas", [None, 3], ids=["one", "stacked"])
@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
@pytest.mark.parametrize("case", list(CASES))
def test_folded_check_matches_the_separate_check(case, extended, replicas):
    """A chunk (of two steps) after one whose reference rows put a particle
    of the first and of the last replica 0.9 x skin from it along a sorted
    axis (z; x in
    the slab order, where x travel counts): the check runs inside the
    resort, and the carry's flag and travel maximum are the separate
    check's formula on the carry before the chunk; a replica between them
    keeps its flag clear, and every chunk resorts."""
    cfg = _port_cfg(_jcfg(case))
    lattice = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    state = MDState(r=lattice, ru=lattice, v=torch.randn(lattice.shape, generator=gen,
                                                           dtype=torch.float64),
                    a=torch.zeros_like(lattice))
    if replicas is not None:
        state = pe.stack_states([state] * replicas)
    eng = pe._zsort_engine(cfg, "cpu", inner_chunk=8, extended=extended, replicas=replicas,
                           **CASES[case][1])
    geo = _geometry(case, cfg)
    c = eng.run_fast(eng.init(state)[0], 2)
    reps = replicas or 1
    planted = sorted({0, reps - 1})
    axis = 0 if geo.slab_sort else 2
    ref = c.r_ref.clone().reshape(reps, 8, geo.n_pad)
    r = c.r.reshape(reps, 8, geo.n_pad)
    for q in planted:
        col = int(torch.nonzero(c.ids.reshape(reps, geo.n_pad)[q] >= 0)[5])
        ref[q, axis, col] = torch.remainder(r[q, axis, col] - 0.9 * geo.sort_skin,
                                            cfg.box_length)
    c = dataclasses.replace(c, r_ref=ref.reshape(c.r_ref.shape))
    want_invalid, want_travel2 = _old_check(c.r, c.r_ref, c.ids, c.invalid, c.travel2, geo,
                                            cfg.box_length, replicas)
    assert want_invalid.flatten().tolist() == [q in planted for q in range(reps)]
    out = eng.run_fast(c, 2)
    _same_bits(out.invalid, want_invalid)
    _same_bits(out.travel2, want_travel2)
    _same_bits(out.resorts, c.resorts + 1)
