"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips (from its fixture, never at import) where
``torch.cuda.is_available()`` is False. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Float64 tolerances: the per-pair arithmetic is bit-identical between kernel
and twin, so only the summation order differs (1e-10 relative to the array's
scale is far above it).
"""

import numpy as np
import pytest
import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.simulation import initialize, run_production
from ljmd_tpu_torch.ops import fused, pair_sweep, pair_terms
from ljmd_tpu_torch.ops._cuda import LAUNCHES

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(n, box, seed, device):
    rng = np.random.default_rng(seed)
    out = torch.zeros((8, 256), dtype=torch.float64)
    out[0:3, :n] = torch.as_tensor(rng.uniform(0, box, (3, n)))
    return out.to(device)


def _close(got, want, tol=1e-10):
    got, want = got.double().cpu(), want.double().cpu()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


def test_pair_terms_kernel_is_bit_identical_to_twin(cuda):
    r2 = torch.linspace(0.09, 7.0, 50_000, dtype=torch.float64, device=cuda)
    mask = r2 < 6.25
    got = pair_terms.lj_pair_terms(r2, mask, True)
    want = pair_terms.lj_pair_terms_plain(r2, mask, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(pair_terms.lj_pair_terms(r2, mask, False)[0], got[0])


@pytest.mark.parametrize("want_obs", [True, False])
def test_tri_sweep_kernel_matches_twin(cuda, want_obs):
    pos = _rows(200, 7.0, 1, cuda)
    got = pair_sweep.pair_sweep_tri(pos, 200, 7.0, 6.25, want_obs)
    want = pair_sweep.pair_sweep_tri_plain(pos, 200, 7.0, 6.25, want_obs)
    for row in range(8):
        _close(got[row], want[row])
    assert bool((got[:, 200:] == 0).all())


@pytest.mark.parametrize("extended", [False, True])
def test_fused_chunk_kernel_matches_twin(cuda, extended):
    n, box, rc2, dt = 108, 5.13, 6.25, 0.004
    r = torch.zeros((8, 128), dtype=torch.float64, device=cuda)
    grid = torch.stack(torch.meshgrid(*(torch.arange(3.0),) * 3, indexing="ij"), -1).reshape(-1, 3)
    basis = torch.tensor([[0, 0, 0], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]],
                         dtype=torch.float64)
    r[0:3, :n] = ((grid[:, None] + basis[None]) * box / 3).reshape(-1, 3).T.to(cuda)
    v = torch.zeros_like(r)
    v[0:3, :n] = torch.as_tensor(np.random.default_rng(2).uniform(-0.5, 0.5, (3, n)), device=cuda)
    a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc2)
    if extended:
        zero = torch.zeros_like(r)
        got = fused.fused_dense_chunk_ext(r, zero, v, zero, a, n, box, rc2, dt, 25)
        want = fused.fused_dense_chunk_ext_plain(r, zero, v, zero, a, n, box, rc2, dt, 25)
        pairs = [(got[0] + got[1], want[0] + want[1]), (got[2] + got[3], want[2] + want[3]),
                 (got[4], want[4])]
    else:
        got = fused.fused_dense_chunk(r, v, a, n, box, rc2, dt, 25)
        want = fused.fused_dense_chunk_plain(r, v, a, n, box, rc2, dt, 25)
        pairs = list(zip(got, want))
    for g, w in pairs:
        _close(g, w)


def test_kernels_refuse_what_they_do_not_take(cuda):
    pos = _rows(200, 7.0, 3, cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        pair_sweep.pair_sweep_tri(pos[:, :200].contiguous(), 200, 7.0, 6.25)
    with pytest.raises(ValueError, match="contiguous"):
        pair_sweep.pair_sweep_tri(pos.t().contiguous().t(), 200, 7.0, 6.25)
    with pytest.raises(TypeError):
        pair_sweep.pair_sweep_tri(pos.half(), 200, 7.0, 6.25)
    with pytest.raises(ValueError, match="MAX_CHUNK_STEPS"):
        fused.fused_dense_chunk(pos, pos, pos, 200, 7.0, 6.25, 1e-3, fused.MAX_CHUNK_STEPS + 1)


def test_production_on_card_matches_cpu_and_launches_kernels(cuda):
    cfg = SimConfig(num_cells=3, box_length=5.13, rc_over_box=0.48, dt=0.003,
                    total_steps=120, output_interval=20, warmup_steps=30,
                    target_total_energy=-500.0, dtype="float64")
    state = initialize(cfg.replace(warmup_steps=20), device="cpu")
    cpu = run_production(cfg, state, device="cpu")
    LAUNCHES.reset()
    gpu = run_production(cfg, state.to(device=cuda), device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["pair_sweep_tri"] > 0 and counts["fused_dense_chunk"] > 0
    np.testing.assert_allclose(gpu.series.cpu().numpy(), cpu.series.numpy(), rtol=1e-9)
    assert pe.make_engine(cfg, "rows", cuda).run_fast is not None


def _sorted_lattice(num_cells, box, n_pad, seed):
    from ljmd_tpu_torch.models.lattice import fcc_lattice

    rng = np.random.default_rng(seed)
    r = fcc_lattice(num_cells, box, dtype=torch.float64).numpy()
    r = np.mod(r + rng.normal(scale=0.05, size=r.shape), box)
    r = r[np.argsort(r[:, 2])]
    rows = torch.zeros((8, n_pad), dtype=torch.float64)
    rows[0:3, :len(r)] = torch.as_tensor(r.T)
    return len(r), rows


@pytest.mark.parametrize("tail_tiles", [True, False])
@pytest.mark.parametrize("n_pad,tile_j,seed", [(4096, 512, 1), (896, 512, 2), (2048, 384, 3),
                                              (4096, 768, 4)])
def test_pack_kernel_matches_twin(cuda, n_pad, tile_j, seed, tail_tiles):
    """Kernel 9: the same lists as the sequential twin, element for element
    on the count prefix, on random and realistic flags."""
    from ljmd_tpu_torch.ops import window_lists

    n_b = n_pad // 128
    rng = np.random.default_rng(seed)
    cases = [torch.as_tensor(rng.integers(0, 8, n_b * n_b).astype(np.int32))]
    num_cells, box = {896: (6, 10.0776), 2048: (7, 11.757), 4096: (10, 16.796)}[n_pad]
    n, rows = _sorted_lattice(num_cells, box, n_pad, seed)
    cases.append(window_lists.compute_tile_flags(rows, n, 128, 128, box, 3.2,
                                                 cross_margin=0.36))
    for flags in cases:
        want_t, want_c = window_lists.build_window_lists_plain(flags, n, n_pad, 128, tile_j,
                                                               tail_tiles=tail_tiles)
        got_t, got_c = window_lists.build_window_lists(flags.to(cuda), n, n_pad, 128, tile_j,
                                                       tail_tiles=tail_tiles)
        got_t, got_c = got_t.cpu(), got_c.cpu()
        assert torch.equal(got_c, want_c)
        for c, k in enumerate(want_c.tolist()):
            lrows = ([2 * c, 2 * c + 1] + ([8] if c == 3 else [])) if c < 4 else \
                [9 + 2 * (c - 4), 10 + 2 * (c - 4)]
            assert torch.equal(got_t[lrows, :k], want_t[lrows, :k])


@pytest.mark.parametrize("mode", ["plain", "extended", "obs_last"])
def test_list_chunk_kernel_matches_twin(cuda, mode):
    """Kernel 10 against its twin at N=864 (n_pad 896, tile_j 256) with
    weighted random flags, so every category and the tails occur."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    box, rc2 = 10.0776, 6.25
    n, r = _sorted_lattice(6, box, 896, 5)
    rng = np.random.default_rng(9)
    v = torch.zeros_like(r)
    v[0:3, :n] = torch.as_tensor(rng.uniform(-1.0, 1.0, (3, n)))
    a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc2)
    flags = torch.as_tensor(np.random.default_rng(6).choice(
        [0, 1, 3, 5, 7], p=[0.3, 0.4, 0.1, 0.1, 0.1], size=(49,)).astype(np.int32))
    tiles, counts = window_lists.build_window_lists_plain(flags, n, 896, 128, 256)
    assert (counts > 0).all()
    extended, obs_last = mode == "extended", mode == "obs_last"
    kw = dict(r_lo=torch.zeros_like(r), vc=torch.zeros_like(r)) if extended else {}
    want = fused_list.fused_dense_chunk_list(r, v, a, tiles, counts, n, box, rc2, 0.004, 6,
                                             tile_j=256, obs_last=obs_last, **kw)
    kw = {k: t.to(cuda) for k, t in kw.items()}
    got = fused_list.fused_dense_chunk_list(r.to(cuda), v.to(cuda), a.to(cuda), tiles.to(cuda),
                                            counts.to(cuda), n, box, rc2, 0.004, 6, tile_j=256,
                                            obs_last=obs_last, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_zsort_production_on_card_matches_cpu(cuda):
    cfg = SimConfig(num_cells=5, box_length=8.55, rc_over_box=2.5 / 8.55, dt=0.003,
                    total_steps=60, output_interval=20, warmup_steps=20,
                    target_total_energy=-2300.0, dtype="float64")
    state = initialize(cfg.replace(warmup_steps=20), device="cpu")
    cpu = run_production(cfg, state, backend="zsort", device="cpu")
    LAUNCHES.reset()
    gpu = run_production(cfg, state.to(device=cuda), backend="zsort", device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["zsort_sort"] == counts["zsort_pack"] > 0
    assert counts["fused_dense_chunk_list"] > 0
    assert counts["fused_dense_chunk"] == 0 and counts["build_window_lists"] == 0
    np.testing.assert_allclose(gpu.series.cpu().numpy(), cpu.series.numpy(), rtol=1e-9)
    assert not bool(gpu.diagnostics["zsort_invalid"])
    assert pe.auto_backend(cfg, True) == "rows"  # L < 4 rc: JAX's accelerator branch


def _zsort_rows(cfg, geo, seed, dtype, cuda, extended=False, plant=False):
    """(rows, r_ref) of one zsort system on the card: a perturbed lattice in
    a shuffled column order with the padding columns among the particles,
    particles within 1e-6 of both z faces (and at 0, -0.0 and the last
    float below L) and of both x faces; rows = (r, ru, v, a, ids, rlo, vc)
    (rlo, vc small with ``extended``, else zero); r_ref a small drift away,
    with ``plant`` one particle's 0.7 x skin away along z (past the invalid
    bound)."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice

    n, L, n_pad = cfg.n, cfg.box_length, geo.n_pad
    gen = torch.Generator().manual_seed(seed)
    lattice = fcc_lattice(cfg.num_cells, L, dtype=torch.float64)
    pos = torch.remainder(lattice + 0.05 * torch.randn(lattice.shape, generator=gen,
                                                      dtype=torch.float64), L)
    top = float(np.nextafter(np.float32(L), np.float32(0)))
    pos[0:6, 2] = torch.tensor([1e-7, L - 1e-7, 0.0, -0.0, top, 2e-6])
    pos[6:9, 0] = torch.tensor([5e-7, L - 5e-7, 0.0])
    perm = torch.randperm(n_pad, generator=gen)
    ids = torch.where(perm < n, perm, -1).to(torch.int32)
    rows = []
    for k in range(6):
        x = torch.zeros((8, n_pad), dtype=torch.float64)
        src = pos if k == 0 else torch.randn((n, 3), generator=gen, dtype=torch.float64)
        if k >= 4:
            src = 1e-9 * src if extended else 0.0 * src
        x[0:3, ids >= 0] = src.T[:, ids[ids >= 0].long()]
        rows.append(x)
    ref = rows[0].clone()
    ref[0:3] = torch.remainder(ref[0:3] + 0.01 * torch.randn(
        (3, n_pad), generator=gen, dtype=torch.float64), L) * (ids >= 0)
    if plant:
        col = int(torch.nonzero(ids >= 0)[3])
        ref[2, col] = torch.remainder(rows[0][2, col] - 0.7 * geo.sort_skin + L, L)
    r, ru, v, a, rlo, vc = (t.to(device=cuda, dtype=dtype) for t in rows)
    return (r, ru, v, a, ids.to(cuda), rlo, vc), ref.to(device=cuda, dtype=dtype)


def _stack_zsort_rows(parts):
    rows = tuple(torch.stack(ts).contiguous() for ts in zip(*(p[0] for p in parts)))
    return rows, torch.stack([p[1] for p in parts]).contiguous()


def _resort_on_card(geo, n, L, extended, rows, resorts=None, check=None, glob=False):
    """The resort's kernels (two launches) against the torch chain on the
    same CUDA tensors, bit for bit: rows, ids, lists on their counts, the
    counter, the flag and the travel maximum."""
    from ljmd_tpu_torch.ops import zsort_resort

    want = zsort_resort.zsort_resort_plain(*rows, geo, n, L, extended, resorts=resorts,
                                           check=check)
    LAUNCHES.reset()
    got = zsort_resort.zsort_resort(*rows, geo, n, L, extended, resorts=resorts, check=check)
    stacked = rows[0].dim() == 3
    suffix = "_replicas" if stacked else ""
    launches = LAUNCHES.snapshot()
    assert launches["zsort_sort" + suffix] == launches["zsort_pack" + suffix] == 1
    assert launches["zsort_sort_global"] == int(glob)
    assert sum(launches.values()) == 2 + int(glob)
    for name in ("r", "ru", "v", "a", "ids", "rlo", "vc", "resorts", "invalid", "travel2"):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.shape == w.shape and g.dtype == w.dtype, name
            assert torch.equal(_bits(g), _bits(w)), name
    tiles, counts = got.tiles.cpu(), got.tcounts.cpu()
    want_tiles, want_counts = want.tiles.cpu(), want.tcounts.cpu()
    assert torch.equal(counts, want_counts)
    for q in range(rows[0].shape[0] if stacked else 1):
        t, c, wt = (x[q] if stacked else x for x in (tiles, counts, want_tiles))
        for cat, k in enumerate(c.tolist()):
            lrows = ([2 * cat, 2 * cat + 1] + ([8] if cat == 3 else [])) if cat < 4 else \
                [9 + 2 * (cat - 4), 10 + 2 * (cat - 4)]
            assert torch.equal(t[lrows, :k], wt[lrows, :k])
    return got


def _n4000():
    import os

    from ljmd_tpu_torch.config import load_config

    return load_config(os.path.join(os.path.dirname(__file__), "..", "examples",
                                    "n4000_production.json"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["z", "slab", "extended", "invalid"])
def test_zsort_resort_kernels_match_the_torch_chain(cuda, case, dtype):
    """``zsort_resort``'s kernels against the torch chain at config 3's
    geometry (N=4000 in n_pad 4096): z order, (x-slab, z) order (5 slabs,
    tile_j 768), the extended mode, and a particle past the invalid bound
    with the folded check (the flag raised); with and without the check and
    the counter."""
    cfg = _n4000()
    geo = pe.zsort_geometry(cfg, slab_sort=case == "slab")
    assert geo.n_pad == 4096 and geo.slab_sort == (case == "slab")
    rows, ref = _zsort_rows(cfg, geo, 3, dtype, cuda, extended=case == "extended",
                            plant=case == "invalid")
    args = (geo, cfg.n, cfg.box_length, case == "extended", rows)
    invalid = torch.zeros((), dtype=torch.bool, device=cuda)
    travel2 = torch.full((), 1e-4, dtype=dtype, device=cuda)
    resorts = torch.full((), 5, dtype=torch.int32, device=cuda)
    got = _resort_on_card(*args, resorts=resorts, check=(ref, invalid, travel2))
    assert bool(got.invalid) == (case == "invalid") and int(got.resorts) == 6
    _resort_on_card(*args)
    _resort_on_card(*args, check=(ref, torch.ones_like(invalid), travel2))


def test_zsort_resort_kernels_over_a_replica_stack(cuda):
    """R=3 systems (the last with a particle past the invalid bound): each
    replica's rows, lists, flag and travel those of the torch chain, and the
    stack's replica q those of a one-system resort of replica q."""
    cfg = _n4000()
    geo = pe.zsort_geometry(cfg)
    parts = [_zsort_rows(cfg, geo, 7 + q, torch.float32, cuda, plant=q == 2) for q in range(3)]
    rows, ref = _stack_zsort_rows(parts)
    invalid = torch.zeros((3,), dtype=torch.bool, device=cuda)
    travel2 = torch.zeros((3,), dtype=torch.float32, device=cuda)
    resorts = torch.arange(3, dtype=torch.int32, device=cuda)
    got = _resort_on_card(geo, cfg.n, cfg.box_length, False, rows, resorts=resorts,
                          check=(ref, invalid, travel2))
    assert got.invalid.tolist() == [False, False, True]
    assert got.resorts.tolist() == [1, 2, 3]
    one = _resort_on_card(geo, cfg.n, cfg.box_length, False, parts[1][0],
                          check=(parts[1][1], invalid[1], travel2[1]))
    for name in ("r", "ru", "v", "a", "ids", "tcounts", "travel2"):
        assert torch.equal(_bits(getattr(got, name)[1]), _bits(getattr(one, name))), name


@pytest.mark.parametrize("replicas", [None, 2])
def test_zsort_resort_kernels_past_the_shared_keys(cuda, replicas):
    """N=37,044 (21^3 FCC cells at rho* 0.8442) in n_pad 37,120: its 65,536
    padded keys pass the sort kernel's shared memory, so it sorts in a global
    scratch row (``zsort_sort_global``); (x-slab, z) order, as the geometry
    picks at this size; the kernels give the torch chain's bits."""
    cfg = SimConfig(num_cells=21, box_length=(37044 / 0.8442) ** (1.0 / 3.0),
                    rc_over_box=2.5 / (37044 / 0.8442) ** (1.0 / 3.0))
    geo = pe.zsort_geometry(cfg)
    assert geo.n_pad == 37120 and geo.slab_sort and not geo.fused_viable
    reps = replicas or 1
    parts = [_zsort_rows(cfg, geo, 13 + q, torch.float32, cuda, plant=q == reps - 1)
             for q in range(reps)]
    rows, ref = parts[0] if replicas is None else _stack_zsort_rows(parts)
    batch = () if replicas is None else (replicas,)
    check = (ref, torch.zeros(batch, dtype=torch.bool, device=cuda),
             torch.zeros(batch, dtype=torch.float32, device=cuda))
    got = _resort_on_card(geo, cfg.n, cfg.box_length, False, rows, check=check, glob=True)
    assert got.invalid.flatten().tolist() == [False] * (reps - 1) + [True]


def test_zsort_run_sample_on_card_equals_the_twin_engine(cuda, monkeypatch):
    """Config 3's engine on the card for a 50-step ``run_sample`` (chunks 16,
    16, 16, 2: four resorts after init's), once through the resort's kernels
    and once through its torch chain (``zsort_resort_plain``): the final
    carries bit for bit, the observables too; the kernel run launches no
    ``torch.sort`` chain (no standalone pack)."""
    import dataclasses

    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import zsort_resort
    from ljmd_tpu_torch.state import MDState

    cfg = _n4000()
    gen = torch.Generator().manual_seed(9)
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64)
    v = 0.9 * torch.randn(r.shape, generator=gen, dtype=torch.float64)
    state = MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)).to(device=cuda)
    out = {}
    for name in ("kernels", "twin"):
        if name == "twin":
            monkeypatch.setattr(pe, "zsort_resort", zsort_resort.zsort_resort_plain)
        eng = pe.make_engine(cfg, "zsort", cuda, state=state, sample_interval=50)
        LAUNCHES.reset()
        c, _ = eng.init(state)
        c, obs = eng.run_sample(c, 50)
        out[name] = (c, obs, LAUNCHES.snapshot())
    (ck, ok, lk), (ct, ot, lt) = out["kernels"], out["twin"]
    assert lk["zsort_sort"] == lk["zsort_pack"] == 5 and lk["build_window_lists"] == 0
    assert lt["zsort_sort"] == 0 and lt["build_window_lists"] == 5
    for f in dataclasses.fields(ck):
        g, w = getattr(ck, f.name), getattr(ct, f.name)
        if f.name == "tiles":  # entries past the counts are not written
            for cat, k in enumerate(ck.tcounts.tolist()):
                lrows = ([2 * cat, 2 * cat + 1] + ([8] if cat == 3 else [])) if cat < 4 else \
                    [9 + 2 * (cat - 4), 10 + 2 * (cat - 4)]
                assert torch.equal(g[lrows, :k], w[lrows, :k])
            continue
        assert torch.equal(_bits(g), _bits(w)), f.name
    for k in ("epot", "ekin", "d_epot", "dd_epot"):
        assert torch.equal(_bits(getattr(ok, k)), _bits(getattr(ot, k))), k
    assert not bool(ck.invalid) and int(ck.resorts) == 4


def _pencil_carry(extended=False):
    """A cell-pair carry at tests/test_pencil_fused.py's geometry (N=2048,
    L=13.4, 4x4 pencils of capacity 256, counts straddling 128), built by
    the port on the CPU, with seeded velocities."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.state import MDState

    cfg = SimConfig(num_cells=8, box_length=13.4, rc_over_box=2.5 / 13.4, dt=0.004,
                    dtype="float64", target_total_energy=-9000.0)
    rng = np.random.default_rng(3)
    r = fcc_lattice(8, 13.4, dtype=torch.float64)
    r = torch.remainder(r + torch.as_tensor(rng.normal(0, 0.05, r.shape)), 13.4)
    v = torch.as_tensor(rng.normal(0, 1.0, r.shape))
    eng = pe._cellpair_engine(cfg, "cpu", compensated=extended, width_lists=True)
    carry, _ = eng.init(MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)))
    return cfg, carry


@pytest.mark.parametrize("want_obs", [True, False])
def test_pencil_sweep_kernel_matches_twin(cuda, want_obs):
    """Kernels 13 + 14 against the twin, every output row."""
    from ljmd_tpu_torch.ops import cell_list, pencil_sweep

    cfg, c = _pencil_carry()
    grid = cell_list.make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                      cfg.density)
    tbl, shf = (torch.as_tensor(t) for t in pencil_sweep.build_half_shell_tables(grid))
    want = pencil_sweep.pencil_sweep_hs(c.r, tbl, c.counts, shf, grid, cfg.rc_square, want_obs)
    LAUNCHES.reset()
    got = pencil_sweep.pencil_sweep_hs(c.r.to(cuda), tbl.to(cuda), c.counts.to(cuda),
                                       shf.to(cuda), grid, cfg.rc_square, want_obs)
    assert LAUNCHES.snapshot()["pencil_sweep_hs"] == 1
    for row in range(8):
        _close(got[row], want[row])


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("kind", ["static", "width"])
def test_fused_pencil_kernels_match_twin(cuda, kind, extended):
    """Kernels 15 and 16 against their twins: 6 steps, plain and extended."""
    from ljmd_tpu_torch.ops import cell_list, fused_pencil, pencil_sweep

    cfg, c = _pencil_carry(extended)
    m = 4
    P, cap = m * m, c.r.shape[1] // (m * m)
    grid = cell_list.make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                      cfg.density)
    assert (grid.n_pencils, grid.capacity) == (P, cap)
    tbl, shf = (torch.as_tensor(t) for t in pencil_sweep.build_half_shell_tables(grid))
    args = (P, cap, cfg.box_length, cfg.rc_square, cfg.dt, 6)
    ext = dict(r_lo=c.rc, vc=c.vc) if extended else {}
    if kind == "static":
        want = fused_pencil.fused_pencil_chunk(c.r, c.v, c.a, tbl, shf, *args, **ext)
        got = fused_pencil.fused_pencil_chunk(c.r.to(cuda), c.v.to(cuda), c.a.to(cuda),
                                              tbl.to(cuda), shf.to(cuda), *args,
                                              **{k: t.to(cuda) for k, t in ext.items()})
    else:
        lists = (c.wl_self, c.wl_self_cnt, c.wl_nbr_i, c.wl_nbr_j, c.wl_nbr_off)
        want = fused_pencil.fused_pencil_width_chunk(c.r, c.v, c.a, *lists, *args, **ext)
        got = fused_pencil.fused_pencil_width_chunk(
            c.r.to(cuda), c.v.to(cuda), c.a.to(cuda), *(t.to(cuda) for t in lists), *args,
            **{k: t.to(cuda) for k, t in ext.items()})
    assert len(got) == len(want) == (5 if extended else 3)
    for g, w in zip(got, want):
        _close(g, w)


def test_cellpair_production_on_card_matches_cpu(cuda):
    """A short cell-pair production on the card (fused static chunks and
    sampled sweeps) against the same on the CPU, float64."""
    cfg = SimConfig(num_cells=5, box_length=9.1, rc_over_box=2.5 / 9.1, dt=0.002,
                    total_steps=60, output_interval=10, warmup_steps=10, neighbor_skin=0.3,
                    target_total_energy=-2000.0, dtype="float64")
    state = initialize(cfg, backend="rows", device="cpu")
    cpu = run_production(cfg, state, backend="cellpair", device="cpu")
    LAUNCHES.reset()
    gpu = run_production(cfg, state.to(device=cuda), backend="cellpair", device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["pencil_sweep_hs"] > 0 and counts["fused_pencil_chunk"] > 0
    assert counts["fused_dense_chunk"] == 0
    # The "always" trigger: one rebin (two launches) before every chunk.
    assert counts["rebin_keys"] == counts["rebin_gather"] == counts["fused_pencil_chunk"]
    np.testing.assert_allclose(gpu.series.cpu().numpy(), cpu.series.numpy(), rtol=1e-9)
    assert not bool(gpu.diagnostics["pencil_overflow"])


def _bits(t):
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _rebin_on_card(grid, r, others, overflow, replicas=None, wrap=True, ref=None, thresh=0.0,
                   drift_max=None):
    """The rebin's kernels (two launches) against the torch chain on the
    same CUDA tensors, bit for bit: rows, carried fields, counts, flag; with
    the folded check, also the running drift max (from ``drift_max``, else
    from zeros and from a larger one, which it keeps)."""
    from ljmd_tpu_torch.ops import pencil_rebin

    want = pencil_rebin.rebin_slots_plain(r, others, grid, overflow, replicas, wrap, False, ref,
                                          thresh)
    LAUNCHES.reset()
    got = pencil_rebin.rebin_slots(r, others, grid, overflow, replicas=replicas, wrap=wrap,
                                   drift_ref=ref, drift_thresh=thresh)
    suffix = "" if replicas is None else "_replicas"
    launches = LAUNCHES.snapshot()
    assert launches["rebin_keys" + suffix] == launches["rebin_gather" + suffix] == 1
    assert sum(launches.values()) == 2
    assert len(got) == 5 and got[4] is None and want[4] is None
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert len(got[1]) == len(want[1]) == len(others)
    for g, w in zip(got[1], want[1]):
        assert torch.equal(_bits(g), _bits(w))
    assert got[2].dtype == torch.int32 and torch.equal(got[2].cpu(), want[2].cpu())
    assert got[3].shape == overflow.shape and torch.equal(got[3].cpu(), want[3].cpu())
    if ref is not None:
        shape = () if replicas is None else (replicas,)
        starts = [drift_max] if drift_max is not None else [
            torch.zeros(shape, dtype=r.dtype, device=r.device),
            torch.full(shape, 1e30, dtype=r.dtype, device=r.device)]
        for start in starts:
            w = pencil_rebin.rebin_slots_plain(r, others, grid, overflow, replicas, wrap, False,
                                               ref, thresh, start)
            g = pencil_rebin.rebin_slots(r, others, grid, overflow, replicas=replicas, wrap=wrap,
                                         drift_ref=ref, drift_thresh=thresh, drift_max=start)
            assert len(g) == 5 and g[4].shape == start.shape and g[4].dtype == r.dtype
            assert torch.equal(g[3].cpu(), got[3].cpu())
            assert torch.equal(g[4].isnan().cpu(), w[4].isnan().cpu())
            assert torch.equal(_bits(torch.nan_to_num(g[4])), _bits(torch.nan_to_num(w[4])))
            assert bool(((g[4] >= start) | g[4].isnan()).all())
    return got


def _small_rebin_input(cuda, dtype, seed, crowd=False, faces=False):
    """(grid, r, [ru, v, a], r_ref, rc, vc) on the card: ``_pencil_carry``'s
    slots drifted, with ``faces`` some across the periodic faces and outside
    [0, L) (by up to 2 L, -1e-7, exactly L, -0.0), with ``crowd`` a third of
    the particles in pencil 0 (past its capacity)."""
    from ljmd_tpu_torch.ops import cell_list

    cfg, c = _pencil_carry()
    L = cfg.box_length
    grid = cell_list.make_pencil_grid(cfg.n, L, cfg.rc + cfg.neighbor_skin, cfg.density)
    gen = torch.Generator().manual_seed(seed)
    valid = c.r[3] > 0.5
    r = c.r.clone()
    r[0:3] = torch.where(valid[None, :], r[0:3] + 0.2 * torch.randn(
        (3, r.shape[1]), generator=gen, dtype=r.dtype), r[0:3])
    idx = torch.nonzero(valid).flatten()
    pick = idx[torch.randperm(idx.numel(), generator=gen)]
    if faces:
        r[0, pick[:16]] += L
        r[1, pick[16:32]] -= 2.0 * L
        r[2, pick[32:48]] += 2.0 * L - 1e-3
        r[0, pick[48:56]] = -1e-7
        r[1, pick[56:64]] = L
        r[2, pick[64:72]] = -0.0
    if crowd:
        many = pick[-(idx.numel() // 3):]
        r[0:2, many] = torch.rand((2, many.numel()), generator=gen, dtype=r.dtype) * (L / 4)
    noise = lambda: 1e-9 * torch.randn(r.shape, generator=gen, dtype=r.dtype)  # noqa: E731
    rows = (r, c.ru, c.v, c.a + 0.25, c.r, noise(), noise())
    r, ru, v, a, ref, rc, vc = (t.to(device=cuda, dtype=dtype).contiguous() for t in rows)
    return grid, r, [ru, v, a], ref, rc, vc


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["drifted", "crowded", "faces", "drift_flag", "compensated"])
def test_rebin_kernels_match_the_torch_chain(cuda, case, dtype):
    """``rebin_slots``' kernels against the torch chain on one grid: drifted
    slots; a pencil past capacity (the flag raised); particles across the
    faces and outside [0, L); one slot drifted past the threshold with the
    folded check (the flag raised, the one under it not); the compensated
    form (rows wrapped beforehand, the remainders carried); with and without
    the accelerations."""
    from ljmd_tpu_torch.ops.fused import wrap_positions_ext

    grid, r, others, ref, rc, vc = _small_rebin_input(
        cuda, dtype, 7, crowd=case == "crowded", faces=case in ("faces", "compensated"))
    L = grid.box_length
    none = torch.zeros((), dtype=torch.bool, device=cuda)
    thresh = (0.5 * (grid.pencil_width - 2.5)) ** 2
    if case == "drift_flag":
        ref = r.clone()
        slot = int(torch.nonzero(r[3] > 0.5)[7])
        ref[0, slot] = r[0, slot] - (thresh ** 0.5 + 1e-3) + L
        ref[1, slot + 1] = r[1, slot + 1] + 0.9 * thresh ** 0.5
        got = _rebin_on_card(grid, r, others, none, ref=ref, thresh=thresh)
        assert bool(got[3])
        from ljmd_tpu_torch.ops import pencil_rebin

        zero = torch.zeros((), dtype=dtype, device=cuda)
        top = pencil_rebin.rebin_slots(r, others, grid, none, drift_ref=ref, drift_thresh=thresh,
                                       drift_max=zero)[4]
        assert float(top) == pytest.approx((thresh ** 0.5 + 1e-3) ** 2, rel=1e-4)
        nan_ref = ref.clone()
        nan_ref[1, slot] = float("nan")
        _rebin_on_card(grid, r, others, none, ref=nan_ref, thresh=thresh)
        ref[0, slot] = r[0, slot] - 0.9 * thresh ** 0.5
        assert not bool(_rebin_on_card(grid, r, others, none, ref=ref, thresh=thresh)[3])
        return
    if case == "compensated":
        r8, rc8 = r.clone(), rc.clone()
        r8[0:3], rc8[0:3] = wrap_positions_ext(r8[0:3], rc8[0:3], L)
        for carried in (others + [rc8, vc], others[:2] + [rc8, vc]):
            _rebin_on_card(grid, r8, carried, none, wrap=False)
        return
    got = _rebin_on_card(grid, r, others, none, ref=ref, thresh=thresh)
    assert bool(_rebin_on_card(grid, r, others[:2], none)[3]) == (case == "crowded")
    _rebin_on_card(grid, r, others[:2], torch.ones((), dtype=torch.bool, device=cuda))
    if case == "crowded":
        assert int(got[2].max()) == grid.capacity


def test_rebin_kernels_over_a_replica_stack(cuda):
    """R=3 grids side by side (replica 1 crowded, replica 2 with one slot
    drifted past the threshold, replica 0 neither): each replica's rows,
    counts and flag those of its own grid, the torch chain's bits."""
    grids, rows = [], []
    for q, kw in enumerate(({}, {"crowd": True}, {})):
        grid, r, others, _, _, _ = _small_rebin_input(cuda, torch.float32, 11 + q, **kw)
        grids.append(grid)
        rows.append([r] + others)
    grid = grids[0]
    r, ru, v, a = (torch.cat(ts, dim=1).contiguous() for ts in zip(*rows))
    thresh = (0.5 * (grid.pencil_width - 2.5)) ** 2
    ref = r.clone()
    slot = 2 * grid.n_slots + int(torch.nonzero(r[3, 2 * grid.n_slots:] > 0.5)[3])
    ref[0, slot] = r[0, slot] + thresh ** 0.5 + 1e-3
    overflow = torch.zeros((3,), dtype=torch.bool, device=cuda)
    got = _rebin_on_card(grid, r, [ru, v, a], overflow, replicas=3, ref=ref, thresh=thresh)
    assert got[3].tolist() == [False, True, True]
    got1 = _rebin_on_card(grid, rows[0][0], rows[0][1:], overflow[0])
    assert torch.equal(_bits(got[0][:, :grid.n_slots]), _bits(got1[0]))
    assert torch.equal(got[2][:grid.n_pencils].cpu(), got1[2].cpu())


def test_rebin_kernels_on_a_melted_config5_state(cuda):
    """Config 5 (N=62500, float32) after the benchmark's 500-step warmup and
    a 16-step stretch of the engine: the rebin the engine runs before its
    next chunk (the folded check included), and one in float64."""
    import os

    from ljmd_tpu_torch.config import load_config

    cfg = load_config(os.path.join(os.path.dirname(__file__), "..", "examples",
                                   "n62500_large.json")).replace(warmup_steps=500)
    state = initialize(cfg, device=cuda)
    eng = pe.make_engine(cfg, "cellpair", state=state, device=cuda)
    carry, _ = eng.init(state)
    carry = eng.run_fast(carry, 16)
    from ljmd_tpu_torch.ops import cell_list

    args = (cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin, cfg.density)
    n_pencils = cell_list.make_pencil_grid(*args).n_pencils
    grid = cell_list.make_pencil_grid(*args, carry.r.shape[1] // n_pencils)
    assert grid.n_slots == carry.r.shape[1]
    thresh = (0.5 * (grid.pencil_width - cfg.rc)) ** 2
    got = _rebin_on_card(grid, carry.r, [carry.ru, carry.v, carry.a], carry.overflow,
                         ref=carry.r_ref, thresh=thresh)
    assert not bool(got[3]) and int(got[2].sum()) == cfg.n
    f64 = [t.double() for t in (carry.r, carry.ru, carry.v, carry.a, carry.r_ref)]
    _rebin_on_card(grid, f64[0], f64[1:4], carry.overflow, ref=f64[4], thresh=thresh)


@pytest.mark.parametrize("replicas", [None, 2])
def test_rebin_kernels_past_the_shared_histogram(cuda, replicas):
    """A grid of 112 x 112 pencils (12,544: past the 12,288 whose key
    histogram the key pass keeps in shared memory, so it counts in its
    global row), capacity 128, half full: particles placed at random in
    [0, L) shifted by -L, 0 or L, in the first half of each replica's slots,
    the last replica with 200 more in pencil 0 (past capacity) and the first
    with one slot drifted past the threshold. The kernels give the torch
    chain's bits at any grid size."""
    from ljmd_tpu_torch.ops.cell_list import PencilGrid

    grid = PencilGrid(m_xy=112, capacity=128, box_length=112 * 2.8)
    L, ns, reps = grid.box_length, grid.n_slots, replicas or 1
    n = ns // 2
    gen = torch.Generator().manual_seed(17)
    r = torch.zeros((8, reps * ns), dtype=torch.float32)
    for q in range(reps):
        lo = q * ns
        r[0:3, lo:lo + n] = L * (torch.rand((3, n), generator=gen)
                                  + torch.randint(-1, 2, (3, n), generator=gen))
        r[3, lo:lo + n] = 1.0
        r[4, lo:lo + n] = torch.arange(n, dtype=torch.float32)
    crowd = (reps - 1) * ns + n
    r[0:2, crowd:crowd + 200] = torch.rand((2, 200), generator=gen) * grid.pencil_width
    r[3, crowd:crowd + 200] = 1.0
    r[4, crowd:crowd + 200] = n + torch.arange(200, dtype=torch.float32)
    others = [torch.randn((8, reps * ns), generator=gen) for _ in range(3)]
    thresh = 0.25
    ref = r.clone()
    ref[1, 5] = r[1, 5] - 0.6
    r, ref, *others = (t.to(cuda) for t in [r, ref, *others])
    overflow = torch.zeros(() if replicas is None else (reps,), dtype=torch.bool, device=cuda)
    got = _rebin_on_card(grid, r, others, overflow, replicas=replicas, ref=ref, thresh=thresh)
    assert got[3].flatten().tolist() == [True] * reps
    assert int(got[2].reshape(reps, -1)[-1, 0]) == grid.capacity
    none = _rebin_on_card(grid, r, others[:2], overflow, replicas=replicas)[3]
    assert none.flatten().tolist() == [False] * (reps - 1) + [True]


@pytest.mark.parametrize("want_obs", [True, False])
def test_ordered_sweep_kernel_matches_twin(cuda, want_obs):
    """Kernel 5 against its twin at n < n_pad; rows 3..5 are twice the tri
    kernel's totals."""
    pos = _rows(200, 7.0, 4, cuda)
    LAUNCHES.reset()
    got = pair_sweep.pair_sweep(pos, 200, 7.0, 6.25, want_obs)
    assert LAUNCHES.snapshot()["pair_sweep"] == 1
    want = pair_sweep.pair_sweep_plain(pos, 200, 7.0, 6.25, want_obs)
    for row in range(8):
        _close(got[row], want[row])
    assert bool((got[:, 200:] == 0).all())
    tri = pair_sweep.pair_sweep_tri(pos, 200, 7.0, 6.25, want_obs)
    _close(2 * tri[3:6].sum(1), got[3:6].sum(1))


def test_force_api_and_entry_on_card(cuda):
    """The (N, 3) force API through kernel 5 against the CPU twin, and the
    flagship step on the card (auto -> the kernel) against the CPU step."""
    from ljmd_tpu_torch.entry import entry
    from ljmd_tpu_torch.models.forces import make_force_fn

    cfg = SimConfig(num_cells=5, box_length=8.0, rc_over_box=2.5 / 8.0, dtype="float64")
    r = torch.as_tensor(np.random.default_rng(5).uniform(0, 8.0, (cfg.n, 3)))
    want = make_force_fn(cfg, "pallas", "cpu")(r)
    LAUNCHES.reset()
    got = make_force_fn(cfg, "pallas", cuda)(r.to(cuda))
    assert LAUNCHES.snapshot()["pair_sweep"] == 1
    _close(got.a, want.a)
    for k in ("epot", "d_epot", "dd_epot"):
        _close(getattr(got, k), getattr(want, k))
    fn, args = entry(device=cuda)
    LAUNCHES.reset()
    out = fn(*(a.double() for a in args))
    assert LAUNCHES.snapshot()["pair_sweep"] == 1
    ref = entry(device="cpu")[0](*(a.cpu().double() for a in args))
    for g, w in zip(out, ref):
        _close(g, w)


def _tall_slots(cuda):
    """tests/test_torch_pencil_full.py's tall box (N=1600, L=60, 3x3
    pencils of capacity 512), slot rows without sentinels, its tables and
    z windows, on the card."""
    from ljmd_tpu_torch.ops import cell_list, pencil_sweep

    n, L = 1600, 60.0
    r = torch.as_tensor(np.random.default_rng(0).uniform(0, L, size=(n, 3)))
    grid = cell_list.make_pencil_grid(n, L, 20.0, n / L**3, 512)
    slot, ovf = cell_list.bin_to_slots(r, grid)
    assert not bool(ovf)
    pos = torch.zeros((8, grid.n_slots + 1), dtype=torch.float64)
    pos[0:3, slot] = r.T
    pos[3, slot] = 1.0
    pos = pos[:, :grid.n_slots].contiguous()
    counts = pos[3].reshape(grid.n_pencils, -1).sum(1).to(torch.int32)
    window = cell_list.default_z_window(grid, n, 2.9)
    wins = cell_list.compute_z_windows(pos, pos[3], counts, grid, window, 2.9)[:3]
    tbl = torch.as_tensor(pencil_sweep.build_tile_table(grid))
    shf = torch.as_tensor(pencil_sweep.build_shift_table(grid))
    return grid, window, pos.to(cuda), counts.to(cuda), tbl.to(cuda), shf.to(cuda), \
        [w.to(cuda) for w in wins]


@pytest.mark.parametrize("want_obs", [True, False])
def test_full_and_zband_pencil_kernels_match_twins(cuda, want_obs):
    """Kernels 11 and 12 against their twins, and against each other."""
    from ljmd_tpu_torch.ops import pencil_sweep

    grid, window, pos, counts, tbl, shf, wins = _tall_slots(cuda)
    LAUNCHES.reset()
    full = pencil_sweep.pencil_sweep(pos, tbl, counts, shf, grid, 6.25, want_obs)
    band = pencil_sweep.pencil_sweep_zband(pos, tbl, counts, *wins, grid, 6.25, window, want_obs)
    counts_ = LAUNCHES.snapshot()
    assert counts_["pencil_sweep_full"] == 1 and counts_["pencil_sweep_zband"] == 1
    want_full = pencil_sweep.pencil_sweep_plain(pos.cpu(), tbl.cpu(), counts.cpu(), shf.cpu(),
                                                grid, 6.25, want_obs)
    want_band = pencil_sweep.pencil_sweep_zband_plain(pos.cpu(), tbl.cpu(), counts.cpu(),
                                                      *(w.cpu() for w in wins), grid, 6.25,
                                                      window, want_obs)
    for row in range(8):
        _close(full[row], want_full[row])
        _close(band[row], want_band[row])
        _close(band[row], full[row])


@pytest.mark.parametrize("mode", ["full9", "zband"])
def test_cellpair_full_sweeps_on_card_match_cpu(cuda, mode):
    """A short cell-pair production with the full or z-banded sweep on the
    card against the same on the CPU, float64 (capacity 512: the band is
    live)."""
    cfg = SimConfig(num_cells=5, box_length=9.1, rc_over_box=2.5 / 9.1, dt=0.002,
                    total_steps=40, output_interval=10, warmup_steps=10, neighbor_skin=0.3,
                    target_total_energy=-2000.0, dtype="float64", neighbor_capacity=512)
    kw = {"half_shell": False} if mode == "full9" else {"z_band": True}
    state = initialize(cfg, backend="rows", device="cpu")
    cpu = run_production(cfg, state, engine=pe._cellpair_engine(cfg, "cpu", **kw), device="cpu")
    LAUNCHES.reset()
    gpu = run_production(cfg, state.to(device=cuda), engine=pe._cellpair_engine(cfg, cuda, **kw),
                         device=cuda)
    name = "pencil_sweep_full" if mode == "full9" else "pencil_sweep_zband"
    counts = LAUNCHES.snapshot()
    assert counts[name] > 0 and counts["fused_pencil_chunk"] == counts["pencil_sweep_hs"] == 0
    np.testing.assert_allclose(gpu.series.cpu().numpy(), cpu.series.numpy(), rtol=1e-9)


def test_neighbor_engine_on_card_matches_cpu(cuda):
    """The neighbor engine (plain torch gathers, no kernel) on the card
    against the CPU, float64."""
    cfg = SimConfig(num_cells=4, box_length=6.84, rc_over_box=2.5 / 6.84, dt=0.002,
                    total_steps=60, output_interval=10, warmup_steps=10, neighbor_skin=0.3,
                    target_total_energy=-500.0, dtype="float64")
    state = initialize(cfg, backend="rows", device="cpu")
    cpu = run_production(cfg, state, backend="neighbor", device="cpu")
    LAUNCHES.reset()
    gpu = run_production(cfg, state.to(device=cuda), backend="neighbor", device=cuda)
    assert not any(LAUNCHES.snapshot().values())
    np.testing.assert_allclose(gpu.series.cpu().numpy(), cpu.series.numpy(), rtol=1e-9)
    assert not bool(gpu.diagnostics["neighbor_overflow"])


def _rect_rows(n, ld, box, seed, device):
    rng = np.random.default_rng(seed)
    out = torch.zeros((8, ld), dtype=torch.float64)
    out[0:3, :n] = torch.as_tensor(rng.uniform(0, box, (3, n)))
    return out.to(device)


# (n_i, n_j, gi0, gj0): the self block (gi0 == gj0), a hop between blocks,
# and unequal blocks whose padding is not a tile multiple.
RECT_CASES = [(200, 200, 400, 400), (200, 200, 400, 0), (130, 250, 0, 130)]


@pytest.mark.parametrize("case", RECT_CASES)
@pytest.mark.parametrize("want_obs", [True, False])
def test_rect_kernel_matches_twin(cuda, case, want_obs):
    """Kernel 6 (the ring's rect sweep) against its twin, every row."""
    n_i, n_j, gi0, gj0 = case
    pos_i = _rect_rows(n_i, 256, 7.0, 5, cuda)
    pos_j = pos_i if gi0 == gj0 else _rect_rows(n_j, 256, 7.0, 6, cuda)
    LAUNCHES.reset()
    got = pair_sweep.pair_sweep_rect(pos_i, pos_j, n_i, n_j, gi0, gj0, 7.0, 6.25, want_obs)
    assert LAUNCHES.snapshot()["pair_sweep_rect"] == 1
    want = pair_sweep.pair_sweep_rect_plain(pos_i, pos_j, n_i, n_j, gi0, gj0, 7.0, 6.25,
                                            want_obs)
    for row in range(8):
        _close(got[row], want[row])
    assert bool((got[:, n_i:] == 0).all()) and bool((got[6:] == 0).all())


@pytest.mark.parametrize("hop", ["self", "full", "half_low", "half_high"])
@pytest.mark.parametrize("want_obs", [True, False])
def test_rect_newton_kernel_matches_twin(cuda, hop, want_obs):
    """Kernel 7 (the half ring's hops) against its twin: acc_i and acc_j on
    every row, acc_j rows 3..7 exactly 0, at the gated half hop's ranges."""
    n = 200
    i_lo, j_hi = {"self": (0, n), "full": (0, n), "half_low": (n // 2, n),
                  "half_high": (0, n // 2)}[hop]
    gj0 = 600 if hop == "self" else 0
    pos_i = _rect_rows(n, 256, 7.0, 7, cuda)
    pos_j = pos_i if hop == "self" else _rect_rows(n, 256, 7.0, 8, cuda)
    LAUNCHES.reset()
    got = pair_sweep.pair_sweep_rect_newton(pos_i, pos_j, n, n, 600, gj0, 7.0, 6.25, i_lo,
                                            j_hi, want_obs)
    assert LAUNCHES.snapshot()["pair_sweep_rect_newton"] == 1
    want = pair_sweep.pair_sweep_rect_newton_plain(pos_i, pos_j, n, n, 600, gj0, 7.0, 6.25,
                                                   i_lo, j_hi, want_obs)
    for g, w in zip(got, want):
        for row in range(8):
            _close(g[row], w[row])
    assert bool((got[1][3:] == 0).all())


def _strip(cuda):
    """Rank 0's strip of a 2-rank split of _pencil_carry's 4x4 pencils and
    its halo (rank 1's first x-column), with the strip tables."""
    from ljmd_tpu_torch.ops import cell_list
    from ljmd_tpu_torch.parallel import spatial_pencil as sp

    cfg, c = _pencil_carry()
    grid = cell_list.make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                      cfg.density)
    m, cap = grid.m_xy, grid.capacity
    p_loc = (m // 2) * m
    r_aug = torch.cat([c.r[:, :p_loc * cap], c.r[:, p_loc * cap:(p_loc + m) * cap]], dim=1)
    counts = sp.augmented_counts(c.counts, m, 2)[0]
    tbl = torch.as_tensor(sp._local_half_shell_table(m, m // 2))
    shf = torch.as_tensor(sp._device_shift_tables(m, m // 2, 2)[0])
    return cfg, grid, p_loc, r_aug, tbl, counts, shf


@pytest.mark.parametrize("want_obs", [True, False])
def test_pencil_sweep_strip_kernel_matches_twin(cuda, want_obs):
    """Kernel 14's n_pencils_i (a strip plus halo) against the twin."""
    from ljmd_tpu_torch.ops import pencil_sweep

    cfg, grid, p_loc, r_aug, tbl, counts, shf = _strip(cuda)
    want = pencil_sweep.pencil_sweep_hs(r_aug, tbl, counts, shf, grid, cfg.rc_square, want_obs,
                                        n_pencils_i=p_loc)
    got = pencil_sweep.pencil_sweep_hs(r_aug.to(cuda), tbl.to(cuda), counts.to(cuda),
                                       shf.to(cuda), grid, cfg.rc_square, want_obs,
                                       n_pencils_i=p_loc)
    for row in range(8):
        _close(got[row], want[row])
    assert bool((got[3:, p_loc * grid.capacity:] == 0).all())  # the halo is never the i side


@pytest.mark.parametrize("comm", ["half_ring", "ring", "all_gather"])
def test_spatial_engine_on_card_matches_cpu(cuda, comm):
    """The particle-sharded engine on a 4-rank thread mesh on the card
    against the same on the CPU (float64, run_production), launching the
    rect kernels (all_gather: plain torch, no kernel)."""
    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.parallel.spatial import make_spatial_engine

    cfg = SimConfig(num_cells=4, box_length=6.2, rc_over_box=2.5 / 6.2, dt=0.002,
                    total_steps=40, output_interval=10, warmup_steps=5,
                    target_total_energy=-800.0, dtype="float64")
    state = initialize(cfg, backend="rows", device="cpu")
    runs = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(particle=4, device=dev)
        LAUNCHES.reset()
        runs[str(dev)] = run_production(cfg, state, engine=make_spatial_engine(
            cfg, mesh, comm=comm), device=dev)
        mesh.close()
    counts = LAUNCHES.snapshot()
    need = {"half_ring": ("pair_sweep_tri", "pair_sweep_rect_newton"),
            "ring": ("pair_sweep_rect",), "all_gather": ()}[comm]
    assert all(counts[k] > 0 for k in need)
    assert sum(counts.values()) == sum(counts[k] for k in need)  # no other kernel
    np.testing.assert_allclose(runs["cuda"].series.cpu().numpy(), runs["cpu"].series.numpy(),
                               rtol=1e-9)


def test_sharded_pencil_engine_on_card_matches_cpu(cuda):
    """The sharded pencil engine on a 2-rank thread mesh on the card
    against the same on the CPU (float64), launching the strip sweep."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.parallel.spatial_pencil import make_sharded_pencil_engine
    from ljmd_tpu_torch.state import MDState

    cfg, _ = _pencil_carry()
    rng = np.random.default_rng(4)
    r = torch.remainder(fcc_lattice(8, 13.4, dtype=torch.float64)
                        + torch.as_tensor(rng.normal(0, 0.05, (2048, 3))), 13.4)
    st = MDState(r=r, ru=r, v=torch.as_tensor(rng.normal(0, 1.0, (2048, 3))),
                 a=torch.zeros_like(r))
    ends = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(particle=2, device=dev)
        eng = make_sharded_pencil_engine(cfg, mesh, inner_chunk=8)
        LAUNCHES.reset()
        c, _ = eng.init(st)
        c = eng.run_fast(c, 8)
        c, obs = eng.step(c)
        ends[str(dev)] = (eng.get_state(c), obs, bool(c[0].overflow))
        mesh.close()
    assert LAUNCHES.snapshot()["pencil_sweep_hs"] > 0
    (s_gpu, o_gpu, f_gpu), (s_cpu, o_cpu, f_cpu) = ends["cuda"], ends["cpu"]
    for f in ("r", "ru", "v", "a"):
        _close(getattr(s_gpu, f), getattr(s_cpu, f), 1e-9)
    assert float(o_gpu.epot) == pytest.approx(float(o_cpu.epot), rel=1e-10)
    assert not f_gpu and not f_cpu


def _n4000_fluid(device, dtype, seed=40):
    """The N=4000 production box's perturbed FCC lattice, z-sorted, with
    velocities and consistent accelerations, as (8, 4096) rows."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice

    box, rc2 = 16.795961913825, (0.148845300604 * 16.795961913825) ** 2
    rng = np.random.default_rng(seed)
    r = fcc_lattice(10, box, dtype=torch.float64).numpy()
    r = np.mod(r + rng.normal(scale=0.07, size=r.shape), box)
    r = r[np.argsort(r[:, 2])]
    rows = torch.zeros((8, 4096), dtype=torch.float64)
    rows[0:3, :4000] = torch.as_tensor(r.T)
    v = torch.zeros_like(rows)
    v[0:3, :4000] = torch.as_tensor(rng.uniform(-1.0, 1.0, (3, 4000)))
    a = 24.0 * pair_sweep.pair_forces_plain(rows, 4000, box, rc2)
    return (box, rc2, *(t.to(device=device, dtype=dtype) for t in (rows, v, a)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("extended", [False, True])
def test_dense_chunk_capped_grid_is_bit_identical(cuda, dtype, extended):
    """The persistent grid at the occupancy rule's block shape (S threads a
    particle, 256 / S particles a work item): capped at 32 blocks (several
    work items a block) the chunk equals the uncapped one bit for bit; so
    does the list chunk at 48."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    box, rc2, r, v, a = _n4000_fluid(cuda, dtype)
    plan = fused.dense_plan(r, extended)
    assert plan["slices"] >= 8 and plan["blocks"] > 32
    zero = torch.zeros_like(r)
    ext = (zero, zero) if extended else (None, None)
    full = fused._launch("fused_dense_chunk", extended, r, ext[0], v, ext[1], a, 4000, box,
                         rc2, 0.005, 6)
    capped = fused._launch("fused_dense_chunk", extended, r, ext[0], v, ext[1], a, 4000, box,
                           rc2, 0.005, 6, grid_cap=32)
    for g, w in zip(capped, full):
        assert g is None or torch.equal(g, w)
    flags = window_lists.compute_tile_flags(r, 4000, 128, 128, box, 2.5 + 0.7)
    tiles, counts = window_lists.build_window_lists(flags, 4000, 4096, 128, 512)
    kw = dict(r_lo=zero, vc=zero) if extended else dict(r_lo=None, vc=None)
    args = (r, v, a, tiles, counts, 4000, box, rc2, 0.005, 6, 128, 512, kw["r_lo"], kw["vc"],
            False)
    for g, w in zip(fused_list._launch(*args, grid_cap=48), fused_list._launch(*args)):
        assert torch.equal(g, w)


def _jittered_fluid(n, seed, dtype, device):
    """n particles on a jittered cubic lattice at rho = 0.8 (rc = 2.5), with
    velocities and consistent accelerations, as (8, n_pad) rows."""
    box = (n / 0.8) ** (1 / 3)
    k = int(np.ceil(n ** (1 / 3)))
    rng = np.random.default_rng(seed)
    sites = np.stack(np.meshgrid(*(np.arange(k),) * 3, indexing="ij"), -1).reshape(-1, 3)[:n]
    r = np.mod((sites + 0.5 + rng.normal(0, 0.05, (n, 3))) * box / k, box)
    n_pad = -(-n // 128) * 128
    rows = torch.zeros((8, n_pad), dtype=torch.float64)
    rows[0:3, :n] = torch.as_tensor(r.T)
    v = torch.zeros_like(rows)
    v[0:3, :n] = torch.as_tensor(rng.uniform(-1.0, 1.0, (3, n)))
    a = 24.0 * pair_sweep.pair_forces_plain(rows, n, box, 6.25)
    return box, (*(t.to(device=device, dtype=dtype) for t in (rows, v, a)),)


@pytest.mark.parametrize("mode", ["plain", "extended", "flags", "flags_extended"])
@pytest.mark.parametrize("n,dtype,tol", [(500, torch.float64, 1e-10), (500, torch.float32, 1e-4),
                                         (1000, torch.float64, 1e-10),
                                         (1000, torch.float32, 1e-4),
                                         (4000, torch.float32, 1e-4),
                                         (4000, torch.float64, 1e-10)])
def test_dense_template_matches_twin(cuda, n, dtype, tol, mode):
    """Kernels 3 / 4 / 8 (one template) against their twins over 6 steps at
    the occupancy rule's shape: N=500 (every SM), N=1000 (n not a multiple
    of a work item's particles at S = 256: ragged), N=4000; plain, extended
    and flag-gated (random 0/1 flags of (128, 512) tiles)."""
    box, (r, v, a) = _jittered_fluid(n, n, dtype, cuda)
    zero = torch.zeros_like(r)
    ext = dict(r_lo=zero, vc=zero) if "extended" in mode else {}
    plan = fused.dense_plan(r, bool(ext), mode.startswith("flags"))
    assert plan["blocks"] >= min(plan["sms"], plan["items"])
    LAUNCHES.reset()
    if mode.startswith("flags"):
        n_flags = (r.shape[1] // 128) * (r.shape[1] // 512)
        flags = torch.as_tensor(np.random.default_rng(n).integers(0, 2, n_flags)
                                .astype(np.int32), device=cuda)
        got = fused.fused_dense_chunk_flags(r, v, a, flags, n, box, 6.25, 0.005, 6, **ext)
        want = fused.fused_dense_chunk_flags_plain(r, v, a, flags, n, box, 6.25, 0.005, 6,
                                                   **ext)
        name = "fused_dense_chunk_flags"
    elif ext:
        got = fused.fused_dense_chunk_ext(r, zero, v, zero, a, n, box, 6.25, 0.005, 6)
        want = fused.fused_dense_chunk_ext_plain(r, zero, v, zero, a, n, box, 6.25, 0.005, 6)
        name = "fused_dense_chunk_ext"
    else:
        got = fused.fused_dense_chunk(r, v, a, n, box, 6.25, 0.005, 6)
        want = fused.fused_dense_chunk_plain(r, v, a, n, box, 6.25, 0.005, 6)
        name = "fused_dense_chunk"
    assert LAUNCHES.snapshot()[name] == 1
    if ext:  # compare the two-float values
        got = (got[0].double() + got[1].double(), got[2].double() + got[3].double(), got[4])
        want = (want[0].double() + want[1].double(), want[2].double() + want[3].double(),
                want[4])
    for g, w in zip(got, want):
        _close(g, w, tol)
        assert bool((g[:, n:] == 0).all()) and bool((g[3:] == 0).all())


def _width_fluid(cap, dtype, cuda):
    """A cell-pair carry of N=6912 (12^3 cells, rho* = 0.8442, 6x6 pencils
    of ~192 particles: two of the 128-slot blocks active) at capacity
    ``cap``, from a numpy seed, and its geometry."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import cell_list, pencil_sweep
    from ljmd_tpu_torch.state import MDState

    n = 4 * 12 ** 3
    L = (n / 0.8442) ** (1 / 3)
    cfg = SimConfig(num_cells=12, box_length=L, rc_over_box=2.5 / L, dt=0.004, dtype="float64",
                    target_total_energy=-30000.0, neighbor_capacity=cap)
    rng = np.random.default_rng(cap)
    r = fcc_lattice(12, L, dtype=torch.float64)
    r = torch.remainder(r + torch.as_tensor(rng.normal(0, 0.05, r.shape)), L)
    v = torch.as_tensor(rng.normal(0, 1.0, r.shape))
    eng = pe._cellpair_engine(cfg, cuda, width_lists=True)
    c, _ = eng.init(MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)).to(device=cuda))
    grid = cell_list.make_pencil_grid(cfg.n, L, cfg.rc + cfg.neighbor_skin, cfg.density, cap)
    tbl, shf = (torch.as_tensor(t, device=cuda)
                for t in pencil_sweep.build_half_shell_tables(grid))
    assert (grid.capacity, int(c.counts.max()) <= 256) == (cap, True)
    c = {k: getattr(c, k).to(dtype) if getattr(c, k).is_floating_point() else getattr(c, k)
         for k in ("r", "v", "a", "rc", "vc", "wl_self", "wl_self_cnt", "wl_nbr_i",
                   "wl_nbr_j", "wl_nbr_off")}
    return cfg, grid, c, (tbl, shf)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("cap", [384, 512])
def test_width_chunk_kernel_matches_twin(cuda, cap, extended, dtype, tol):
    """Kernel 16 at capacities 384 and 512 (blocks past the pencils' width
    stay empty) against its twin over 6 steps; capped at 5 blocks (several
    128-slot work items a block) it gives the same bits."""
    from ljmd_tpu_torch.ops import fused_pencil

    cfg, grid, c, _ = _width_fluid(cap, dtype, cuda)
    lists = tuple(c[k] for k in ("wl_self", "wl_self_cnt", "wl_nbr_i", "wl_nbr_j",
                                 "wl_nbr_off"))
    args = (grid.n_pencils, cap, cfg.box_length, cfg.rc_square, cfg.dt, 6)
    ext = dict(r_lo=c["rc"], vc=c["vc"]) if extended else {}
    LAUNCHES.reset()
    got = fused_pencil.fused_pencil_width_chunk(c["r"], c["v"], c["a"], *lists, *args, **ext)
    assert LAUNCHES.snapshot()["fused_pencil_width_chunk"] == 1
    want = fused_pencil.fused_pencil_width_chunk_plain(c["r"], c["v"], c["a"], *lists, *args,
                                                       **ext)
    for g, w in zip(got, want):
        _close(g, w, tol)
    capped = fused_pencil._launch_width(c["r"], c["v"], c["a"], lists, *args,
                                        ext.get("r_lo"), ext.get("vc"), grid_cap=5)
    for g, w in zip(capped, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("cap", [384, 512])
def test_width_chunk_equals_static_chunk_float64(cuda, cap):
    """Kernels 16 and 15 run the same pair set (the width lists skip only
    empty blocks): float64 states after 8 steps agree within the chunk
    paths' float64 tolerance, 1e-9 (chip_smoke.py PATHS_TOL)."""
    from ljmd_tpu_torch.ops import fused_pencil

    cfg, grid, c, tables = _width_fluid(cap, torch.float64, cuda)
    lists = tuple(c[k] for k in ("wl_self", "wl_self_cnt", "wl_nbr_i", "wl_nbr_j",
                                 "wl_nbr_off"))
    args = (grid.n_pencils, cap, cfg.box_length, cfg.rc_square, cfg.dt, 8)
    width = fused_pencil.fused_pencil_width_chunk(c["r"], c["v"], c["a"], *lists, *args)
    static = fused_pencil.fused_pencil_chunk(c["r"], c["v"], c["a"], *tables, *args)
    for g, w in zip(width, static):
        _close(g, w, 1e-9)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("cap", [384, 512])
def test_static_chunk_kernel_matches_twin(cuda, cap, extended, dtype, tol):
    """Kernel 15 at capacities 384 and 512 (~192 particles a pencil: the
    stages past the second are empty and skipped) against its twin over 6
    steps; capped at 5 blocks (several 128-slot work items a block) it gives
    the same bits."""
    from ljmd_tpu_torch.ops import fused_pencil

    cfg, grid, c, tables = _width_fluid(cap, dtype, cuda)
    args = (grid.n_pencils, cap, cfg.box_length, cfg.rc_square, cfg.dt, 6)
    ext = dict(r_lo=c["rc"], vc=c["vc"]) if extended else {}
    LAUNCHES.reset()
    got = fused_pencil.fused_pencil_chunk(c["r"], c["v"], c["a"], *tables, *args, **ext)
    assert LAUNCHES.snapshot()["fused_pencil_chunk"] == 1
    want = fused_pencil.fused_pencil_chunk_plain(c["r"], c["v"], c["a"], *tables, *args, **ext)
    for g, w in zip(got, want):
        _close(g, w, tol)
    capped = fused_pencil._launch_static(c["r"], c["v"], c["a"], *tables, *args,
                                         ext.get("r_lo"), ext.get("vc"), grid_cap=5)
    for g, w in zip(capped, got):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("want_obs", [True, False])
def test_zband_kernel_with_skips_matches_twin_and_full(cuda, want_obs, dtype, tol):
    """Kernel 12 on the tall box, where both kinds of stage are skipped,
    against its twin (the stages the plan keeps) and the full sweep."""
    from ljmd_tpu_torch.ops import pencil_sweep

    grid, window, pos, counts, tbl, shf, wins = _tall_slots(cuda)
    pos = pos.to(dtype)
    plan = pencil_sweep.zband_stage_plan(counts, tbl, *wins, grid.n_pencils, grid.capacity,
                                         window)
    assert plan["b_inside_a"] > 0 and plan["a_past_count"] + plan["b_past_count"] > 0
    args = (pos, tbl, counts, *wins, grid, 6.25, window, want_obs)
    got = pencil_sweep.pencil_sweep_zband(*args)
    want = pencil_sweep.pencil_sweep_zband_plain(*(a.cpu() if torch.is_tensor(a) else a
                                                   for a in args))
    full = pencil_sweep.pencil_sweep(pos, tbl, counts, shf, grid, 6.25, want_obs)
    for row in range(8):
        _close(got[row], want[row], tol)
        _close(got[row], full[row], tol)


def _flag_patterns(r, box):
    from ljmd_tpu_torch.ops import window_lists

    real = window_lists.compute_tile_flags(r, 4000, 128, 512, box, 2.5 + 0.7)
    rand = torch.as_tensor(np.random.default_rng(3).integers(0, 2, real.numel())
                           .astype(np.int32), device=r.device)
    return {"real": real, "zero": torch.zeros_like(real), "all3": torch.full_like(real, 3),
            "random": rand}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("extended", [False, True])
def test_flags_chunk_kernel_matches_twin(cuda, dtype, tol, extended):
    """Kernel 8 against its plain version at N=4000 (128, 512) with real,
    zero, all-3 and random 0/1 flags; all-3 flags equal the unflagged chunk
    bit for bit."""
    box, rc2, r, v, a = _n4000_fluid(cuda, dtype)
    zero = torch.zeros_like(r)
    kw = dict(r_lo=zero, vc=zero) if extended else {}
    for name, flags in _flag_patterns(r, box).items():
        got = fused.fused_dense_chunk_flags(r, v, a, flags, 4000, box, rc2, 0.005, 4, **kw)
        want = fused.fused_dense_chunk_flags_plain(r, v, a, flags, 4000, box, rc2, 0.005, 4,
                                                   **kw)
        for g, w in zip(got, want):
            _close(g, w, tol)
        if name == "all3":
            ref = (fused.fused_dense_chunk_ext(r, zero, v, zero, a, 4000, box, rc2, 0.005, 4)
                   if extended else fused.fused_dense_chunk(r, v, a, 4000, box, rc2, 0.005, 4))
            for g, w in zip(got, ref):
                assert torch.equal(g, w)


def test_mosaic_probes_match_plain(cuda):
    """Kernel 17: each probe at N=4096, ITERS=200 against its plain loop."""
    from ljmd_tpu_torch.experiments import mosaic_support as ms

    for name, _ in ms.PROBES:
        inputs = ms.probe_inputs(name, cuda)
        got, want = ms.probe(name, *inputs), ms.probe_plain(name, *inputs)
        _close(got, want, 1e-6)
    x = torch.ones((4096, 8), device=cuda)
    assert torch.equal(ms.transpose_scaled(x, 17), ms.transpose_scaled_plain(x, 17))


@pytest.mark.parametrize("name", ["k1", "k2b", "k2", "k3", "k4", "k4z", "k5a", "k5b", "k5c",
                                  "k6"])
def test_layout_bodies_match_plain(cuda, name, monkeypatch):
    """Kernel 18: each body at N_PAD=4096 (512 columns; k1 and k2 at 128
    too), 4 steps over 24 visits, against its plain version, in a box of
    L = 8 (lattice spacing 0.5: the forces, which reach r only through
    f * 1e-9, move it well past float32's resolution)."""
    from ljmd_tpu_torch.experiments import layout as ly

    monkeypatch.setattr(ly, "L", 8.0)
    r8, rT = ly.make_state(0, 4096, cuda)
    ti, tj = ly.visit_lists(24, 7, 4096)
    for tj_w in (512, 128) if name in ("k1", "k2") else (512,):
        lists = [torch.tensor(x, dtype=torch.int32, device=cuda)
                 for x in ly.variant_lists(name, tj_w, ti, tj, 4096)]
        got = ly.layout_body(name, r8, rT, *lists, 24, tj_w, 4, box=8.0)
        want = ly.layout_body_plain(name, r8, rT, *lists, 24, tj_w, 4, box=8.0)
        assert float((want[1] - r8[1]).abs().max()) > 1e-4
        _close(got, want, 1e-5)


@pytest.mark.parametrize("iters", [1, 37])
def test_mosaic_probes_odd_iteration_counts(cuda, iters):
    """Kernel 17 at iteration counts off its unrolling (8 and 4) and below a
    32-slot round (rowsum_store), against the plain loops."""
    from ljmd_tpu_torch.experiments import mosaic_support as ms

    for name, _ in ms.PROBES:
        inputs = ms.probe_inputs(name, cuda, iters=iters)
        got = ms.probe(name, *inputs, iters=iters)
        _close(got, ms.probe_plain(name, *inputs, iters=iters), 1e-6)


@pytest.mark.parametrize("shape", [(4, 100), (12, 40), (36, 9), (100, 3), (128, 128)])
def test_transpose_kernel_ragged_tiles(cuda, shape):
    """The transpose plan's three tile shapes with ragged edges."""
    from ljmd_tpu_torch.experiments import mosaic_support as ms

    x = torch.rand(shape, generator=torch.Generator().manual_seed(5)).to(cuda)
    assert torch.equal(ms.transpose_scaled(x, 7), ms.transpose_scaled_plain(x, 7))


@pytest.mark.parametrize("name,v,tj_w,masked,cap", [
    ("k1", 31, 512, 0, None),    # odd v, fewer items than the card's warps
    ("k2", 31, 128, 0, None),
    ("k3", 31, 512, 0, None),    # dual with an odd count: its last visit dropped
    ("k5b", 31, 512, 0, None),   # the DYN tail visit
    ("k5b", 31, 128, 0, 3),      # ... on a grid capped to 3 blocks
    ("k5c", 24, 512, 17, None),  # a non-zero masked count
    ("k5c", 31, 128, 31, 3),
    ("k6", 24, 128, 0, None),    # PURE at 128 columns
    ("k6", 31, 512, 0, 3),
])
def test_layout_body_plans_match_plain(cuda, name, v, tj_w, masked, cap, monkeypatch):
    """Kernel 18 off the experiment's shapes (L = 8, as above): odd and
    small visit counts, the tail, k5c's masked loop with visits in it, PURE
    at 128 columns, and grids capped below the items (every warp several)."""
    from ljmd_tpu_torch.experiments import layout as ly

    monkeypatch.setattr(ly, "L", 8.0)
    if cap is not None:
        monkeypatch.setattr(ly, "_max_blocks", lambda index, kernel: cap)
    r8, rT = ly.make_state(0, 4096, cuda)
    ti, tj = ly.visit_lists(max(v, masked), 7, 4096)
    lists = [torch.tensor(x, dtype=torch.int32, device=cuda)
             for x in ly.variant_lists(name, tj_w, ti, tj, 4096)]
    got = ly.layout_body(name, r8, rT, *lists, v, tj_w, 3, box=8.0, masked=masked)
    want = ly.layout_body_plain(name, r8, rT, *lists, v, tj_w, 3, box=8.0, masked=masked)
    assert float((want[1] - r8[1]).abs().max()) > 1e-4
    _close(got, want, 1e-5)
    if masked:
        plain0 = ly.layout_body_plain(name, r8, rT, *lists, v, tj_w, 3, box=8.0)
        assert not torch.equal(want, plain0)  # the masked loop had pairs


def test_experiment_kernels_capture_in_a_graph(cuda):
    """A probe and a layout body (a cooperative launch) replayed from a CUDA
    graph give the eager call's result."""
    from ljmd_tpu_torch.experiments import layout as ly
    from ljmd_tpu_torch.experiments import mosaic_support as ms

    inputs = ms.probe_inputs("roll", cuda)
    r8, rT = ly.make_state(0, 4096, cuda, box=8.0)
    lists = [torch.tensor(x, dtype=torch.int32, device=cuda) for x in ly.visit_lists(16, 7, 4096)]
    eager = (ms.probe("roll", *inputs), ly.layout_body("k4", r8, rT, *lists, 16, 512, 2, box=8.0))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (ms.probe("roll", *inputs), ly.layout_body("k4", r8, rT, *lists, 16, 512, 2,
                                                          box=8.0))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0])
    _close(out[1], eager[1], 1e-6)


def _hs_in_kernel_order(pos, tbl, counts, shf, cap, box, rc2, want_obs, slices,
                        n_pencils_i=None):
    """The half-shell sweep summed in the kernel's order, as plain torch
    (no fused or reordered arithmetic): each live 128-slot block over its
    plan's stages (``hs_stage_plan``) in order, thread slice s taking the
    partners s, s + S, ... of each stage, the S partial sums added in slice
    order, times the validity. Every masked pair is added as an exact +-0,
    which the kernel's skips and cull leave out."""
    from ljmd_tpu_torch.ops import pencil_sweep as pps
    from ljmd_tpu_torch.ops.pair_terms import lj_pair_terms_plain

    dev, dt = pos.device, pos.dtype
    p_all = pos.shape[1] // cap
    p_i = p_all if n_pencils_i is None else n_pencils_i
    plan = pps.hs_stage_plan(counts, tbl, shf, pps.half_shell_lower(tbl, p_all), p_i, p_all, cap)
    blk, q0, role, shx, shy = pps.hs_chunks(plan)
    items, n_st = torch.unique_consecutive(blk, return_counts=True)
    first = torch.cumsum(n_st, 0) - n_st
    item = torch.repeat_interleave(torch.arange(items.numel(), device=dev), n_st)
    col = torch.arange(blk.numel(), device=dev) - first[item]
    width = int(n_st.max())

    def table(x, fill):
        t = torch.full((items.numel(), width), fill, dtype=x.dtype, device=dev)
        t[item, col] = x
        return t

    tq0, trole, tshx, tshy = table(q0, 0), table(role, -1), table(shx, 0), table(shy, 0)
    g = items[:, None] * 128 + torch.arange(128, device=dev)           # (I, 128)
    x, y, z = (pos[c][g][:, None, :] for c in range(3))                # (I, 1, 128)
    s_ar = torch.arange(slices, device=dev)
    acc = torch.zeros((6, items.numel(), slices, 128), dtype=dt, device=dev)
    inv = 1.0 / box
    for c in range(width):
        rl = trole[:, c][:, None, None]
        offx = (tshx[:, c].to(dt) * box)[:, None, None]
        offy = (tshy[:, c].to(dt) * box)[:, None, None]
        mx = torch.where(rl == 2, x + offx, x)
        my = torch.where(rl == 2, y + offy, y)
        for it in range(128 // slices):
            jj = (tq0[:, c][:, None] + s_ar + slices * it)[:, :, None]   # (I, S, 1)
            px = torch.where(rl == 1, pos[0][jj] + offx, pos[0][jj])
            py = torch.where(rl == 1, pos[1][jj] + offy, pos[1][jj])
            dx, dy, dz = mx - px, my - py, z - pos[2][jj]
            dz = dz - box * torch.round(dz * inv)
            r2 = dx * dx + dy * dy + dz * dz
            m = (r2 < rc2) & (rl >= 0) & ((rl != 0) | (jj != g[:, None, :]))
            coef, du, e, ddu = lj_pair_terms_plain(r2, m, want_obs)
            for k, d in enumerate((dx, dy, dz)):
                acc[k] = acc[k] + coef * d
            if want_obs:
                i_side = (rl == 1) | ((rl == 0) & (jj > g[:, None, :]))
                for k, term in ((3, e), (4, du), (5, ddu)):
                    acc[k] = torch.where(i_side, acc[k] + term, acc[k])
    out = torch.zeros_like(pos)
    total = acc[:, :, 0]
    for s in range(1, slices):
        total = total + acc[:, :, s]
    rows = 6 if want_obs else 3
    out[:rows, g.reshape(-1)] = total[:rows].reshape(rows, -1) * pos[3][g.reshape(-1)]
    return out


@pytest.mark.parametrize("strip", [False, True])
@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pencil_sweep_kernel_order_is_bit_exact(cuda, dtype, want_obs, strip):
    """Kernels 13 / 14 (4 threads a slot: the earlier sweep's partner order
    and sum) equal, bit for bit, the kernel's order summed in plain torch:
    skipped stages and culled pairs change no bit."""
    from ljmd_tpu_torch.ops import pencil_sweep

    if strip:
        cfg, grid, p_loc, r, tbl, counts, shf = _strip(cuda)
    else:
        from ljmd_tpu_torch.ops import cell_list

        cfg, c = _pencil_carry()
        grid = cell_list.make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                          cfg.density)
        tbl, shf = (torch.as_tensor(t) for t in pencil_sweep.build_half_shell_tables(grid))
        r, counts, p_loc = c.r, c.counts, None
    r, tbl, counts, shf = r.to(cuda, dtype), tbl.to(cuda), counts.to(cuda), shf.to(cuda)
    got = pencil_sweep.pencil_sweep_hs(r, tbl, counts, shf, grid, cfg.rc_square, want_obs,
                                       n_pencils_i=p_loc)
    slices = pencil_sweep.sweep_hs_grid(r, want_obs)["slices"]
    want = _hs_in_kernel_order(r, tbl, counts, shf, grid.capacity, grid.box_length,
                               cfg.rc_square, want_obs, slices, p_loc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("slices", [4, 8, 16, 32, 64])
def test_list_chunk_block_shapes_match_twin(cuda, slices):
    """Kernel 10 at every S it takes against its twin (obs_last, N=864,
    every category and tail)."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    box, rc2 = 10.0776, 6.25
    n, r = _sorted_lattice(6, box, 896, 5)
    v = torch.zeros_like(r)
    v[0:3, :n] = torch.as_tensor(np.random.default_rng(9).uniform(-1.0, 1.0, (3, n)))
    a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc2)
    flags = torch.as_tensor(np.random.default_rng(6).choice(
        [0, 1, 3, 5, 7], p=[0.3, 0.4, 0.1, 0.1, 0.1], size=(49,)).astype(np.int32))
    tiles, counts = window_lists.build_window_lists_plain(flags, n, 896, 128, 256)
    want = fused_list.fused_dense_chunk_list(r, v, a, tiles, counts, n, box, rc2, 0.004, 6,
                                             tile_j=256, obs_last=True)
    assert fused_list.list_plan(r.to(cuda), slices=slices)["slices"] == slices
    got = fused_list._launch(r.to(cuda), v.to(cuda), a.to(cuda), tiles.to(cuda),
                             counts.to(cuda), n, box, rc2, 0.004, 6, 128, 256, None, None, True,
                             slices=slices)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("grid_cap", [1, 5, 17])
def test_list_chunk_capped_grids_are_bit_identical(cuda, grid_cap):
    """Kernel 10 under a capped persistent grid (each block then takes several
    work items): 1, 5 and 17 blocks give the full grid's bits (float32, obs_last,
    the N=4000 fluid)."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    box, rc2, r, v, a = _n4000_fluid(cuda, torch.float32)
    flags = window_lists.compute_tile_flags(r, 4000, 128, 128, box, 2.5 + 0.7)
    tiles, counts = window_lists.build_window_lists(flags, 4000, 4096, 128, 512)
    args = (r, v, a, tiles, counts, 4000, box, rc2, 0.005, 4, 128, 512, None, None, True)
    assert fused_list.list_plan(r, grid_cap=grid_cap)["blocks"] == grid_cap
    for g, w in zip(fused_list._launch(*args, grid_cap=grid_cap), fused_list._launch(*args)):
        assert torch.equal(g, w)


def _full_slots(cap, dtype):
    """The N=2048 jittered lattice (L=13.4, 4x4 pencils) binned at capacity
    ``cap`` with sentinels, pencil 1 emptied and pencil 2 cut to 77 slots
    (slots stay packed rank-first), with the full sweep's tables; CPU."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import cell_list, pencil_sweep

    n, box = 2048, 13.4
    rng = np.random.default_rng(3)
    r = torch.remainder(fcc_lattice(8, box, dtype=torch.float64)
                        + torch.as_tensor(rng.normal(0, 0.05, (n, 3))), box)
    grid = cell_list.make_pencil_grid(n, box, 2.9, n / box**3, cap)
    slot, ovf = cell_list.bin_to_slots(r, grid)
    assert not bool(ovf)
    pos = torch.zeros((8, grid.n_slots + 1), dtype=torch.float64)
    pos[0:3, slot] = r.T
    pos[3, slot] = 1.0
    pos = pos[:, :grid.n_slots].contiguous()
    rank = torch.arange(grid.n_slots) % cap
    pencil = torch.arange(grid.n_slots) // cap
    pos[3, (pencil == 1) | ((pencil == 2) & (rank >= 77))] = 0.0
    pos = pencil_sweep.sentinel_fill(pos, pos[3], cap).to(dtype)
    counts = pos[3].reshape(grid.n_pencils, cap).sum(1).to(torch.int32)
    assert int(counts[1]) == 0 and int(counts[2]) == 77
    tbl = torch.as_tensor(pencil_sweep.build_tile_table(grid))
    shf = torch.as_tensor(pencil_sweep.build_shift_table(grid))
    return grid, pos, counts, tbl, shf


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("cap", [384, 512])
def test_full_sweep_kernel_with_skips_matches_twin(cuda, cap, want_obs, dtype, tol):
    """Kernel 11 (128-slot i-slices, exact stage skips, cp.async ring, warp
    vote) against its twin at capacities 384 and 512, both precisions, with
    an emptied and a short pencil: invalid slots and rows 6-7 exactly 0."""
    from ljmd_tpu_torch.ops import pencil_sweep

    grid, pos, counts, tbl, shf = _full_slots(cap, dtype)
    plan = pencil_sweep.full_stage_plan(counts, tbl, grid.n_pencils, cap)
    assert plan["past_count"] > 0 and plan["kept"] < plan["stages"]
    want = pencil_sweep.pencil_sweep_plain(pos, tbl, counts, shf, grid, 6.25, want_obs)
    LAUNCHES.reset()
    got = pencil_sweep.pencil_sweep(pos.to(cuda), tbl.to(cuda), counts.to(cuda), shf.to(cuda),
                                    grid, 6.25, want_obs)
    assert LAUNCHES.snapshot()["pencil_sweep_full"] == 1
    for row in range(8):
        _close(got[row], want[row], tol)
    got = got.cpu()
    assert bool((got[6:] == 0).all()) and bool((got[:, pos[3] == 0] == 0).all())
    if not want_obs:
        assert bool((got[3:] == 0).all())
    launch = pencil_sweep.full_grid(pos.to(cuda), want_obs)
    assert launch["threads"] == 512 and launch["blocks_per_sm"] >= 1
    # The float64 build with the observables spills 8 bytes on the H100 (its
    # 64 registers a thread are the cap at 2 blocks an SM); the others none.
    assert launch["spill_bytes"] <= (8 if dtype == torch.float64 and want_obs else 0)


def _newton_blocks(n, ld, box, seed, dtype, cuda):
    """Two (8, ld) row blocks of n particles each, uniform in the box."""
    return (_rect_rows(n, ld, box, seed, cuda).to(dtype),
            _rect_rows(n, ld, box, seed + 1, cuda).to(dtype))


@pytest.mark.parametrize("slices", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_rect_newton_kernel_at_every_block_shape(cuda, slices, dtype, tol):
    """Kernel 7 at every S that ``rect_newton_plan`` can choose, each at a
    row count where the rule chooses it (a full hop of 3 S / 2 rows a side:
    one wave, with a partner a thread, at S but not at 2 S): the full hop
    and both sides of the gated half hop (a smaller S) against the twin,
    observables on and off, and the two halves adding up to the full hop."""
    n = 3 * slices // 2
    box = (n / 0.58) ** (1.0 / 3.0)  # the density of 200 rows in a box of 7
    half = n // 2
    a, b = _newton_blocks(n, -(-n // 128) * 128, box, 21, dtype, cuda)
    for want_obs in (True, False):
        outs = []
        for pos_i, pos_j, gi0, gj0, i_lo, j_hi in ((a, b, 0, n, half, n), (b, a, n, 0, 0, half),
                                                   (a, b, 0, n, 0, n)):
            if (i_lo, j_hi) == (0, n):
                plan = pair_sweep.rect_newton_plan(pos_i, pos_j, n, n, i_lo, j_hi, want_obs)
                assert (plan["slices"], plan["tile"]) == (slices, 256 // slices)
            LAUNCHES.reset()
            got = pair_sweep.pair_sweep_rect_newton(pos_i, pos_j, n, n, gi0, gj0, box, 6.25,
                                                    i_lo, j_hi, want_obs)
            assert LAUNCHES.snapshot()["pair_sweep_rect_newton"] == 1
            want = pair_sweep.pair_sweep_rect_newton_plain(pos_i.cpu(), pos_j.cpu(), n, n, gi0,
                                                           gj0, box, 6.25, i_lo, j_hi, want_obs)
            for g, w in zip(got, want):
                for row in range(8):
                    _close(g[row], w[row], tol)
                assert bool((g[:, n:] == 0).all())
            assert bool((got[1][3:] == 0).all()) and bool((got[0][6:] == 0).all())
            outs.append(got)
        lo, hi, full = outs
        _close(lo[0][0:3] + hi[1][0:3], full[0][0:3], tol)
        _close(lo[1][0:3] + hi[0][0:3], full[1][0:3], tol)
        if want_obs:
            _close(lo[0][3:6].sum(1) + hi[0][3:6].sum(1), full[0][3:6].sum(1), tol)


def test_rect_newton_plan_rule(cuda):
    """The occupancy rule's S at the main path's shapes: the live blocks of
    both roles fit one wave of at most 3 blocks an SM, each thread keeps a
    partner, a doubled S would break one of those, and the inactive edge
    cases launch only zero-writing blocks."""
    for n, i_lo, j_hi in ((1000, 0, 1000), (1000, 500, 1000), (1000, 0, 500), (250, 125, 250)):
        pad = -(-n // 128) * 128
        a, b = _newton_blocks(n, pad, 16.8, 5, torch.float32, cuda)
        plan = pair_sweep.rect_newton_plan(a, b, n, n, i_lo, j_hi)
        bi, bj = pair_sweep.rect_newton_blocks(n, n, i_lo, j_hi, plan["tile"])
        assert plan["items"] == bi.numel() + bj.numel()
        wave = min(plan["blocks_per_sm"], 3) * plan["sms"]
        assert plan["items"] <= wave and min(j_hi, n - i_lo) >= plan["slices"]
        if plan["slices"] < 128:
            bi, bj = pair_sweep.rect_newton_blocks(n, n, i_lo, j_hi, plan["tile"] // 2)
            assert bi.numel() + bj.numel() > wave or min(j_hi, n - i_lo) < 2 * plan["slices"]
    a, b = _newton_blocks(200, 256, 7.0, 5, torch.float64, cuda)
    for i_lo, j_hi in ((200, 200), (0, 0)):
        got = pair_sweep.pair_sweep_rect_newton(a, b, 200, 200, 0, 200, 7.0, 6.25, i_lo, j_hi)
        assert not any(bool(g.any()) for g in got)
        assert pair_sweep.rect_newton_plan(a, b, 200, 200, i_lo, j_hi)["items"] == 0


def _row_sweeps(kind, n, pos_i, pos_j, box, want_obs):
    """(kernel output, twin output) of the tri sweep over pos_i's n rows or
    of the rect sweep of them against pos_j (global offsets 0 and n)."""
    if kind == "tri":
        args = (pos_i, n, box, 6.25, want_obs)
        return pair_sweep.pair_sweep_tri(*args), pair_sweep.pair_sweep_tri_plain(*args)
    args = (pos_i, pos_j, n, n, 0, n, box, 6.25, want_obs)
    return pair_sweep.pair_sweep_rect(*args), pair_sweep.pair_sweep_rect_plain(*args)


@pytest.mark.parametrize("kind", ["tri", "rect"])
@pytest.mark.parametrize("slices", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_row_sweep_kernels_at_every_block_shape(cuda, kind, slices, dtype, tol):
    """Kernels 2 and 6 at every S that ``rows_sweep_plan`` can choose, each
    at a row count where the rule chooses it (3 S / 2 rows: one wave, with a
    partner a thread, at S but not at 2 S), against the twin on every row,
    observables on and off; rows 6..7 and the padding exactly 0."""
    n = 3 * slices // 2
    box = (n / 0.58) ** (1.0 / 3.0)  # the density of 200 rows in a box of 7
    pos_i, pos_j = _newton_blocks(n, -(-n // 128) * 128, box, 31, dtype, cuda)
    for want_obs in (True, False):
        plan = pair_sweep.rows_sweep_plan(pos_i, n, None if kind == "tri" else pos_j,
                                          None if kind == "tri" else n, want_obs)
        assert (plan["slices"], plan["tile"]) == (slices, 256 // slices)
        name = "pair_sweep_tri" if kind == "tri" else "pair_sweep_rect"
        LAUNCHES.reset()
        got, want = _row_sweeps(kind, n, pos_i, pos_j, box, want_obs)
        assert LAUNCHES.snapshot()[name] == 1
        for row in range(8):
            _close(got[row], want[row], tol)
        assert bool((got[:, n:] == 0).all()) and bool((got[6:] == 0).all())
        if not want_obs:
            assert bool((got[3:] == 0).all())


def test_row_sweep_plan_rule(cuda):
    """The kernel's plan equals the Python rule (``rows_sweep_slices``,
    ``rows_sweep_blocks``) at the main path's shapes (N=4000, 864 and 500,
    the 1000- and 250-row self blocks, the ring's 1000 x 1000 and 2000 x
    2000 hops) in both precisions, observables on and off, and at the empty
    edge, whose launch writes only zeros."""
    for n in (4000, 864, 500, 1000, 250, 2000):
        pad = -(-n // 128) * 128
        for dtype in (torch.float32, torch.float64):
            a, b = _newton_blocks(n, pad, 16.8, 5, dtype, cuda)
            for want_obs in (True, False):
                for pos_j in (None, b):
                    plan = pair_sweep.rows_sweep_plan(a, n, pos_j, None if pos_j is None else n,
                                                      want_obs)
                    s = pair_sweep.rows_sweep_slices(n, n, plan["blocks_per_sm"], plan["sms"])
                    assert plan["slices"] == s and plan["tile"] == 256 // s
                    assert plan["items"] == pair_sweep.rows_sweep_blocks(n, n, plan["tile"])
                    assert plan["blocks"] == pad // plan["tile"]
    a, b = _newton_blocks(200, 256, 7.0, 5, torch.float64, cuda)
    got = pair_sweep.pair_sweep_rect(a, b, 200, 0, 0, 200, 7.0, 6.25)
    assert not bool(got.any())
    assert pair_sweep.rows_sweep_plan(a, 200, b, 0)["items"] == 0
    assert not bool(pair_sweep.pair_sweep_tri(a, 0, 7.0, 6.25).any())


def test_row_sweeps_refuse_misaligned_rows(cuda):
    """Kernels 2, 6 and 7 stage rows by cp.async: rows that do not start on
    a 16-byte boundary are refused, not read."""
    for dtype in (torch.float32, torch.float64):
        buf = torch.zeros(8 * 256 + 1, dtype=dtype, device=cuda)
        bad = buf[1:].view(8, 256)
        good = torch.zeros((8, 256), dtype=dtype, device=cuda)
        assert bad.is_contiguous() and bad.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            pair_sweep.pair_sweep_tri(bad, 200, 7.0, 6.25)
        for pos_i, pos_j in ((bad, good), (good, bad)):
            with pytest.raises(ValueError, match="16-byte"):
                pair_sweep.pair_sweep_rect(pos_i, pos_j, 200, 200, 0, 200, 7.0, 6.25)
            with pytest.raises(ValueError, match="16-byte"):
                pair_sweep.pair_sweep_rect_newton(pos_i, pos_j, 200, 200, 0, 200, 7.0, 6.25)


@pytest.mark.parametrize("slices", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_ordered_sweep_kernel_at_every_block_shape(cuda, slices, dtype, tol):
    """Kernel 5 (the rect sweep's kernel with i = j) at every S that
    ``pair_sweep_plan`` can choose, each at a row count where the rule
    chooses it (3 S / 2 rows), against the twin on every row, observables on
    and off; rows 6..7 and the padding exactly 0; rows 0..2 bit for bit the
    tri sweep's (kernel 2, the same S and order)."""
    n = 3 * slices // 2
    box = (n / 0.58) ** (1.0 / 3.0)
    pos, _ = _newton_blocks(n, -(-n // 128) * 128, box, 37, dtype, cuda)
    for want_obs in (True, False):
        plan = pair_sweep.pair_sweep_plan(pos, n, want_obs)
        assert (plan["slices"], plan["tile"]) == (slices, 256 // slices)
        assert plan["items"] == pair_sweep.rows_sweep_blocks(n, n, plan["tile"])
        LAUNCHES.reset()
        got = pair_sweep.pair_sweep(pos, n, box, 6.25, want_obs)
        assert LAUNCHES.snapshot()["pair_sweep"] == 1
        want = pair_sweep.pair_sweep_plain(pos, n, box, 6.25, want_obs)
        for row in range(8):
            _close(got[row], want[row], tol)
        assert bool((got[:, n:] == 0).all()) and bool((got[6:] == 0).all())
        if not want_obs:
            assert bool((got[3:] == 0).all())
        tri = pair_sweep.pair_sweep_tri(pos, n, box, 6.25, want_obs)
        assert pair_sweep.rows_sweep_plan(pos, n, None, None, want_obs)["slices"] == slices
        assert torch.equal(got[0:3], tri[0:3])


def test_ordered_sweep_refuses_misaligned_rows(cuda):
    """Kernel 5 stages rows by cp.async: rows off a 16-byte boundary are
    refused, not read; fresh rows are taken."""
    for dtype in (torch.float32, torch.float64):
        buf = torch.zeros(8 * 256 + 1, dtype=dtype, device=cuda)
        bad = buf[1:].view(8, 256)
        assert bad.is_contiguous() and bad.data_ptr() % 16
        with pytest.raises(ValueError, match="16-byte"):
            pair_sweep.pair_sweep(bad, 200, 7.0, 6.25)
        good = torch.zeros((8, 256), dtype=dtype, device=cuda)
        assert not bool(pair_sweep.pair_sweep(good, 0, 7.0, 6.25).any())


def _pack_flags(name, n_b, seed):
    """(n_b * n_b,) int32 flags: random values 0..7, empty, all active with
    every round, one active block a row, or each row's band running to the
    row's end (as tests/test_torch_window_lists.py's patterns)."""
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
    return torch.as_tensor(f.reshape(-1).astype(np.int32))


def _same_prefix(got, want):
    (gt, gc), (wt, wc) = (t.cpu() for t in got), want
    assert torch.equal(gc, wc)
    for c, k in enumerate(wc.tolist()):
        lrows = ([2 * c, 2 * c + 1] + ([8] if c == 3 else [])) if c < 4 else \
            [9 + 2 * (c - 4), 10 + 2 * (c - 4)]
        assert torch.equal(gt[lrows, :k], wt[lrows, :k]), (c, k)


@pytest.mark.parametrize("tail_tiles", [True, False])
@pytest.mark.parametrize("n_b", [7, 32, 33, 64, 256, 1024])
def test_pack_kernel_at_every_row_count(cuda, n_b, tail_tiles):
    """Kernel 9 from one warp of rows to the kernel's 1024 (masks staged in
    shared memory up to n_b = 256 here, read again at 1024; rows past 32 a
    warp each take several), on random, empty, all-active, one-a-row and
    band-to-the-end flags, zero_fill off and on: the twin's lists on the
    count prefix, and zeros past it with zero_fill."""
    from ljmd_tpu_torch.ops import window_lists

    n_pad = 128 * n_b
    n, tj = n_pad - 50, 128 * (6 if n_b == 33 else 4)
    for k, name in enumerate(("random", "empty", "all_active", "one_a_row", "band_to_end")):
        flags = _pack_flags(name, n_b, 100 * n_b + k)
        want = window_lists.build_window_lists_plain(flags, n, n_pad, 128, tj, tail_tiles)
        for zero_fill in (False, True):
            LAUNCHES.reset()
            got = window_lists.build_window_lists(flags.to(cuda), n, n_pad, 128, tj, zero_fill,
                                                  tail_tiles)
            assert LAUNCHES.snapshot()["build_window_lists"] == 1
            _same_prefix(got, want)
            if zero_fill:
                assert torch.equal(got[0].cpu(), want[0]), name


def test_pack_kernel_is_one_device_operation(cuda):
    """A pack with zero_fill=False is the kernel's launch and nothing else
    (the row bands are found in the kernel): one node in one call's CUDA
    graph, and at most one device operation a call under the profiler
    (whose trace can lose launches but adds none)."""
    from ljmd_tpu_torch.ops import window_lists
    from ljmd_tpu_torch.utils.profiling import device_breakdown, graph_ops

    flags = _pack_flags("band_to_end", 32, 5).to(cuda)
    pack = lambda: window_lists.build_window_lists(flags, 4000, 4096, 128, 512)  # noqa: E731
    pack()
    ops = graph_ops(pack)
    assert ops["ops"] == 1 and ops["nodes"] == {"kernel": 1}, ops
    seen = device_breakdown(lambda: [pack() for _ in range(10)],
                            top=1 << 30)["device_ms_by_name"]
    assert sum(v["count"] for v in seen.values()) <= 10, seen


def _replica_fluids(replicas, n, dtype, device, seed=40):
    """R independent jittered fluids of n particles (one box) as (R, 8,
    n_pad) stacks of rows, velocities and accelerations."""
    parts = [_jittered_fluid(n, seed + q, dtype, device) for q in range(replicas)]
    box = parts[0][0]
    return box, tuple(torch.stack([p[1][k] for p in parts]) for k in range(3))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("kernel", ["tri", "chunk", "chunk_ext"])
def test_replica_launches_equal_single_launches(cuda, kernel, dtype, tol):
    """Kernels 2, 3 and 4 on (R, 8, n_pad) stacks: ONE launch (counted as
    ``*_replicas``) whose replica q equals a launch on replica q alone bit
    for bit, and matches the batched twin; at N=256 (ensemble64's N) and
    N=500 (the reference default's)."""
    for n, replicas in ((256, 7), (500, 3)):
        box, (r, v, a) = _replica_fluids(replicas, n, dtype, cuda)
        zero = torch.zeros_like(r)
        if kernel == "tri":
            def run(*x):
                return (pair_sweep.pair_sweep_tri(x[0], n, box, 6.25),)
            twin = (pair_sweep.pair_sweep_tri_plain(r, n, box, 6.25),)
            name = "pair_sweep_tri"
        elif kernel == "chunk":
            def run(*x):
                return fused.fused_dense_chunk(x[0], x[1], x[2], n, box, 6.25, 0.005, 7)
            twin = fused.fused_dense_chunk_plain(r, v, a, n, box, 6.25, 0.005, 7)
            name = "fused_dense_chunk"
        else:
            def run(*x):
                return fused.fused_dense_chunk_ext(x[0], x[3], x[1], x[3], x[2], n, box, 6.25,
                                                   1e-4, 7)
            twin = fused.fused_dense_chunk_ext_plain(r, zero, v, zero, a, n, box, 6.25, 1e-4, 7)
            name = "fused_dense_chunk_ext"
        LAUNCHES.reset()
        got = run(r, v, a, zero)
        counts = LAUNCHES.snapshot()
        assert counts[name + "_replicas"] == 1 and counts[name] == 0
        for q in range(replicas):
            alone = run(r[q].contiguous(), v[q].contiguous(), a[q].contiguous(),
                        zero[q].contiguous())
            for g, w in zip(got, alone):
                assert torch.equal(g[q], w), (n, q)
        for g, w in zip(got, twin):
            _close(g, w, tol)


@pytest.mark.parametrize("extended", [False, True])
def test_replica_chunk_capped_grid_and_planted_nan(cuda, extended):
    """The replica chunk with its persistent grid capped (several replicas'
    items a block, the resident plane restaged) equals the full grid bit
    for bit; a NaN planted in one replica leaves every other's bits as
    they were."""
    n, replicas = 256, 9
    box, (r, v, a) = _replica_fluids(replicas, n, torch.float32, cuda)
    zero = torch.zeros_like(r)
    ext = (zero, zero) if extended else (None, None)

    def launch(pos, **kw):
        return fused._launch("fused_dense_chunk", extended, pos, ext[0], v, ext[1], a, n, box,
                             6.25, 0.005, 5, **kw)

    full = launch(r)
    assert fused.dense_plan(r, extended)["items"] == replicas * fused.dense_plan(r[0])["items"]
    for g, w in zip(launch(r, grid_cap=5), full):
        assert g is None or torch.equal(g, w)
    bad = r.clone()
    bad[4, 0, 17] = float("nan")
    poisoned = launch(bad)
    assert not bool(torch.isfinite(poisoned[0][4]).all())
    keep = [q for q in range(replicas) if q != 4]
    for g, w in zip(poisoned, full):
        assert g is None or torch.equal(g[keep], w[keep])
    tri = pair_sweep.pair_sweep_tri(bad, n, box, 6.25)
    assert torch.equal(tri[keep], pair_sweep.pair_sweep_tri(r, n, box, 6.25)[keep])


def test_replica_ensemble_on_card_equals_single_runs(cuda):
    """The ensemble's batched rows engine on the card: each replica's final
    state equals a one-system run_production from its initial state bit
    for bit, through the replica launches only; the series agree to the
    rounding of the batched sums; the replica loop (dense) agrees too."""
    from ljmd_tpu_torch.models.engine import replica_state
    from ljmd_tpu_torch.models.simulation import initialize_replicas, replica_generators

    cfg = SimConfig(num_cells=4, box_length=6.839903786707, rc_over_box=0.365502217277,
                    dt=0.005, total_steps=400, output_interval=20, warmup_steps=100,
                    target_total_energy=-1050.0, dtype="float32", seed=99)
    states = initialize_replicas(cfg, replica_generators(cfg.seed, 4), device=cuda)
    LAUNCHES.reset()
    res = run_production(cfg, states, device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["pair_sweep_tri_replicas"] > 0 and counts["fused_dense_chunk_replicas"] > 0
    assert counts["pair_sweep_tri"] == 0 and counts["fused_dense_chunk"] == 0
    for q in (0, 3):
        one = run_production(cfg, replica_state(states, q), device=cuda)
        for k in ("r", "ru", "v", "a"):
            assert torch.equal(getattr(res.final_state, k)[q], getattr(one.final_state, k))
        _close(res.series[q], one.series, 1e-6)


def _nan_confined(got, poisoned, q_bad):
    """Replica q_bad's first output changed and every other replica's bits
    stayed as they were."""
    keep = [q for q in range(got[0].shape[0]) if q != q_bad]
    assert not torch.equal(poisoned[0][q_bad], got[0][q_bad])
    for g, p in zip(got, poisoned):
        assert torch.equal(p[keep], g[keep])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("hop", ["rect", "self", "full", "half_low", "half_high"])
def test_rect_replica_launches_equal_single_launches(cuda, hop, dtype, tol):
    """Kernels 6 ("rect") and 7 (the other hops) on (R, 8, ld) stacks: ONE
    launch (``*_replicas``) whose replica q equals a launch on replica q
    alone bit for bit, matching the batched twin; a NaN planted in one
    replica stays there."""
    n, reps = 200, 5
    i_lo, j_hi = {"half_low": (n // 2, n), "half_high": (0, n // 2)}.get(hop, (0, n))
    gj0 = 600 if hop == "self" else 0
    pos_i = torch.stack([_rect_rows(n, 256, 7.0, 20 + q, cuda) for q in range(reps)]).to(dtype)
    pos_j = pos_i if hop == "self" else torch.stack(
        [_rect_rows(n, 256, 7.0, 40 + q, cuda) for q in range(reps)]).to(dtype)
    if hop == "rect":
        name = "pair_sweep_rect"

        def run(pi, pj):
            return (pair_sweep.pair_sweep_rect(pi, pj, n, n, 600, gj0, 7.0, 6.25),)

        twin = (pair_sweep.pair_sweep_rect_plain(pos_i, pos_j, n, n, 600, gj0, 7.0, 6.25),)
    else:
        name = "pair_sweep_rect_newton"

        def run(pi, pj):
            return pair_sweep.pair_sweep_rect_newton(pi, pj, n, n, 600, gj0, 7.0, 6.25, i_lo,
                                                     j_hi)

        twin = pair_sweep.pair_sweep_rect_newton_plain(pos_i, pos_j, n, n, 600, gj0, 7.0, 6.25,
                                                       i_lo, j_hi)
    LAUNCHES.reset()
    got = run(pos_i, pos_j)
    counts = LAUNCHES.snapshot()
    assert counts[name + "_replicas"] == 1 and counts[name] == 0
    for q in range(reps):
        for g, w in zip(got, run(pos_i[q].contiguous(), pos_j[q].contiguous())):
            assert torch.equal(g[q], w), q
    for g, w in zip(got, twin):
        _close(g, w, tol)
    bad = pos_i.clone()
    bad[2, 0, 150 if hop == "half_low" else 3] = float("nan")
    _nan_confined(got, run(bad, bad if hop == "self" else pos_j), 2)


def _replica_lists(reps, dtype, cuda, seed=5):
    """R sorted N=864 fluids (n_pad 896) with velocities, accelerations and
    weighted random block flags of their own (every category and the tails
    occur), as CUDA stacks."""
    box, rc2 = 10.0776, 6.25
    rows, vs = [], []
    for q in range(reps):
        n, r = _sorted_lattice(6, box, 896, seed + q)
        v = torch.zeros_like(r)
        v[0:3, :n] = torch.as_tensor(np.random.default_rng(seed + 50 + q).uniform(-1, 1, (3, n)))
        rows.append(r)
        vs.append(v)
    r, v = torch.stack(rows), torch.stack(vs)
    a = 24.0 * pair_sweep.pair_forces_plain(r, n, box, rc2)
    flags = torch.as_tensor(np.random.default_rng(seed).choice(
        [0, 1, 3, 5, 7], p=[0.3, 0.4, 0.1, 0.1, 0.1], size=(reps, 49)).astype(np.int32))
    return n, box, rc2, *(t.to(device=cuda, dtype=dtype) for t in (r, v, a)), flags.to(cuda)


def test_pack_replica_launch_equals_single_launches(cuda):
    """Kernel 9 on (R, n_b^2) flags: ONE launch (a block a replica) whose
    replica q equals a launch on replica q's flags alone (zero_fill: every
    entry), and the twin on the count prefix; flags changed in one replica
    change only its lists. At N=864 and at N=4000's n_pad 4096."""
    from ljmd_tpu_torch.ops import window_lists

    for n_pad, tile_j in ((896, 256), (4096, 512)):
        n_b = n_pad // 128
        flags = torch.as_tensor(np.random.default_rng(n_b).integers(0, 8, (6, n_b * n_b)).astype(
            np.int32)).to(cuda)
        n = n_pad - 32
        LAUNCHES.reset()
        tiles, counts = window_lists.build_window_lists(flags, n, n_pad, 128, tile_j,
                                                        zero_fill=True)
        assert LAUNCHES.snapshot()["build_window_lists_replicas"] == 1
        for q in range(6):
            t1, c1 = window_lists.build_window_lists(flags[q], n, n_pad, 128, tile_j,
                                                     zero_fill=True)
            assert torch.equal(tiles[q], t1) and torch.equal(counts[q], c1)
            wt, wc = window_lists.build_window_lists_plain(flags[q].cpu(), n, n_pad, 128, tile_j)
            assert torch.equal(counts[q].cpu(), wc)
        bad = flags.clone()
        bad[3] = 7
        t2, c2 = window_lists.build_window_lists(bad, n, n_pad, 128, tile_j, zero_fill=True)
        keep = [q for q in range(6) if q != 3]
        assert torch.equal(t2[keep], tiles[keep]) and torch.equal(c2[keep], counts[keep])
        assert not torch.equal(c2[3], counts[3])


def test_pack_one_replica_stack_is_a_replica_launch(cuda):
    """A (1, n_b^2) flag stack goes through the replica launch (counted as
    ``build_window_lists_replicas``, never as the one-system kernel) and
    equals the one-system launch on its flags."""
    from ljmd_tpu_torch.ops import window_lists

    n_pad, n_b = 896, 7
    flags = torch.as_tensor(np.random.default_rng(3).integers(0, 8, (1, n_b * n_b)).astype(
        np.int32)).to(cuda)
    LAUNCHES.reset()
    tiles, counts = window_lists.build_window_lists(flags, 864, n_pad, 128, 256, zero_fill=True)
    got = LAUNCHES.snapshot()
    assert got["build_window_lists_replicas"] == 1 and got["build_window_lists"] == 0
    t1, c1 = window_lists.build_window_lists(flags[0], 864, n_pad, 128, 256, zero_fill=True)
    assert torch.equal(tiles[0], t1) and torch.equal(counts[0], c1)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("mode", ["plain", "extended", "obs_last"])
def test_list_chunk_replica_launch_equals_single_launches(cuda, mode, dtype, tol):
    """Kernel 10 on (R, 8, 896) stacks with (R, ...) lists: ONE launch whose
    replica q equals a launch on replica q alone bit for bit (under a capped
    grid too), matching the twin; a NaN planted in one replica stays
    there."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    reps = 4
    n, box, rc2, r, v, a, flags = _replica_lists(reps, dtype, cuda)
    tiles, counts = window_lists.build_window_lists(flags, n, 896, 128, 256)
    extended, obs_last = mode == "extended", mode == "obs_last"
    zero = torch.zeros_like(r)
    kw = dict(r_lo=zero, vc=zero) if extended else {}

    def run(r_, v_, a_, t_, c_, **more):
        ekw = {k: x[:r_.shape[0]] if r_.dim() == 3 else x[0] for k, x in kw.items()}
        return fused_list._launch(r_, v_, a_, t_, c_, n, box, rc2, 0.004, 6, 128, 256,
                                  ekw.get("r_lo"), ekw.get("vc"), obs_last, **more)

    LAUNCHES.reset()
    got = run(r, v, a, tiles, counts)
    assert LAUNCHES.snapshot()["fused_dense_chunk_list_replicas"] == 1
    got = tuple(g for g in got if g is not None)
    for q in range(reps):
        alone = tuple(x for x in run(r[q], v[q], a[q], tiles[q], counts[q]) if x is not None)
        for g, w in zip(got, alone):
            assert torch.equal(g[q], w), q
    capped = tuple(g for g in run(r, v, a, tiles, counts, grid_cap=7) if g is not None)
    for g, w in zip(capped, got):
        assert torch.equal(g, w)
    twin = fused_list.fused_dense_chunk_list_plain(
        r.cpu(), v.cpu(), a.cpu(), tiles.cpu(), counts.cpu(), n, box, rc2, 0.004, 6,
        tile_j=256, obs_last=obs_last, **{k: x.cpu() for k, x in kw.items()})
    for g, w in zip(got, twin):
        _close(g, w, tol)
    bad = r.clone()
    bad[1, 2, 5] = float("nan")
    poisoned = tuple(g for g in run(bad, v, a, tiles, counts) if g is not None)
    _nan_confined(got, poisoned, 1)


def _edge_fluid(dtype, cuda, seed=11):
    """N=256 (two granules) at rho ~0.15 in L = 12 (rc = 2.5): points at
    least 1.1 apart, eight pairs planted across the x = 0 / L and y = 0 / L
    faces at rc (1 - 1e-7) and rc (1 + 1e-7) (float32 rounds some of them
    inside rc), z-sorted, with velocities, consistent accelerations and
    every block pair listed with its rounds."""
    from ljmd_tpu_torch.ops import window_lists

    box, rc = 12.0, 2.5
    rng = np.random.default_rng(seed)
    pts = []

    def clear(c):
        if not pts:
            return True
        dd = np.asarray(pts) - c
        dd -= box * np.round(dd / box)
        return bool((np.einsum("ij,ij->i", dd, dd) > 1.1 ** 2).all())

    for k in range(8):
        rel = 1e-7 if k % 2 else -1e-7
        a = np.array([0.2 + 0.25 * k, box - 0.3 * k - 0.1, 1.0 + 1.3 * k])
        while True:
            d = rng.normal(size=3)
            b = a + rc * (1 + rel) * d / np.linalg.norm(d)
            if clear(a) and clear(b):
                pts += [a, b]
                break
    while len(pts) < 256:
        c = rng.uniform(0, box, 3)
        if clear(c):
            pts.append(c)
    r = np.mod(np.asarray(pts), box)
    r = r[np.argsort(r[:, 2])]
    rows = torch.zeros((8, 256), dtype=torch.float64)
    rows[0:3] = torch.as_tensor(r.T)
    v = torch.zeros_like(rows)
    v[0:3] = torch.as_tensor(rng.uniform(-1.0, 1.0, (3, 256)))
    a = 24.0 * pair_sweep.pair_forces_plain(rows, 256, box, rc * rc)
    flags = torch.full((4,), 7, dtype=torch.int32)
    tiles, counts = window_lists.build_window_lists_plain(flags, 256, 256, 128, 256)
    return (box, rc * rc, *(t.to(device=cuda, dtype=dtype) for t in (rows, v, a)),
            tiles.to(cuda), counts.to(cuda))


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("mode", ["plain", "extended", "obs_last"])
@pytest.mark.parametrize("state", ["faces", "edge"])
def test_list_chunk_box_skip_matches_twin(cuda, state, mode, dtype, tol):
    """Kernel 10 with its xy order and box skip against the twin (which
    evaluates every listed pair): the N=4000 fluid, whose jittered lattice
    planes straddle x = 0 / L and y = 0 / L inside runs (a run's box wraps)
    and cross those faces during the chunk, and the planted cutoff-edge
    pairs at rc (1 +- 1e-7), whose forces must appear as the twin gives
    them; the box test skips runs in both, where the plane is resident."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    if state == "faces":
        box, rc2, r, v, a = _n4000_fluid(cuda, dtype)
        flags = window_lists.compute_tile_flags(r, 4000, 128, 128, box, 2.5 + 0.7)
        tiles, counts = window_lists.build_window_lists(flags, 4000, 4096, 128, 512)
        n, tj = 4000, 512
    else:
        box, rc2, r, v, a, tiles, counts = _edge_fluid(dtype, cuda)
        n, tj = 256, 256
    extended, obs_last = mode == "extended", mode == "obs_last"
    zero = torch.zeros_like(r)
    kw = dict(r_lo=zero, vc=zero) if extended else {}
    skips = torch.zeros(2, dtype=torch.int64, device=cuda)
    # N=256's plan takes S = 64, which makes no box test: ask for S = 16
    got = fused_list._launch(r, v, a, tiles, counts, n, box, rc2, 0.005, 6, 128, tj,
                             kw.get("r_lo"), kw.get("vc"), obs_last, skip_counts=skips,
                             slices=16 if state == "edge" else None)
    want = fused_list.fused_dense_chunk_list_plain(
        r.cpu(), v.cpu(), a.cpu(), tiles.cpu(), counts.cpu(), n, box, rc2, 0.005, 6, tile_j=tj,
        obs_last=obs_last, **{k: x.cpu() for k, x in kw.items()})
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, tol)
    tested, skipped = skips.tolist()
    if fused_list.list_plan(r, extended, slices=16)["slots"]:
        assert 0 < skipped < tested
    else:  # a streamed plane keeps the column order and tests no run
        assert tested == skipped == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("extended", [False, True], ids=["plain", "extended"])
def test_list_plan_sizes_the_instantiation_it_launches(cuda, extended, dtype):
    """Kernel 10's plan takes the xy order and the box test only where the
    plane is resident, S <= 32 and two blocks an SM hold the plane with its
    boxes; the shared memory it asks for is that plane's (the boxes only
    with the xy order); the replica plan takes the one-replica plan's
    instantiation; N=864 (S = 64) takes the plain one, config 3's float32
    plane the xy order."""
    from ljmd_tpu_torch.ops import fused_list

    rows = 6 if extended else 3
    size = torch.empty((), dtype=dtype).element_size()
    for n_pad in (896, 4096, 8704, 9216, 12288, 37120):
        plan = fused_list.list_plan(torch.zeros((8, n_pad), dtype=dtype, device=cuda), extended)
        boxes = 6 * (n_pad // 16 + 8) if plan["slots"] else 0
        cols = n_pad if plan["resident"] else 3 * 128
        assert plan["smem_bytes"] == (8 + rows * cols + boxes) * size, (n_pad, plan)
        if plan["slots"]:
            assert plan["resident"] and plan["slices"] <= 32 and plan["blocks_per_sm"] >= 2
        stack = torch.zeros((3, 8, n_pad), dtype=dtype, device=cuda)
        rep = fused_list.list_replicas_plan(stack, extended)
        assert (rep["slots"], rep["slices"]) == (plan["slots"], plan["slices"]), n_pad
        if n_pad == 896:
            assert plan["slices"] == 64 and not plan["slots"]
        if n_pad == 4096 and dtype == torch.float32:
            assert plan["slices"] == 16 and plan["slots"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["plain", "extended"])
def test_list_chunk_skip_counts_equal_the_plain_count(cuda, mode, dtype):
    """A one-step launch with v = a = 0 (the step's positions are the
    launch's) counts exactly the runs ``list_skip_counts`` tests and skips
    at those positions and the kernel's S: the N=4000 fluid (S = 16), and an
    (R, 8, 896) stack of N=864 fluids (S = 64: no test), replica by replica
    (none where the plane streams: float64 extended at N=4000); a second
    launch adds as much again."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    box, rc2, r, _, _ = _n4000_fluid(cuda, dtype)
    flags = window_lists.compute_tile_flags(r, 4000, 128, 128, box, 2.5 + 0.7)
    tiles, counts = window_lists.build_window_lists(flags, 4000, 4096, 128, 512)
    n, box4, rc24 = 4000, box, rc2
    reps = 3
    n864, box8, rc28, rs, _, _, flags8 = _replica_lists(reps, dtype, cuda)
    tiles8, counts8 = window_lists.build_window_lists(flags8, n864, 896, 128, 256)
    for rows, t, c, nn, L, rc2_, tj, shape in ((r, tiles, counts, n, box4, rc24, 512, (2,)),
                                               (rs, tiles8, counts8, n864, box8, rc28, 256,
                                                (reps, 2))):
        zero = torch.zeros_like(rows)
        kw = dict(r_lo=zero, vc=zero) if mode == "extended" else {}
        skips = torch.zeros(shape, dtype=torch.int64, device=cuda)
        fused_list.fused_dense_chunk_list(rows, zero, zero, t, c, nn, L, rc2_, 0.005, 1,
                                          tile_j=tj, skip_counts=skips, **kw)
        one = rows[0] if rows.dim() == 3 else rows
        plan = fused_list.list_plan(one, mode == "extended")
        want = fused_list.list_skip_counts(rows.cpu(), t.cpu(), c.cpu(), nn, L, rc2_, tj,
                                           plan["slices"])
        assert bool((want[..., 1] > 0).all()) == (plan["slices"] < 64)  # S = 64: no test
        if not plan["slots"]:  # the streamed plane tests no run
            want = torch.zeros_like(want)
        assert torch.equal(skips.cpu(), want), (skips.tolist(), want.tolist())
        fused_list.fused_dense_chunk_list(rows, zero, zero, t, c, nn, L, rc2_, 0.005, 1,
                                          tile_j=tj, skip_counts=skips, **kw)
        assert torch.equal(skips.cpu(), 2 * want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["plain", "extended", "obs_last"])
def test_list_chunk_slots_replica_launch_equals_single_launches(cuda, mode, dtype):
    """Kernel 10's replica launch where the order and the box test are on
    (N=4000, S = 16; float64 extended streams its plane): replica q of an
    (R, 8, 4096) stack equals a launch on replica q alone bit for bit, under
    a capped grid too, and so do its skip counts; the float32 plain launch
    matches the twin; a NaN planted in one replica stays there."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    fluids = [_n4000_fluid(cuda, dtype, seed) for seed in (40, 41)]
    box, rc2 = fluids[0][:2]
    r, v, a = (torch.stack([f[k] for f in fluids]) for k in (2, 3, 4))
    flags = window_lists.compute_tile_flags(r, 4000, 128, 128, box, 2.5 + 0.7)
    tiles, counts = window_lists.build_window_lists(flags, 4000, 4096, 128, 512)
    extended, obs_last = mode == "extended", mode == "obs_last"
    zero = torch.zeros_like(r)

    def run(r_, v_, a_, t_, c_, skips, **more):
        ext = (zero[:r_.shape[0]] if r_.dim() == 3 else zero[0]) if extended else None
        out = fused_list._launch(r_, v_, a_, t_, c_, 4000, box, rc2, 0.005, 5, 128, 512, ext,
                                 ext, obs_last, skip_counts=skips, **more)
        return tuple(x for x in out if x is not None)

    skips = torch.zeros((2, 2), dtype=torch.int64, device=cuda)
    got = run(r, v, a, tiles, counts, skips)
    for q in range(2):
        one = torch.zeros(2, dtype=torch.int64, device=cuda)
        alone = run(r[q], v[q], a[q], tiles[q], counts[q], one)
        for g, w in zip(got, alone):
            assert torch.equal(g[q], w), q
        assert torch.equal(skips[q], one), q
    slots = fused_list.list_plan(r[0], extended)["slots"]
    assert bool((skips[:, 1] > 0).all()) == slots
    capped = run(r, v, a, tiles, counts, None, grid_cap=37)
    for g, w in zip(capped, got):
        assert torch.equal(g, w)
    if mode == "plain" and dtype == torch.float32:
        twin = fused_list.fused_dense_chunk_list_plain(
            r.cpu(), v.cpu(), a.cpu(), tiles.cpu(), counts.cpu(), 4000, box, rc2, 0.005, 5)
        for g, w in zip(got, twin):
            _close(g, w, 1e-4)
    bad = r.clone()
    bad[1, 0, 777] = float("nan")
    _nan_confined(got, run(bad, v, a, tiles, counts, None), 1)


def test_zsort_engine_reports_the_skip_share_on_card(cuda):
    """The zsort engine's ``list_skip_share`` on the card: the share of
    kernel 10's box tests that skipped since ``init``, a replica's each for
    a stack, and no host read or launch more than the chunk's; each
    ``init`` starts a carry's own counts."""
    from ljmd_tpu_torch.models.simulation import initialize_replicas, replica_generators

    cfg = SimConfig(num_cells=10, box_length=16.795961913825, rc_over_box=0.148845300604,
                    dt=0.005, total_steps=64, output_interval=32, warmup_steps=20,
                    target_total_energy=-18800.0, dtype="float32")
    states = initialize_replicas(cfg, replica_generators(3, 2), backend="rows", device=cuda)
    for st in (states, pe.replica_state(states, 0)):
        eng = (pe.make_replica_engine(cfg, 2, "zsort", cuda, states=st) if st.r.dim() == 3
               else pe.make_engine(cfg, "zsort", cuda, state=st))
        c = eng.init(st)[0]
        reads = dict(pe.HOST_READS)
        LAUNCHES.reset()
        c = eng.run_fast(c, 32)
        launched = LAUNCHES.snapshot()
        share = eng.counters(c)["list_skip_share"]
        assert dict(pe.HOST_READS) == reads
        assert sum(launched.values()) == 3 * 2  # two chunks: the resort's two launches, kernel 10
        assert share.shape == st.r.shape[:-2]
        assert bool(((share > 0.2) & (share < 1.0)).all()), share
        # the counts ride in the carry: a second init and its chunk leave
        # the first carry's as they were
        before = c.skips.clone()
        c2 = eng.run_fast(eng.init(st)[0], 16)
        assert torch.equal(c.skips, before)
        assert bool((c2.skips[..., 0] < before[..., 0]).all())


def test_zsort_ensemble_on_card_equals_single_runs(cuda):
    """The batched zsort engine on the card: through the replica launches
    of the resort (its sort kernel and kernel 9) and kernel 10 only, each
    replica's final state equal to a one-system zsort run from its initial
    state bit for bit."""
    from ljmd_tpu_torch.models.engine import replica_state
    from ljmd_tpu_torch.models.simulation import initialize_replicas, replica_generators

    cfg = SimConfig(num_cells=5, box_length=8.55, rc_over_box=2.5 / 8.55, dt=0.003,
                    total_steps=200, output_interval=20, warmup_steps=20,
                    target_total_energy=-2300.0, dtype="float32")
    states = initialize_replicas(cfg, replica_generators(3, 4), backend="rows", device=cuda)
    LAUNCHES.reset()
    res = run_production(cfg, states, backend="zsort", device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["zsort_sort_replicas"] == counts["zsort_pack_replicas"] > 0
    assert counts["fused_dense_chunk_list_replicas"] > 0
    assert counts["zsort_sort"] == counts["zsort_pack"] == counts["fused_dense_chunk_list"] == 0
    assert counts["build_window_lists"] == counts["build_window_lists_replicas"] == 0
    assert not bool(res.diagnostics["zsort_invalid"].any())
    # one-system runs on an engine built for the stack's temperature (the
    # batched engine's skin is the hottest replica's)
    one_engine = pe.make_engine(cfg, "zsort", cuda, state=states,
                                sample_interval=cfg.output_interval)
    for q in (0, 3):
        one = run_production(cfg, replica_state(states, q), engine=one_engine, device=cuda)
        for k in ("r", "ru", "v", "a"):
            assert torch.equal(getattr(res.final_state, k)[q], getattr(one.final_state, k))
        _close(res.series[q], one.series, 1e-5)


@pytest.mark.parametrize("comm", ["half_ring", "ring"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_replica_x_particle_step_on_card_equals_single_runs(cuda, comm, dtype):
    """The replica x particle step on a (2, 2) thread mesh on the card:
    replica launches only, each replica's shards after 20 steps equal to
    make_spatial_step_fn on a 2-rank particle mesh on that replica alone,
    bit for bit."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.parallel import spatial as psp
    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.state import MDState

    cfg = SimConfig(num_cells=4, box_length=6.84, rc_over_box=2.5 / 6.84, dt=0.004,
                    total_steps=100, output_interval=10, warmup_steps=0,
                    target_total_energy=-1000.0, dtype=dtype)
    tdt = torch.float32 if dtype == "float32" else torch.float64
    rng = np.random.default_rng(3)
    lattice = fcc_lattice(4, cfg.box_length, dtype=torch.float64).numpy()
    r = np.stack([(lattice + rng.normal(0, 0.05, lattice.shape)) % cfg.box_length
                  for _ in range(4)])
    v = rng.uniform(-0.5, 0.5, r.shape)
    st = MDState(*(torch.as_tensor(x, dtype=tdt, device=cuda)
                   for x in (r, r, v - v.mean(1, keepdims=True), np.zeros_like(r))))
    mesh, one_mesh = (make_mesh(particle=2, replica=2, device=cuda),
                      make_mesh(particle=2, device=cuda))
    try:
        fn = psp.make_ensemble_spatial_step_fn(cfg, mesh, comm=comm)
        c, _ = fn.init(psp.shard_replica_states(st, mesh, cfg))
        LAUNCHES.reset()
        for _ in range(20):
            c, obs = fn(c)
        counts = LAUNCHES.snapshot()
        hop = "pair_sweep_rect_newton" if comm == "half_ring" else "pair_sweep_rect"
        assert counts[hop + "_replicas"] > 0 and counts[hop] == 0
        one = psp.make_spatial_step_fn(cfg, one_mesh, comm=comm)
        init_local = psp._make_local_step(cfg, comm).init_local
        got = psp.gather_replica_states(c, mesh)
        for q in (0, 3):
            cq = psp.shard_state(MDState(*(getattr(st, k)[q] for k in ("r", "ru", "v", "a"))),
                                 one_mesh, cfg)
            cq = tuple(x for x, _ in one_mesh.run(init_local, cq))
            for _ in range(20):
                cq, oq = one(cq)
            for k in ("r", "ru", "v", "a"):
                want = one_mesh.gather([getattr(x, k) for x in cq])
                assert torch.equal(getattr(got, k)[q], want), (q, k)
            _close(obs.epot[q], oq.epot, 1e-5 if dtype == "float32" else 1e-12)
    finally:
        mesh.close()
        one_mesh.close()


def _pencil_stack(reps, dtype, extended=False):
    """R cell-pair carries at _pencil_carry's geometry (N=2048, 4x4 pencils
    of capacity 256), each from its own seed, as the batched engine's flat
    stack built on the CPU, with the one-grid tables and the stack's."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import cell_list, pencil_sweep
    from ljmd_tpu_torch.state import MDState

    cfg = SimConfig(num_cells=8, box_length=13.4, rc_over_box=2.5 / 13.4, dt=0.004,
                    dtype=dtype, target_total_energy=-9000.0, neighbor_capacity=256)
    tdt = torch.float64 if dtype == "float64" else torch.float32
    lat = fcc_lattice(8, 13.4, dtype=torch.float64)
    rs, vs = [], []
    for q in range(reps):
        rng = np.random.default_rng(30 + q)
        rs.append(torch.remainder(lat + torch.as_tensor(rng.normal(0, 0.05, lat.shape)), 13.4))
        vs.append(torch.as_tensor(rng.normal(0, 1.0, lat.shape)))
    r, v = torch.stack(rs).to(tdt), torch.stack(vs).to(tdt)
    eng = pe._cellpair_engine(cfg, "cpu", compensated=extended, width_lists=True, replicas=reps)
    carry, _ = eng.init(MDState(r=r, ru=r, v=v, a=torch.zeros_like(r)))
    grid = cell_list.make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                      cfg.density, 256)
    tbl, shf = (torch.as_tensor(t) for t in pencil_sweep.build_half_shell_tables(grid))
    return cfg, grid, carry, (tbl, shf), pencil_sweep.replica_tables(tbl, shf,
                                                                     grid.n_pencils, reps)


@pytest.mark.parametrize("mode,tol", [("float64", 1e-10), ("float32", 1e-4), ("extended", 1e-4)])
@pytest.mark.parametrize("kernel", ["sweep", "static", "width"])
def test_pencil_replica_launches_equal_single_launches(cuda, kernel, mode, tol):
    """Kernels 13, 15 and 16 over a flat stack of 3 grids: ONE launch
    (counted under the ``_replicas`` name), each replica's slots equal to a
    launch on its grid alone bit for bit, the chunks also under a grid
    capped to 2 blocks, and the whole stack within ``tol`` of the twin."""
    from ljmd_tpu_torch.ops import fused_pencil, pencil_sweep

    reps = 3
    extended = mode == "extended"
    cfg, grid, c, one_tbl, rep_tbl = _pencil_stack(reps, "float64" if mode == "float64"
                                                   else "float32", extended)
    P, cap, ns = grid.n_pencils, grid.capacity, grid.n_slots
    args = (P, cap, cfg.box_length, cfg.rc_square, cfg.dt, 6)
    ext = dict(r_lo=c.rc, vc=c.vc) if extended else {}

    def launch(r, v, a, counts, tables, replicas, **kw):
        tbl, shf = tables
        if kernel == "sweep":
            return (pencil_sweep.pencil_sweep_hs(r, tbl, counts, shf, grid, cfg.rc_square, True,
                                                 replicas=replicas),)
        if kernel == "static":
            if "grid_cap" in kw:
                return fused_pencil._launch_static(
                    r, v, a, tbl, shf, P * (replicas or 1), *args[1:], kw.get("r_lo"),
                    kw.get("vc"), grid_cap=kw["grid_cap"])
            return fused_pencil.fused_pencil_chunk(r, v, a, tbl, shf, *args, replicas=replicas,
                                                   **kw)
        lists = fused_pencil.build_width_lists(counts, tbl, shf, P * (replicas or 1), cap)
        if "grid_cap" in kw:
            return fused_pencil._launch_width(r, v, a, lists, P * (replicas or 1), *args[1:],
                                              kw.get("r_lo"), kw.get("vc"),
                                              grid_cap=kw["grid_cap"])
        return fused_pencil.fused_pencil_width_chunk(r, v, a, *lists, *args, replicas=replicas,
                                                     **kw)

    dev = {k: getattr(c, k).to(cuda) for k in ("r", "v", "a", "counts")}
    dext = {k: t.to(cuda) for k, t in ext.items()}
    tables = tuple(t.to(cuda) for t in rep_tbl)
    name = {"sweep": "pencil_sweep_hs", "static": "fused_pencil_chunk",
            "width": "fused_pencil_width_chunk"}[kernel]
    LAUNCHES.reset()
    got = launch(dev["r"], dev["v"], dev["a"], dev["counts"], tables, reps, **dext)
    counts = LAUNCHES.snapshot()
    assert counts[name + "_replicas"] == 1 and counts[name] == 0
    want = launch(c.r, c.v, c.a, c.counts, rep_tbl, reps, **ext)
    for g, w in zip(got, want):
        _close(g, w, tol)
    one_tables = tuple(t.to(cuda) for t in one_tbl)
    for q in range(reps):
        sl = slice(q * ns, (q + 1) * ns)
        one = launch(*(dev[k][:, sl].contiguous() for k in ("r", "v", "a")),
                     dev["counts"][q * P:(q + 1) * P].contiguous(), one_tables, None,
                     **{k: t[:, sl].contiguous() for k, t in dext.items()})
        for g, w in zip(got, one):
            assert torch.equal(g[:, sl], w), q
    if kernel != "sweep":
        capped = launch(dev["r"], dev["v"], dev["a"], dev["counts"], tables, reps, grid_cap=2,
                        **dext)
        for g, w in zip(got, capped):
            assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,compensated", [("float64", False), ("float32", False),
                                               ("float32", True)])
def test_cellpair_ensemble_on_card_equals_single_runs(cuda, dtype, compensated):
    """The batched cell-pair engine on the card: only the replica launches
    of kernels 13 and 15 (or 16), each replica's final state and series
    equal to a one-system run at the same capacity bit for bit."""
    from ljmd_tpu_torch.models.engine import replica_state
    from ljmd_tpu_torch.models.simulation import initialize_replicas, replica_generators

    cfg = SimConfig(num_cells=5, box_length=9.1, rc_over_box=2.5 / 9.1, dt=0.002,
                    total_steps=60, output_interval=10, warmup_steps=10, neighbor_skin=0.3,
                    target_total_energy=-2000.0, dtype=dtype, compensated_sum=compensated)
    states = initialize_replicas(cfg, replica_generators(3, 3), backend="rows", device=cuda)
    cfg = cfg.replace(neighbor_capacity=pe.replica_capacity(cfg, states))
    LAUNCHES.reset()
    res = run_production(cfg, states, backend="cellpair", device=cuda)
    counts = LAUNCHES.snapshot()
    assert counts["pencil_sweep_hs_replicas"] > 0 and counts["fused_pencil_chunk_replicas"] > 0
    assert counts["pencil_sweep_hs"] == 0 and counts["fused_pencil_chunk"] == 0
    assert not bool(res.diagnostics["pencil_overflow"].any())
    for q in range(3):
        one = run_production(cfg, replica_state(states, q), backend="cellpair", device=cuda)
        assert torch.equal(res.series[q], one.series)
        for k in ("r", "ru", "v", "a"):
            assert torch.equal(getattr(res.final_state, k)[q], getattr(one.final_state, k))


def _sweep_stack(kind, cap, dtype, reps=3):
    """R grids side by side for kernels 11 and 12's replica launches, on the
    CPU: ``full``: _full_slots' jittered lattice (4x4 pencils) from R seeds
    at capacity ``cap`` with sentinels; ``zband``: _tall_slots' tall box from
    R seeds (3x3 pencils of capacity 512, window 384) with the stack's z
    windows. Returns (grid, window, stack rows, counts, the one-grid tables,
    the stack's tables, the stack's windows)."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice
    from ljmd_tpu_torch.ops import cell_list, pencil_sweep

    rows, window = [], None
    for q in range(reps):
        rng = np.random.default_rng(50 + q)
        if kind == "full":
            n, box, r_list = 2048, 13.4, 2.9
            r = torch.remainder(fcc_lattice(8, box, dtype=torch.float64)
                                + torch.as_tensor(rng.normal(0, 0.05, (n, 3))), box)
        else:
            n, box, r_list = 1600, 60.0, 20.0
            r = torch.as_tensor(rng.uniform(0, box, size=(n, 3)))
        grid = cell_list.make_pencil_grid(n, box, r_list, n / box**3, cap)
        slot, ovf = cell_list.bin_to_slots(r, grid)
        assert not bool(ovf)
        pos = torch.zeros((8, grid.n_slots + 1), dtype=torch.float64)
        pos[0:3, slot] = r.T
        pos[3, slot] = 1.0
        rows.append(pos[:, :grid.n_slots])
    P = grid.n_pencils
    pos = pencil_sweep.sentinel_fill(torch.cat(rows, dim=1), torch.cat(rows, dim=1)[3], cap, P)
    pos = pos.to(dtype).contiguous()
    counts = pos[3].reshape(reps * P, cap).sum(1).to(torch.int32)
    tbl = torch.as_tensor(pencil_sweep.build_tile_table(grid))
    shf = torch.as_tensor(pencil_sweep.build_shift_table(grid))
    wins = None
    if kind == "zband":
        window = cell_list.default_z_window(grid, n, 2.9)
        *wins, w_ovf = cell_list.compute_z_windows(pos, pos[3], counts, grid, window, 2.9,
                                                   replicas=reps)
        assert window < cap and not bool(w_ovf.any())
    return grid, window, pos, counts, (tbl, shf), pencil_sweep.replica_tables(tbl, shf, P, reps), \
        wins


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
@pytest.mark.parametrize("want_obs", [True, False])
@pytest.mark.parametrize("kind,cap", [("full", 384), ("full", 512), ("zband", 512)])
def test_full_sweep_replica_launches_equal_single_launches(cuda, kind, cap, want_obs, dtype,
                                                           tol):
    """Kernels 11 and 12 over a flat stack of 3 grids: ONE launch (counted
    under the ``_replicas`` name), within ``tol`` of the twin over the
    stack, and each replica's slots bit for bit a launch on its grid alone
    (its tables, counts and z windows)."""
    from ljmd_tpu_torch.ops import pencil_sweep

    reps = 3
    grid, window, pos, counts, (tbl, shf), (rtbl, rshf), wins = _sweep_stack(kind, cap, dtype,
                                                                              reps)
    P, ns = grid.n_pencils, grid.n_slots
    name = "pencil_sweep_full" if kind == "full" else "pencil_sweep_zband"

    def launch(p, n, t, s, w, replicas):
        if kind == "full":
            return pencil_sweep.pencil_sweep(p, t, n, s, grid, 6.25, want_obs, replicas=replicas)
        return pencil_sweep.pencil_sweep_zband(p, t, n, *w, grid, 6.25, window, want_obs,
                                               replicas=replicas)

    dwins = None if wins is None else [w.to(cuda) for w in wins]
    LAUNCHES.reset()
    got = launch(pos.to(cuda), counts.to(cuda), rtbl.to(cuda), rshf.to(cuda), dwins, reps)
    launched = LAUNCHES.snapshot()
    assert launched[name + "_replicas"] == 1 and launched[name] == 0
    want = launch(pos, counts, rtbl, rshf, wins, reps)
    for row in range(8):
        _close(got[row], want[row], tol)
    T = ns // 128
    for q in range(reps):
        sl = slice(q * ns, (q + 1) * ns)
        w_q = None if wins is None else [w[q * T * 9:(q + 1) * T * 9].contiguous().to(cuda)
                                         for w in wins]
        one = launch(pos[:, sl].contiguous().to(cuda), counts[q * P:(q + 1) * P].to(cuda),
                     tbl.to(cuda), shf.to(cuda), w_q, None)
        assert torch.equal(got[:, sl], one), q


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("backend", ["neighbor", "dense"])
def test_neighbor_dense_ensembles_on_card_equal_loop(cuda, backend, dtype):
    """The batched neighbor and dense engines on the card against the loop
    of one-system engines from the same (batched warmup's) states: no kernel
    launched, the final states bit for bit, the series bit for bit or
    within rtol 1e-13 (float64) / 1e-6 (float32) where the (R,) sums round
    otherwise, one rebuild read a step for the stack. The rule is
    chip_smoke.py's (_obs_match): each row relative to itself, element by
    element, but the pressure, made from the virial d_epot (a sum that
    cancels), relative to the sample's scale (the replica's largest |row|
    at that sample)."""
    cfg = SimConfig(num_cells=5, box_length=9.1, rc_over_box=2.5 / 9.1, dt=0.002,
                    total_steps=60, output_interval=10, warmup_steps=10, neighbor_skin=0.3,
                    target_total_energy=-2000.0, dtype=dtype)
    from ljmd_tpu_torch.models.simulation import initialize_replicas, replica_generators

    reps = 3
    states = initialize_replicas(cfg, replica_generators(3, reps), backend=backend, device=cuda)
    loop = pe._replica_loop_engine([pe.make_engine(cfg, backend, cuda) for _ in range(reps)])
    LAUNCHES.reset()
    reads = pe.HOST_READS["neighbor_rebuild"]
    res = run_production(cfg, states, backend=backend, device=cuda)
    assert not any(LAUNCHES.snapshot().values())
    if backend == "neighbor":
        assert pe.HOST_READS["neighbor_rebuild"] - reads == cfg.total_steps
        assert not bool(res.diagnostics["neighbor_overflow"].any())
    want = run_production(cfg, states, engine=loop)
    for k in ("r", "ru", "v", "a"):
        assert torch.equal(getattr(res.final_state, k), getattr(want.final_state, k)), k
    rtol = 1e-13 if dtype == "float64" else 1e-6
    got, ref = res.series, want.series  # (R, 5, samples), rows SERIES_OBSERVABLES
    torch.testing.assert_close(got[:, :4], ref[:, :4], rtol=rtol, atol=0.0)
    scale = ref.abs().amax(dim=1)
    assert float(((got[:, 4] - ref[:, 4]).abs() / scale).max()) <= rtol


@pytest.mark.parametrize("mode", ["full9", "zband", "unfused"])
def test_cellpair_sweep_variants_on_card_equal_loop(cuda, mode):
    """The batched cell-pair engine's full sweep, z-band and unfused chunk
    on the card: only the replica launches of kernel 11, 12 or 13, each
    replica's final state and series equal to the loop of one-system
    engines at the same capacity and chunk, bit for bit (float64)."""
    cfg = SimConfig(num_cells=5, box_length=9.1, rc_over_box=2.5 / 9.1, dt=0.002,
                    total_steps=40, output_interval=10, warmup_steps=10, neighbor_skin=0.3,
                    target_total_energy=-2000.0, dtype="float64",
                    neighbor_capacity=512 if mode == "zband" else 128)
    from ljmd_tpu_torch.models.simulation import initialize_replicas, replica_generators

    kw = {"full9": {"half_shell": False}, "zband": {"z_band": True},
          "unfused": {"use_fused": False}}[mode]
    kernel = {"full9": "pencil_sweep_full", "zband": "pencil_sweep_zband",
              "unfused": "pencil_sweep_hs"}[mode]
    reps = 3
    states = initialize_replicas(cfg, replica_generators(3, reps), backend="rows", device=cuda)
    batched = pe._cellpair_engine(cfg, cuda, replicas=reps, inner_chunk=4, **kw)
    loop = pe._replica_loop_engine([pe._cellpair_engine(cfg, cuda, inner_chunk=4, **kw)
                                    for _ in range(reps)])
    LAUNCHES.reset()
    res = run_production(cfg, states, engine=batched)
    launched = LAUNCHES.snapshot()
    assert launched[kernel + "_replicas"] > 0 and launched[kernel] == 0
    want = run_production(cfg, states, engine=loop)
    assert torch.equal(res.series, want.series)
    for k in ("r", "ru", "v", "a"):
        assert torch.equal(getattr(res.final_state, k), getattr(want.final_state, k)), k
    # This short box wraps a slice's z margin at both faces (the z-band's
    # window flag, as on the CPU); the other sweeps keep the flag clear.
    assert torch.equal(res.diagnostics["pencil_overflow"], want.diagnostics["pencil_overflow"])
    assert bool(res.diagnostics["pencil_overflow"].any()) == (mode == "zband")
