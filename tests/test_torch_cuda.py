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
    assert counts["build_window_lists"] > 0 and counts["fused_dense_chunk_list"] > 0
    assert counts["fused_dense_chunk"] == 0
    np.testing.assert_allclose(gpu.series.cpu().numpy(), cpu.series.numpy(), rtol=1e-9)
    assert not bool(gpu.diagnostics["zsort_invalid"])
    assert pe.auto_backend(cfg, True) == "rows"  # L < 4 rc: JAX's accelerator branch


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
    np.testing.assert_allclose(gpu.series.cpu().numpy(), cpu.series.numpy(), rtol=1e-9)
    assert not bool(gpu.diagnostics["pencil_overflow"])
