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


def _n4000_fluid(device, dtype):
    """The N=4000 production box's perturbed FCC lattice, z-sorted, with
    velocities and consistent accelerations, as (8, 4096) rows."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice

    box, rc2 = 16.795961913825, (0.148845300604 * 16.795961913825) ** 2
    rng = np.random.default_rng(40)
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
    """The persistent grid: capped at 32 blocks (4 tiles a block) the chunk
    equals the uncapped one bit for bit; so does the list chunk at 48."""
    from ljmd_tpu_torch.ops import fused_list, window_lists

    box, rc2, r, v, a = _n4000_fluid(cuda, dtype)
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
