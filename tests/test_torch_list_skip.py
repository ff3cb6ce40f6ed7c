"""Kernel 10's xy order and box test in plain torch (``ops/fused_list.py``):
``list_granule_order`` (each granule's slots), ``list_skip_runs`` and
``list_skip_counts`` (the runs a warp tests and skips at one step).

The kernel skips a warp's run of partner slots only where these functions
do (``tests/test_torch_cuda.py`` holds the card's counts to them), so the
property that makes the skip exact is checked here: no skipped run holds a
pair whose float r^2, computed as the pair loop computes it, lies inside
rc^2. Config 3 (N=4000, L=16.796) is the main path's state; N=864's plan
(S = 64, two warps a particle) makes no test.
"""

import math

import numpy as np
import pytest
import torch

from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import fused_list, window_lists
from ljmd_tpu_torch.state import MDState

CONFIG3 = dict(num_cells=10, box_length=16.795961913825, rc_over_box=0.148845300604, dt=0.005,
               total_steps=100, output_interval=50, warmup_steps=0, target_total_energy=-18800.0,
               dtype="float32")
CONFIG2 = dict(CONFIG3, num_cells=6, box_length=10.0776, rc_over_box=2.5 / 10.0776)


def _carry(params, seed):
    """The zsort engine's carry of a jittered FCC lattice at T ~0.84 (CPU,
    float32): rows in sorted column order and their lists."""
    cfg = SimConfig(**params)
    rng = np.random.default_rng(seed)
    r = np.mod(fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64).numpy()
               + rng.normal(scale=0.1, size=(cfg.n, 3)), cfg.box_length)
    v = rng.normal(scale=math.sqrt(0.84), size=r.shape)
    v -= v.mean(axis=0)
    t = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
    state = MDState(r=t(r), ru=t(r), v=t(v), a=t(np.zeros_like(r)))
    eng = pe.make_engine(cfg, "zsort", "cpu", state=state)
    carry, _ = eng.init(state)
    geo = pe.zsort_geometry(cfg, temperature=pe.kinetic_temperature(state))
    return cfg, carry, geo.tile_j


@pytest.fixture(scope="module")
def config3():
    return _carry(CONFIG3, 1)


@pytest.fixture(scope="module")
def config2():
    return _carry(CONFIG2, 2)


def _pair_r2(pos, i, j, meta, box_length):
    """r^2 of pairs (i, j) (slots' columns) as the pair loop rounds it: the
    difference, the stage's x / z rounds and the y round, then
    (dx^2 + dy^2) + dz^2, in pos's dtype."""
    L = torch.tensor(box_length, dtype=pos.dtype)
    inv_l = torch.tensor(1.0 / box_length, dtype=pos.dtype)

    def mic(d):
        return d - L * torch.round(d * inv_l)

    dx, dy, dz = (pos[c][i] - pos[c][j] for c in range(3))
    dx = torch.where((meta & 4) > 0, mic(dx), dx)
    dz = torch.where((meta & 8) > 0, mic(dz), dz)
    dy = mic(dy)
    return dx * dx + dy * dy + dz * dz


def _check_skipped_pairs(pos, n, tiles, tcounts, box_length, rc_square, tile_j, slices):
    """Every pair of a real slot of a warp and a slot of a run it skips has
    float r^2 >= rc^2; returns (runs tested, runs skipped)."""
    t = fused_list.list_skip_runs(pos, tiles, tcounts, n, box_length, rc_square, tile_j, slices)
    perm, skip = t["perm"], t["skip"] & t["live"][..., None]
    found = torch.nonzero(skip, as_tuple=True)
    for c0 in range(0, found[0].numel(), 50_000):
        e, w, k = (x[c0:c0 + 50_000] for x in found)
        slots = t["slots"][e, w]                      # (m, particles a warp)
        cols = t["cols"][e, w, k]                     # (m, run width)
        i = perm[slots][:, :, None].expand(-1, -1, cols.shape[-1])
        j = perm[cols][:, None, :].expand(-1, slots.shape[-1], -1)
        r2 = _pair_r2(pos, i, j, t["meta"][e][:, None, None], box_length)
        assert bool((r2[i < n] >= rc_square).all())
    return int(t["live"].sum()) * skip.shape[-1], int(skip.sum())


def _orders_are_stable_permutations(pos, n, box_length, cells):
    perm = fused_list.list_granule_order(pos, n, box_length, cells)
    n_pad = pos.shape[-1]
    g = perm.reshape(-1, 128)
    base = torch.arange(n_pad // 128)[:, None] * 128
    assert torch.equal(torch.sort(g, dim=1).values, base + torch.arange(128))
    scale = torch.tensor(cells / box_length, dtype=pos.dtype)

    def cell(x):
        f = x * scale
        return torch.where(f >= cells - 1, cells - 1,
                           torch.where(f >= 1, torch.floor(f), 0.0)).long()

    cx, cy = cell(pos[0]), cell(pos[1])
    key = torch.where(torch.arange(n_pad) < n,
                      cy * cells + torch.where(cy % 2 == 1, cells - 1 - cx, cx), cells * cells)
    k = key[perm].reshape(-1, 128)
    assert bool((k[:, 1:] >= k[:, :-1]).all())                     # sorted by key
    ties = k[:, 1:] == k[:, :-1]
    assert bool((g[:, 1:] > g[:, :-1])[ties].all())                # stable
    return perm


def test_cells_follow_the_box_and_the_cutoff():
    assert fused_list.list_cells(16.795961913825, 2.5) == 8
    assert fused_list.list_cells(10.0776, 2.5) == 5
    assert fused_list.list_cells(41.99, 2.5) == fused_list.LIST_MAX_CELLS
    assert fused_list.list_cells(1.0, 2.5) == 1


@pytest.mark.parametrize("which", ["config3", "config2", "faces", "nan"])
def test_granule_order_is_a_stable_permutation(config3, config2, which):
    """Each granule's slots are a permutation of its columns, sorted by the
    xy cell's snake key with padding last, equal keys in column order; a
    state past the faces (positions in [-0.1, L + 0.1), as inside a chunk)
    and a NaN take cell 0 at worst."""
    cfg, carry, _ = config2 if which == "config2" else config3
    pos = carry.r.clone()
    if which == "faces":
        gen = torch.Generator().manual_seed(3)
        pos[0:2, :cfg.n] += torch.empty((2, cfg.n)).uniform_(-0.1, 0.1, generator=gen)
    if which == "nan":
        pos[0, 7] = float("nan")
        pos[1, 300] = float("inf")
    cells = fused_list.list_cells(cfg.box_length, cfg.rc)
    perm = _orders_are_stable_permutations(pos, cfg.n, cfg.box_length, cells)
    assert bool((perm[cfg.n:] >= cfg.n).all())  # padding slots last


def test_granule_order_of_a_stack_is_each_replicas():
    """(R, 8, n_pad) rows: each replica's order is its own rows' order."""
    cfg, carry, _ = _carry(CONFIG2, 5)
    stack = torch.stack([carry.r, carry.r.flip(-1) * 0.5])
    got = fused_list.list_granule_order(stack, cfg.n, cfg.box_length, 5)
    for q in range(2):
        assert torch.equal(got[q], fused_list.list_granule_order(stack[q], cfg.n,
                                                                 cfg.box_length, 5))


def test_two_runs_a_stage_are_kept_untested(config2):
    """At S = 64 (N=864's plan: a warp takes two 32-slot runs of a stage) the
    kernel makes no box test: nothing is tested or skipped."""
    cfg, carry, tile_j = config2
    with pytest.raises(ValueError, match="no run"):
        fused_list.list_skip_runs(carry.r, carry.tiles, carry.tcounts, cfg.n, cfg.box_length,
                                  cfg.rc_square, tile_j, 64)
    got = fused_list.list_skip_counts(carry.r, carry.tiles, carry.tcounts, cfg.n,
                                      cfg.box_length, cfg.rc_square, tile_j, 64)
    assert got.tolist() == [0, 0]


def test_skip_share_at_config_3(config3):
    """The box test skips at least 60% of the runs the warps test at config
    3's S = 16 (the card's plan at N=4000)."""
    cfg, carry, tile_j = config3
    tested, skipped = fused_list.list_skip_counts(carry.r, carry.tiles, carry.tcounts, cfg.n,
                                                  cfg.box_length, cfg.rc_square, tile_j,
                                                  16).tolist()
    assert tested > 0 and skipped / tested >= 0.6


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case,slices", [("config3", 16), ("config3", 4), ("config3", 32),
                                         ("config2", 16), ("config2", 32), ("faces", 16)])
def test_skipped_runs_hold_no_pair_inside_the_cutoff(config3, config2, case, slices, dtype):
    """No run a warp skips holds a pair (a real slot of the warp, any slot
    of the run) whose r^2, rounded as the pair loop rounds it with the
    stage's minimum-image rounds, lies below rc^2; and the test skips runs
    (at config 3, S = 16, more than half)."""
    cfg, carry, tile_j = config2 if case == "config2" else config3
    pos = carry.r.to(dtype)
    if case == "faces":
        pos = pos.clone()
        pos[0:2, :cfg.n] += torch.empty((2, cfg.n), dtype=dtype).uniform_(
            -0.1, 0.1, generator=torch.Generator().manual_seed(4))
    tested, skipped = _check_skipped_pairs(pos, cfg.n, carry.tiles, carry.tcounts,
                                           cfg.box_length, cfg.rc_square, tile_j, slices)
    assert skipped > 0.3 * tested


def _two_points(box_length, gap, dtype, offset):
    """N=256 (two granules, every block pair listed): granule 0's columns
    at one point P, granule 1's at Q = P + gap (1, 1, 1) / sqrt(3), P near
    the x = 0 face so that Q's x image wraps when offset < 0."""
    n, n_pad = 256, 256
    pos = torch.zeros((8, n_pad), dtype=torch.float64)
    p = torch.tensor([offset, 5.0, 5.0], dtype=torch.float64) % box_length
    q = (p + gap / math.sqrt(3.0)) % box_length
    pos[0:3, :128] = p[:, None]
    pos[0:3, 128:] = q[:, None]
    flags = torch.full((4,), 7, dtype=torch.int32)
    tiles, tcounts = window_lists.build_window_lists_plain(flags, n, n_pad, 128, 256)
    return n, pos.to(dtype), tiles, tcounts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [1.0, -0.3])
@pytest.mark.parametrize("rel", [-1e-7, 1e-7, 1e-5, 1e-3])
def test_point_boxes_at_the_cutoff_edge(dtype, offset, rel):
    """Two granules each at one point, rc (1 + rel) apart: the boxes are
    points, so the test's margins alone decide. A run is never skipped
    while its pairs' float r^2 lies inside rc^2 (rel = -1e-7, and +1e-7,
    which float32 may round inside), and is skipped once the gap clears
    the margins (rel = 1e-3)."""
    rc, L = 2.5, 12.0
    n, pos, tiles, tcounts = _two_points(L, rc * (1 + rel), dtype, offset)
    tested, skipped = _check_skipped_pairs(pos, n, tiles, tcounts, L, rc * rc, 256, 16)
    t = fused_list.list_skip_runs(pos, tiles, tcounts, n, L, rc * rc, 256, 16)
    cross = int((t["col0"] // 128 != t["gran"]).sum()) * 64 * 8  # runs of the other granule
    assert tested == t["col0"].numel() * 64 * 8 and cross > 0
    if rel >= 1e-3:
        assert skipped == cross
    if rel < 0:
        assert skipped == 0


def test_a_nan_never_skips(config3):
    """A NaN in a warp's particle or in a run's slots makes every test of
    that warp or run keep its run."""
    cfg, carry, tile_j = config3
    pos = carry.r.clone()
    base = fused_list.list_skip_runs(pos, carry.tiles, carry.tcounts, cfg.n, cfg.box_length,
                                     cfg.rc_square, tile_j, 16)
    slot = 1000
    pos[2, int(base["perm"][slot])] = float("nan")
    t = fused_list.list_skip_runs(pos, carry.tiles, carry.tcounts, cfg.n, cfg.box_length,
                                  cfg.rc_square, tile_j, 16)
    assert torch.equal(t["perm"], base["perm"])
    mine = (t["slots"] == slot).any(-1)                     # (E, warps): the NaN's warp
    holds = (t["cols"] == slot).any(-1)                     # (E, warps, nk): runs holding it
    assert not bool(t["skip"][mine].any())
    assert not bool(t["skip"][holds].any())
    assert bool(base["skip"][holds].any())                  # they were skipped before
    others = ~mine[..., None] & ~holds
    assert torch.equal(t["skip"][others], base["skip"][others])


def test_skip_counts_of_a_stack_are_each_replicas(config3):
    cfg, carry, tile_j = config3
    stack = torch.stack([carry.r, carry.r])
    tiles = torch.stack([carry.tiles, carry.tiles])
    tcounts = torch.stack([carry.tcounts, carry.tcounts])
    got = fused_list.list_skip_counts(stack, tiles, tcounts, cfg.n, cfg.box_length,
                                      cfg.rc_square, tile_j, 16)
    one = fused_list.list_skip_counts(carry.r, carry.tiles, carry.tcounts, cfg.n,
                                      cfg.box_length, cfg.rc_square, tile_j, 16)
    assert got.shape == (2, 2) and torch.equal(got[0], one) and torch.equal(got[1], one)


def test_engine_reports_the_skip_share_on_the_cpu_as_not_measured(config3):
    """The zsort engine's counters hold ``list_skip_share`` beside the
    travel share; the CPU twin tests no run, so it reads NaN there."""
    cfg, carry, _ = config3
    eng = pe.make_engine(cfg.replace(num_cells=5, box_length=8.55, rc_over_box=2.5 / 8.55),
                         "zsort", "cpu")
    c = eng.init(MDState(*(fcc_lattice(5, 8.55, dtype=torch.float32),) * 2,
                         torch.zeros((500, 3)), torch.zeros((500, 3))))[0]
    c = eng.run_fast(c, 16)
    share = eng.counters(c)["list_skip_share"]
    assert share.shape == () and bool(torch.isnan(share))


@pytest.mark.parametrize("replicas", [None, 2], ids=["one", "stack"])
def test_engine_init_gives_each_carry_its_own_skip_counts(replicas):
    """The skip counts ride in the carry (int64, a replica's each), zero at
    ``init``; a second ``init`` of one engine makes counts of its own, so it
    can neither reset nor add to the first carry's."""
    cfg = SimConfig(**dict(CONFIG3, num_cells=5, box_length=8.55, rc_over_box=2.5 / 8.55))
    r = fcc_lattice(5, 8.55, dtype=torch.float32)
    state = MDState(r, r, torch.zeros((500, 3)), torch.zeros((500, 3)))
    if replicas:
        state = MDState(*(torch.stack([getattr(state, f)] * replicas)
                          for f in ("r", "ru", "v", "a")))
        eng = pe.make_replica_engine(cfg, replicas, "zsort", "cpu", states=state)
    else:
        eng = pe.make_engine(cfg, "zsort", "cpu", state=state)
    a, b = eng.init(state)[0], eng.init(state)[0]
    batch = (replicas,) if replicas else ()
    assert a.skips.shape == batch + (2,) and a.skips.dtype == torch.int64
    assert not bool(a.skips.any())
    assert a.skips.data_ptr() != b.skips.data_ptr()
    a.skips.add_(5)
    assert not bool(b.skips.any())
    assert eng.run_fast(a, 16).skips.data_ptr() == a.skips.data_ptr()  # added to in place
