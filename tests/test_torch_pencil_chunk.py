"""The fused cell-pair chunk's length (``models/engine.py``
``fused_chunk_steps``), on the CPU.

An engine built for a state (``make_engine(..., state=...)``) sizes its
fused chunk from the state's kinetic temperature T: the most steps, at most
8, in which a particle at the xy speed that ``PENCIL_DRIFT_RISK`` of N
Maxwell particles pass stays inside half the coverage slack. Config 5's
cells keep 8; LAMMPS's in.lj at 256,000 atoms (skin 0.3, half slack 0.2105)
takes fewer, from its lattice and in its fluid; a small hot start with a
slack as tight runs flag-free where the fixed 8 flags.
"""

import math
import os

import pytest
import torch

from ljbench.reference import lj
from ljmd_tpu_torch.config import SimConfig, load_config
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops.cell_list import make_pencil_grid
from ljmd_tpu_torch.state import MDState

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
SPACING = (4.0 / 0.8442) ** (1.0 / 3.0)  # the FCC cell at rho* 0.8442


def _half_slack(cfg) -> float:
    grid = make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin, cfg.density)
    return 0.5 * (grid.pencil_width - cfg.rc)


def _chunk(cfg, temperature) -> int:
    return pe.fused_chunk_steps(cfg.dt, _half_slack(cfg), temperature, cfg.n)


def _maxwell(n, temperature, seed):
    """(n, 3) Maxwell velocities at exactly ``temperature`` (2K / 3N), no
    net momentum."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((n, 3), generator=g, dtype=torch.float64)
    v = v - v.mean(dim=0)
    return v * math.sqrt(temperature * 3 * n / float((v * v).sum()))


@pytest.mark.parametrize("temperature", [0.80, 0.836, 0.85, 0.89])
def test_chunk_rule_keeps_8_on_config5(temperature):
    """Config 5 (N=62,500, skin 0.4: 14 x 14 pencils, half slack 0.2496):
    its cells' post-warmup states read T 0.836 (the benchmark harness's
    mean temperature on an H100); the rule keeps the fixed 8 up to T 0.89
    (a state's T read as ``make_engine`` reads it)."""
    cfg = load_config(os.path.join(EXAMPLES, "n62500_large.json"))
    assert cfg.n == 62_500 and _half_slack(cfg) == pytest.approx(0.24964, abs=1e-5)
    assert _chunk(cfg, temperature) == 8
    state = MDState(r=torch.zeros((cfg.n, 3)), ru=torch.zeros((cfg.n, 3)),
                    v=_maxwell(cfg.n, temperature, 5), a=torch.zeros((cfg.n, 3)))
    assert pe.kinetic_temperature(state) == pytest.approx(temperature, rel=1e-12)
    assert _chunk(cfg, 0.91) < 8


def test_chunk_rule_below_8_on_in_lj_at_256k():
    """LAMMPS's in.lj at x = y = z = 2 (N=256,000, skin 0.3: 23 x 23
    pencils, half slack 0.2105): 5 steps from the lattice at T 1.44 and 7 in
    the fluid it melts into (T 0.7-0.77), where the fixed 8 would let a
    particle at 5.26 leave (~1e-3 of them a chunk at T 0.72)."""
    cfg = load_config(os.path.join(EXAMPLES, "lammps_lj_256k.json"))
    assert cfg.n == 256_000 and _half_slack(cfg) == pytest.approx(0.21052, abs=1e-5)
    u = -6.773368053253789  # the lattice's U an atom (tests/test_lammps_lj_config.py)
    lattice_t = 2.0 * (cfg.target_total_energy - cfg.n * u) / (3.0 * cfg.n)
    assert lattice_t == pytest.approx(1.44, rel=1e-5)
    assert _chunk(cfg, lattice_t) == 5
    for fluid_t in (0.70, 0.72, 0.757, 0.77):
        assert _chunk(cfg, fluid_t) == 7
    crossing = _half_slack(cfg) / (8 * cfg.dt)
    assert cfg.n * math.exp(-crossing ** 2 / (2 * 0.72)) > 1e-3


def test_chunk_rule_edges():
    """At most 8, at least 1; a cold state keeps 8; a state that is not
    finite raises."""
    assert pe.fused_chunk_steps(0.005, 0.25, 0.0, 1000) == 8
    assert pe.fused_chunk_steps(0.005, 0.25, 1e6, 1000) == 1
    assert pe.fused_chunk_steps(0.001, 0.25, 1.0, 1000) == 8
    with pytest.raises(ValueError, match="not finite"):
        pe.fused_chunk_steps(0.005, 0.25, float("nan"), 1000)


# A hot start as tight: k = 7 (N=1,372) at rho* 0.8442, L = 11.757, skin 0.3
# (4 x 4 pencils of 2.939, half slack 0.2196), Maxwell velocities at T 1.44
# on the lattice. On this seed a particle of the fixed 8-step chunks drifts
# 1.12 half slacks between two rebins (of seeds 0-41 only 32 passes 1; the
# others read 0.73-0.98); the rule's chunk is 6.
HOT_K, HOT_SEED, HOT_STEPS = 7, 32, 50


@pytest.fixture(scope="module")
def hot_start():
    L = HOT_K * SPACING
    cfg = SimConfig(num_cells=HOT_K, box_length=L, rc_over_box=2.5 / L, dt=0.005,
                    dtype="float64", neighbor_skin=0.3, use_tail_corrections=False,
                    total_steps=HOT_STEPS, output_interval=HOT_STEPS, warmup_steps=0,
                    target_total_energy=-1000.0)
    r = fcc_lattice(HOT_K, L, dtype=torch.float64)
    v = _maxwell(cfg.n, 1.44 * (cfg.n - 1) / cfg.n, HOT_SEED)
    return cfg, MDState(r=r, ru=r, v=v, a=torch.zeros_like(r))


def _cycle(eng, state):
    """One i50 sample cycle: 49 fused steps, then the sampled step."""
    c, _ = eng.init(state)
    c = eng.run_fast(c, HOT_STEPS - 1)
    return eng.step(c)


def test_hot_start_runs_flag_free_and_matches_the_reference(hot_start):
    """The engine built for the hot state (the cell-pair engine's CPU twins,
    float64) takes 6-step chunks, keeps every drift inside half the slack
    and agrees with ljbench/reference/lj.py (float64, an O(N^2) search into
    a Verlet list of rc + 1): tolerance 1e-9, as both sides differ only in
    summation order (~1e-16 a step), grown by the melt's chaos over 50 steps
    (a factor of a few); a pair missed for a step moves a particle by
    ~F dt^2 / 2 >= 1e-6."""
    cfg, state = hot_start
    assert pe.kinetic_temperature(state) == pytest.approx(1.44, rel=1e-3)
    eng = pe.make_engine(cfg, "cellpair", "cpu", state=state)
    pe.PENCIL_CHUNKS.reset()
    c, obs = _cycle(eng, state)
    assert dict(pe.PENCIL_CHUNKS) == {"chunks": 9, "steps": HOT_STEPS - 1}  # 8 x 6 + 1
    assert not bool(c.overflow)
    share = float(eng.counters(c)["pencil_drift_share"])
    assert 0.5 < share < 1.0
    got = eng.get_state(c)
    r1, v1, a1 = lj.advance(state.r[None], state.v[None], HOT_STEPS, cfg.box_length, cfg.rc,
                            cfg.dt, cfg.volume, tail=False)
    scale = lambda x: max(1.0, float(x.abs().max()))  # noqa: E731
    dr = lj.minimum_image(got.r - r1[0], cfg.box_length).abs().max()
    assert float(dr) <= 1e-9 * cfg.box_length
    assert float((got.v - v1[0]).abs().max()) <= 1e-9 * scale(v1)
    assert float((got.a - a1[0]).abs().max()) <= 1e-9 * scale(a1)
    _, epot, d_epot, _ = lj.forces(got.r[None], lj.pair_list(got.r[None], cfg.box_length,
                                                             cfg.rc),
                                   cfg.box_length, cfg.rc, cfg.volume, tail=False)
    assert float(obs.epot) == pytest.approx(float(epot[0]), rel=1e-9)
    assert float(obs.d_epot) == pytest.approx(float(d_epot[0]), rel=1e-9)


def test_hot_start_flags_with_the_fixed_8(hot_start):
    """The same start through 8-step chunks (JAX's fixed chunk, the engine's
    without a state): a particle outruns half the slack between two rebins
    and the sticky ``pencil_overflow`` is set."""
    cfg, state = hot_start
    cfg = cfg.replace(neighbor_capacity=pe.replica_capacity(cfg, state))
    eng = pe._cellpair_engine(cfg, "cpu")
    c, _ = _cycle(eng, state)
    assert bool(c.overflow)
    assert float(eng.counters(c)["pencil_drift_share"]) > 1.0


def test_initialize_warms_up_on_an_engine_built_for_the_hot_start():
    """``initialize`` with ``warmup_steps`` > 0 builds its warmup engine for
    the rescaled state, as production's is built for its start: the k = 7
    hot start (its lattice rescaled to T 1.44 (N - 1) / N) warms up 50
    steps in the rule's 6-step chunks, flag-free, and hands on that
    engine's run from the rescaled lattice bit for bit."""
    from ljmd_tpu_torch.models.simulation import initialize

    L = HOT_K * SPACING
    n = 4 * HOT_K ** 3
    u = -6.773368053253789  # the lattice's U an atom (tests/test_lammps_lj_config.py)
    cfg = SimConfig(num_cells=HOT_K, box_length=L, rc_over_box=2.5 / L, dt=0.005,
                    dtype="float64", neighbor_skin=0.3, use_tail_corrections=False,
                    total_steps=HOT_STEPS, output_interval=HOT_STEPS, warmup_steps=HOT_STEPS,
                    target_total_energy=n * u + 1.5 * (n - 1) * 1.44, seed=HOT_SEED)
    start = initialize(cfg.replace(warmup_steps=0), backend="cellpair", device="cpu")
    assert pe.kinetic_temperature(start) == pytest.approx(1.44, rel=1e-3)
    pe.PENCIL_CHUNKS.reset()
    got = initialize(cfg, backend="cellpair", device="cpu")
    assert dict(pe.PENCIL_CHUNKS) == {"chunks": 9, "steps": HOT_STEPS}  # 8 x 6 + 2
    eng = pe.make_engine(cfg, "cellpair", "cpu", state=start)
    c = eng.run_fast(eng.init(start)[0], HOT_STEPS)
    assert not bool(c.overflow)
    assert 0.0 < float(eng.counters(c)["pencil_drift_share"]) < 1.0
    want = eng.get_state(c)
    for g, w in ((got.r, want.r), (got.v, want.v), (got.a, want.a)):
        assert torch.equal(g, w)
    assert torch.equal(got.ru, got.r)
