"""The port's z-sorted window-list engine (``ljmd_tpu_torch/models/engine.py``
``_zsort_engine``) and its routing, against the JAX package's zsort engine,
float64 on the CPU.

Both packages start from one numpy state or one ``ZSortCarry``
(``ljmd_tpu_torch.utils.convert``); the JAX engine runs its Pallas kernels in
interpret mode with ``inner_chunk=8``, as tests/test_fused.py runs it.
Tolerances are that file's: observables at init rel 1e-12 (the same sweep),
engine states and fused observables rtol 1e-10 (summation order only), the
production series rtol 1e-8.
"""

import dataclasses
import math
import os

import jax
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _zsort_engine as j_zsort_engine
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu.models.simulation import run_production as j_run_production
from ljmd_tpu_torch.config import SimConfig, load_config
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.models.simulation import run_production
from ljmd_tpu_torch.state import MDState
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
OBS = ("epot", "ekin", "d_epot", "dd_epot")
FIELDS = ("r", "ru", "v", "a")


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _np_state(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _close_states(got, want, rtol=1e-10, atol=1e-10):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


def _close_obs(got, want, rel):
    for k in OBS:
        assert float(getattr(got, k)) == pytest.approx(float(getattr(want, k)), rel=rel), k


def _same_lists(pc, jc):
    """Equal counts, and equal entries on each list's count prefix."""
    counts = np.asarray(jc.tcounts)
    np.testing.assert_array_equal(pc.tcounts.numpy(), counts)
    tiles, jt = pc.tiles.numpy(), np.asarray(jc.tiles)
    for c, k in enumerate(counts):
        rows = [2 * c, 2 * c + 1] + ([8] if c == 3 else []) if c < 4 else \
            [9 + 2 * (c - 4), 10 + 2 * (c - 4)]
        np.testing.assert_array_equal(tiles[rows, :k], jt[rows, :k])


CASES = {
    # tests/test_fused.py: N=500, rho 0.8, pure z, tile_j 512 with tails
    "pure_z": (dict(num_cells=5, density=0.8, dt=0.004, warmup_steps=30,
                    target_total_energy=-2300.0), {}),
    # tests/test_fused.py's slab geometry: rc 1.3, 5 x-slabs, tile_j 128
    "slab": (dict(num_cells=6, density=0.8, rc=1.3, dt=0.004, warmup_steps=50,
                  target_total_energy=-4000.0),
             dict(slab_sort=True, tile_j=128, sort_skin=0.55)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_zsort_engine_matches_jax(case):
    cfg_kw, eng_kw = CASES[case]
    jcfg = config_from_density(dtype="float64", total_steps=10, **cfg_kw)
    jstate = j_initialize(jcfg, backend="dense")
    je = j_zsort_engine(jcfg, interpret=True, inner_chunk=8, **eng_kw)
    peng = pe._zsort_engine(_port_cfg(jcfg), "cpu", inner_chunk=8, **eng_kw)

    # init from one state: same sorted order, lists and observables
    jc, jo = jax.jit(je.init)(jstate)
    pc, po = peng.init(convert.state_from_numpy(_np_state(jstate)))
    _close_obs(po, jo, 1e-12)
    np.testing.assert_array_equal(pc.ids.numpy(), np.asarray(jc.ids))
    _same_lists(pc, jc)
    assert pc.tiles.dtype == torch.int32 and pc.tcounts.dtype == torch.int32

    # run_fast(16) = two chunks of 8, a resort before each, from one carry
    pc = convert.zsort_carry_from_numpy(jax.device_get(jc))
    jc = jax.jit(lambda c: je.run_fast(c, 16))(jc)
    pc = peng.run_fast(pc, 16)
    _close_states(peng.get_state(pc), je.get_state(jc))
    np.testing.assert_array_equal(pc.ids.numpy(), np.asarray(jc.ids))
    _same_lists(pc, jc)
    assert not bool(peng.diagnostics(pc)["zsort_invalid"])
    assert not bool(jax.device_get(jc.invalid))
    if case == "slab":
        return

    # step: the per-step tri sweep
    _, jo = jax.jit(je.step)(jc)
    _, po = peng.step(pc)
    _close_obs(po, jo, 1e-10)

    # run_sample(8) = one resort + one obs_last chunk of 8
    jc2, jo = jax.jit(lambda c: je.run_sample(c, 8))(jc)
    pc2, po = peng.run_sample(pc, 8)
    _close_obs(po, jo, 1e-10)
    _close_states(peng.get_state(pc2), je.get_state(jc2))
    back = convert.zsort_carry_to_numpy(pc2)
    assert set(back) == set(convert.ZSORT_FIELDS)
    np.testing.assert_allclose(back["r"], np.asarray(jc2.r), rtol=1e-10, atol=1e-10)


def test_zsort_production_matches_jax():
    """run_production(backend="zsort") in both packages at
    tests/test_fused.py's production config (sampled with run_sample)."""
    jcfg = config_from_density(num_cells=5, density=0.8, dt=0.003, dtype="float64",
                               total_steps=20, output_interval=5, warmup_steps=10,
                               target_total_energy=-2300.0)
    jstate = j_initialize(jcfg, backend="dense")
    want = j_run_production(jcfg, jstate, backend="zsort")
    got = run_production(_port_cfg(jcfg), convert.state_from_numpy(_np_state(jstate)),
                         backend="zsort")
    np.testing.assert_allclose(got.series.numpy(), np.asarray(want.series), rtol=1e-8,
                               atol=1e-9)
    _close_states(got.final_state, want.final_state, rtol=1e-8, atol=1e-9)
    assert not bool(got.diagnostics["zsort_invalid"])


@pytest.fixture(scope="module")
def port_small():
    """N=500 at rho 0.8 from the JAX package's dense initialization."""
    jcfg = config_from_density(num_cells=5, density=0.8, dt=0.004, dtype="float64",
                               total_steps=10, warmup_steps=30, target_total_energy=-2300.0)
    state = convert.state_from_numpy(_np_state(j_initialize(jcfg, backend="dense")))
    return _port_cfg(jcfg), state


def _closure_value(fn, name):
    """The value a JAX engine function closes over under ``name``, searched
    through the closures of the functions it closes over."""
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if id(f) in seen or not hasattr(f, "__code__"):
            continue
        seen.add(id(f))
        for var, cell in zip(f.__code__.co_freevars, f.__closure__ or ()):
            value = cell.cell_contents
            if var == name:
                return value
            if callable(value):
                todo.append(value)
    raise KeyError(name)


@pytest.mark.parametrize("chunk", [8, 16, 17, 24])
def test_zsort_geometry_matches_jax_closure(chunk):
    """At inner chunk 8 and at the chunks a sample interval sets
    (``_zsort_kwargs``: 17..24; 16 the default) the skin (the one-chunk
    travel bound, max(0.3, 8.5 x chunk x dt)), the flag window and the
    invalid bound equal the values the JAX engine closes over (N=500 at
    rho* 0.8, dt 0.004); at dt 0.02 and chunk 64 the box cannot hold the
    one-chunk travel skin, and both packages refuse it."""
    jcfg = config_from_density(num_cells=5, density=0.8, dt=0.004, dtype="float64",
                               total_steps=10, warmup_steps=30, target_total_energy=-2300.0)
    je = j_zsort_engine(jcfg, interpret=True, inner_chunk=chunk)
    geo = pe.zsort_geometry(_port_cfg(jcfg), chunk)
    for name in ("sort_skin", "window", "invalid_thresh"):
        assert getattr(geo, name) == _closure_value(je.run_fast, name), name
    assert geo.sort_skin == max(0.3, 8.5 * chunk * 0.004)
    hot = jcfg.replace(dt=0.02)
    with pytest.raises(ValueError, match="box too small"):
        j_zsort_engine(hot, interpret=True, inner_chunk=64)
    with pytest.raises(ValueError, match="box too small for the one-chunk travel skin"):
        pe.zsort_geometry(_port_cfg(hot), 64)


@pytest.mark.parametrize("chunk", [16, 24])
def test_zsort_travel_skin_clamped_by_the_box(chunk):
    """At T = 3.0 (the LAMMPS hot start's temperature; N=500 at rho* 0.8442,
    rc 2.5, dt 0.005) the travel skin ``zsort_travel_skin`` passes what the
    box holds: the skin is the box clamp, (0.49 L - rc) / 1.2, the window
    0.49 L, and an engine ``make_engine`` builds from a state at that
    temperature runs with that invalid bound (its travel counter is the
    carry's travel over 0.6 x the clamp) and its flag clear."""
    cfg = SimConfig(num_cells=5, box_length=(500 / 0.8442) ** (1 / 3),
                    rc_over_box=2.5 / (500 / 0.8442) ** (1 / 3), dt=0.005, dtype="float64",
                    total_steps=10, warmup_steps=0)
    L, temp = cfg.box_length, 3.0
    clamp = (0.49 * L - cfg.rc) / 1.2
    assert pe.zsort_travel_skin(temp, chunk, cfg.dt) > clamp > 8.5 * chunk * cfg.dt
    geo = pe.zsort_geometry(cfg, chunk, temperature=temp)
    assert geo.sort_skin == clamp and geo.window == pytest.approx(0.49 * L, rel=1e-14)
    assert geo.invalid_thresh == (0.6 * clamp) ** 2
    lattice = fcc_lattice(cfg.num_cells, L, dtype=torch.float64)
    v = torch.randn(lattice.shape, generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64)
    v = v - v.mean(dim=0)
    v = v * math.sqrt(3.0 * cfg.n * temp / float(torch.sum(v * v)))
    state = MDState(r=lattice, ru=lattice, v=v, a=torch.zeros_like(lattice))
    assert pe.kinetic_temperature(state) == pytest.approx(temp, rel=1e-12)
    eng = pe.make_engine(cfg, "zsort", "cpu", state=state,
                         sample_interval=chunk if chunk > 16 else None)
    c = eng.run_fast(eng.init(state)[0], 2 * chunk)
    c = eng.run_fast(c, chunk)
    share = eng.counters(c)["zsort_travel_share"]
    assert 0.0 < float(share) < 1.0
    assert float(share) * 0.6 * clamp == pytest.approx(math.sqrt(float(c.travel2)), rel=1e-12)
    assert not bool(eng.diagnostics(c)["zsort_invalid"])


def test_zsort_extended_engine_tracks_compensated_rows(port_small):
    """float64 with extended=True: the two-float list chunk and the
    compensated rows engine land on one trajectory."""
    cfg, state = port_small
    ez = pe._zsort_engine(cfg, "cpu", inner_chunk=8, extended=True)
    er = pe._rows_engine(cfg, torch.device("cpu"), compensated=True)
    cz = ez.run_fast(ez.init(state)[0], 12)
    cr = er.init(state)[0]
    for _ in range(12):
        cr, _ = er.step_fast(cr)
    got, want = ez.get_state(cz), er.get_state(cr)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), getattr(want, k).numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=k)


def test_zsort_geometry_matches_jax_constants():
    """n_pad, tile_j, slab mode and the ValueErrors of the JAX engine."""
    n4000 = load_config(os.path.join(EXAMPLES, "n4000_production.json"))
    n864 = load_config(os.path.join(EXAMPLES, "n864_liquid.json"))
    g = pe.zsort_geometry(n4000)
    assert (g.n_pad, g.tile_j, g.slab_sort, g.fused_viable) == (4096, 512, False, True)
    assert g.window == pytest.approx(n4000.rc + 1.2 * 0.68)
    assert pe.zsort_geometry(n864).n_pad == 896
    assert pe.zsort_geometry(n864, inner_chunk=25).n_pad == 896
    big = SimConfig(num_cells=20, box_length=34.2, rc_over_box=2.5 / 34.2)
    g = pe.zsort_geometry(big)
    assert g.slab_sort and g.tile_j == 768 and g.n_pad == 32000
    tiny = SimConfig(num_cells=2, box_length=4.0, rc_over_box=0.45)
    with pytest.raises(ValueError, match="box too small"):
        pe.make_engine(tiny, "zsort", device="cpu")
    travel = n864.replace(dt=0.02)
    with pytest.raises(ValueError, match="travel|skin"):
        pe.zsort_geometry(travel, inner_chunk=64)


def test_auto_routing_follows_the_jax_accelerator_branch():
    """On a CUDA device "auto" follows JAX's accelerator routing (zsort,
    cellpair past the window-list cliff, else rows); on the CPU it stays
    rows."""
    def cfg(name):
        return load_config(os.path.join(EXAMPLES, name))

    n4000, n864, ref = cfg("n4000_production.json"), cfg("n864_liquid.json"), \
        cfg("reference_default.json")
    assert pe.auto_backend(n4000, True, n4000.output_interval) == "zsort"
    assert pe.auto_backend(n864, True, n864.output_interval) == "zsort"
    assert pe.auto_backend(ref, True, ref.output_interval) == "rows"  # L < 4 rc
    for c in (n4000, n864, ref):
        assert pe.auto_backend(c, False) == "rows"
    # past the window-list cliff ((n_pad/128)^2 > 32768) JAX takes cellpair
    big = SimConfig(num_cells=19, box_length=32.0, rc_over_box=2.5 / 32.0)
    assert big.n > 23170 and pe.auto_backend(big, True) == "cellpair"
    # an interval in 17..24 becomes the inner chunk
    assert pe._zsort_kwargs(20) == {"inner_chunk": 20}
    assert pe._zsort_kwargs(50) == {} and pe._zsort_kwargs(None) == {}
    # make_engine on the CPU: auto is the rows engine
    assert pe.make_engine(n864, "auto", "cpu").run_sample is None
    assert pe.make_engine(n864, "zsort", "cpu", sample_interval=20).run_sample is not None


def test_zsort_carry_conversion_round_trip(port_small):
    cfg, state = port_small
    eng = pe._zsort_engine(cfg, "cpu", inner_chunk=8)
    c, _ = eng.init(state)
    arrays = convert.zsort_carry_to_numpy(c)
    back = convert.zsort_carry_from_numpy(arrays)
    for k in convert.ZSORT_FIELDS:
        assert torch.equal(getattr(back, k), getattr(c, k)), k
    assert back.ids.dtype == torch.int32 and back.invalid.dtype == torch.bool
    with pytest.raises(ValueError, match="rows"):
        convert.zsort_carry_from_numpy({**arrays, "r": arrays["r"][0:3]})
