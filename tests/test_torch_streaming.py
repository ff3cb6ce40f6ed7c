"""The port's streaming driver (``models/streaming.py``), its checkpoints
(``io/checkpoint.py``) and trajectory writers (``io/trajectory.py``,
``utils/native.py``), and ``utils/debug.py`` / ``utils/profiling.py``:

- streaming equals the in-memory ``run_production`` bit for bit (series,
  final state, rva.dat) on every engine, and through a sharded engine;
- a crash after chunk 2 resumes bit for bit (rows, cellpair, the sharded
  engine); against JAX's ``run_production`` at test_torch_simulation's
  tolerance;
- the checkpoint is atomic, a carry of another dtype or package is not
  restored verbatim, a JAX checkpoint's state / means / series are read;
- the native writer equals the Python writer byte for byte, and a native
  failure raises from ``sync``;
- validate_state, nan_guard, Throughput, time_fn and trace as JAX's.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density as j_config_from_density
from ljmd_tpu.io import checkpoint as jckpt
from ljmd_tpu.models import simulation as jsim
from ljmd_tpu.models import streaming as jstream
from ljmd_tpu.utils import debug as jdebug
from ljmd_tpu.utils import profiling as jprof
from ljmd_tpu_torch.config import SimConfig, config_from_density
from ljmd_tpu_torch.io import checkpoint as pckpt
from ljmd_tpu_torch.io.fortran_records import write_rva
from ljmd_tpu_torch.io.trajectory import AsyncTrajectoryWriter, TrajectoryWriter
from ljmd_tpu_torch.models import streaming as S
from ljmd_tpu_torch.models.engine import make_engine
from ljmd_tpu_torch.models.simulation import initialize, run_production
from ljmd_tpu_torch.parallel.mesh import make_mesh
from ljmd_tpu_torch.parallel.spatial import make_spatial_engine
from ljmd_tpu_torch.utils import convert, debug, native, profiling

torch.set_num_threads(1)

FIELDS = ("r", "ru", "v", "a")

# N=108 with warmup % interval != 0 (a prologue and an epilogue), for the
# rows and dense engines; N=500 at the zsort and cell-pair tests' state
# points (tests/test_torch_zsort.py, tests/test_torch_cellpair.py), the
# first also for the neighbor engine (whose rc + skin must stay under L/2).
CFGS = {
    "small": dict(num_cells=3, density=0.7, dt=0.003, total_steps=75, output_interval=5,
                  warmup_steps=13, target_total_energy=-500.0, corr_max_lag_cap=3,
                  corr_max_blocks=2),
    "zsort": dict(num_cells=5, density=0.8, dt=0.003, total_steps=40, output_interval=5,
                  warmup_steps=10, target_total_energy=-2300.0),
    "cellpair": dict(num_cells=5, density=0.66, dt=0.002, neighbor_skin=0.3, total_steps=35,
                     output_interval=5, warmup_steps=5, target_total_energy=-2000.0),
}
ENGINE_CFG = {"rows": "small", "dense": "small", "neighbor": "zsort", "zsort": "zsort",
              "cellpair": "cellpair"}


def _cfg(name: str, dtype: str = "float64") -> SimConfig:
    return config_from_density(dtype=dtype, **CFGS[name])


_STATES = {}


def _state(name: str, dtype: str = "float64"):
    """The port's CPU initialization (rows), cached per config and dtype."""
    if (name, dtype) not in _STATES:
        _STATES[name, dtype] = initialize(_cfg(name, dtype), backend="rows", device="cpu")
    return _STATES[name, dtype]


def _equal_states(got, want):
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _crash_after(monkeypatch, n: int):
    """Make the driver raise right after its n-th checkpoint."""
    orig = S._save
    calls = {"n": 0}

    def save(*args, **kw):
        out = orig(*args, **kw)
        calls["n"] += 1
        if calls["n"] == n:
            raise KeyboardInterrupt
        return out

    monkeypatch.setattr(S, "_save", save)
    return lambda: monkeypatch.setattr(S, "_save", orig)


@pytest.mark.parametrize("backend,dtype", [
    ("rows", "float64"), ("rows", "float32"), ("zsort", "float64"), ("zsort", "float32"),
    ("cellpair", "float64"), ("cellpair", "float32"), ("neighbor", "float64"),
    ("dense", "float64")])
def test_streaming_equals_in_memory(tmp_path, backend, dtype):
    """Series, means, correlations, final state and diagnostics bit for
    bit, rva.dat byte for byte against write_rva of the in-memory frames,
    the native writer used, the checkpoint gone."""
    cfg, state = _cfg(ENGINE_CFG[backend], dtype), _state(ENGINE_CFG[backend], dtype)
    want = run_production(cfg, state, backend=backend, record_frames=True, device="cpu")
    stats = {}
    got = S.run_production_streaming(cfg, state, str(tmp_path / "s"), backend=backend,
                                     chunk_samples=3, device="cpu", stats=stats)
    for k in ("series", "times", "corr", "corr_norm", "corr_mean", "corr_mean_norm"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(got.means.means, want.means.means)
    assert torch.equal(got.means.stds, want.means.stds)
    _equal_states(got.final_state, want.final_state)
    assert {k: bool(v) for k, v in got.diagnostics.items()} == \
        {k: bool(v) for k, v in want.diagnostics.items()}
    assert not any(bool(v) for v in got.diagnostics.values())
    write_rva(str(tmp_path / "want.dat"), cfg.box_length, cfg.dt, cfg.output_interval,
              *(getattr(want.frames, k).numpy().astype(np.float64) for k in FIELDS))
    assert (tmp_path / "s" / "rva.dat").read_bytes() == (tmp_path / "want.dat").read_bytes()
    assert not os.path.exists(S._checkpoint_path(str(tmp_path / "s")))
    n_samples = cfg.n_samples
    assert stats["writer"] == "native" and stats["frames_written"] == n_samples
    assert stats["chunks"] == -(-n_samples // 3) and stats["checkpoint_bytes"] > 0


@pytest.mark.parametrize("backend", ["rows", "cellpair"])
def test_crash_and_resume_is_bit_exact(tmp_path, monkeypatch, backend):
    """A run that dies after its second checkpoint, rerun in the same
    directory, equals the uninterrupted run bit for bit (carry restored
    verbatim), rva.dat included."""
    cfg, state = _cfg(ENGINE_CFG[backend]), _state(ENGINE_CFG[backend])
    full = S.run_production_streaming(cfg, state, str(tmp_path / "full"), backend=backend,
                                      chunk_samples=2, device="cpu")
    part = str(tmp_path / "part")
    restore = _crash_after(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        S.run_production_streaming(cfg, state, part, backend=backend, chunk_samples=2,
                                   device="cpu")
    restore()
    ck = pckpt.load_checkpoint(S._checkpoint_path(part))
    assert ck.sample_idx == 4 and ck.series.shape == (5, 4) and ck.carry is not None
    stats = {}
    got = S.run_production_streaming(cfg, state, part, backend=backend, chunk_samples=2,
                                     device="cpu", stats=stats)
    assert stats["resumed_from"] == 4 and stats["carry"] == "verbatim"
    assert torch.equal(got.series, full.series)
    assert torch.equal(got.means.means, full.means.means)
    _equal_states(got.final_state, full.final_state)
    assert (tmp_path / "part" / "rva.dat").read_bytes() == \
        (tmp_path / "full" / "rva.dat").read_bytes()


def test_resume_truncates_a_torn_trajectory(tmp_path, monkeypatch):
    """Bytes past the checkpoint's frames (a kill mid-write) are dropped on
    resume; a file shorter than the checkpoint claims is refused."""
    cfg, state = _cfg("small"), _state("small")
    full = S.run_production_streaming(cfg, state, str(tmp_path / "full"), chunk_samples=4,
                                      backend="rows", device="cpu")
    part = tmp_path / "part"
    restore = _crash_after(monkeypatch, 1)
    with pytest.raises(KeyboardInterrupt):
        S.run_production_streaming(cfg, state, str(part), backend="rows", chunk_samples=4,
                                   device="cpu")
    restore()
    good = (part / "rva.dat").read_bytes()
    (part / "rva.dat").write_bytes(good + b"\x07" * 1001)
    got = S.run_production_streaming(cfg, state, str(part), backend="rows", chunk_samples=4,
                                     device="cpu")
    assert torch.equal(got.series, full.series)
    assert (part / "rva.dat").read_bytes() == (tmp_path / "full" / "rva.dat").read_bytes()

    restore = _crash_after(monkeypatch, 1)
    with pytest.raises(KeyboardInterrupt):
        S.run_production_streaming(cfg, state, str(part), backend="rows", chunk_samples=4,
                                   device="cpu")
    restore()
    (part / "rva.dat").write_bytes(good[:-10])
    with pytest.raises(ValueError, match="cannot be resumed"):
        S.run_production_streaming(cfg, state, str(part), backend="rows", chunk_samples=4,
                                   device="cpu")


def test_sharded_engine_streams_and_resumes(tmp_path, monkeypatch):
    """A passed engine (the particle-sharded one on a 2-rank thread mesh):
    streaming equals run_production through it, and resumes verbatim."""
    cfg, state = _cfg("small"), _state("small")
    mesh = make_mesh(particle=2, device="cpu")
    try:
        eng = make_spatial_engine(cfg, mesh, comm="ring")
        want = run_production(cfg, state, engine=eng, device="cpu")
        restore = _crash_after(monkeypatch, 2)
        with pytest.raises(KeyboardInterrupt):
            S.run_production_streaming(cfg, state, str(tmp_path), engine=eng, chunk_samples=2,
                                       device="cpu")
        restore()
        stats = {}
        got = S.run_production_streaming(cfg, state, str(tmp_path), engine=eng,
                                         chunk_samples=2, device="cpu", stats=stats)
    finally:
        mesh.close()
    assert stats["carry"] == "verbatim"
    assert torch.equal(got.series, want.series)
    _equal_states(got.final_state, want.final_state)


def test_streaming_matches_jax(tmp_path):
    """The port's streaming series against the JAX package's run_production
    from the same state (test_torch_simulation's tolerances)."""
    jcfg = j_config_from_density(dtype="float64", **CFGS["small"])
    jstate = jsim.initialize(jcfg, backend="dense")
    want = jsim.run_production(jcfg, jstate, backend="dense")
    pstate = convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS})
    got = S.run_production_streaming(_cfg("small"), pstate, str(tmp_path), backend="rows",
                                     chunk_samples=4, device="cpu")
    np.testing.assert_allclose(got.series.numpy(), np.asarray(want.series), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got.means.means.numpy(), np.asarray(want.means.means),
                               rtol=1e-9, atol=1e-12)


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A write that dies midway leaves the previous checkpoint whole and no
    temporary file behind."""
    cfg, state = _cfg("small"), _state("small")
    eng = make_engine(cfg, "rows", "cpu")
    carry, _ = eng.init(state)
    path = str(tmp_path / S.CHECKPOINT_NAME)
    pckpt.save_checkpoint(path, state, step=5, series=np.ones((5, 2)), sample_idx=2,
                          carry=carry)
    before = open(path, "rb").read()

    def torn(f, **arrays):
        f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")

    monkeypatch.setattr(pckpt.np, "savez", torn)
    with pytest.raises(OSError, match="disk full"):
        pckpt.save_checkpoint(path, state, step=9, series=np.zeros((5, 3)), sample_idx=3)
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == [S.CHECKPOINT_NAME]
    ck = pckpt.load_checkpoint(path)
    assert ck.sample_idx == 2 and ck.step == 5 and ck.carry.cls == "RowCarry"
    _equal_states(ck.state, state)


def test_carry_of_another_dtype_takes_the_state(tmp_path, monkeypatch, capfd):
    """A float64 run's checkpoint resumed under float32: the carry is not
    cast into the engine but rebuilt from the checkpoint's state, and the
    driver says so."""
    cfg, state = _cfg("small"), _state("small")
    restore = _crash_after(monkeypatch, 2)
    with pytest.raises(KeyboardInterrupt):
        S.run_production_streaming(cfg, state, str(tmp_path), backend="rows", chunk_samples=2,
                                   device="cpu")
    restore()
    ck = pckpt.load_checkpoint(S._checkpoint_path(str(tmp_path)))
    assert all(a.dtype != np.float32 for a in ck.carry.arrays)
    stats = {}
    cfg32 = cfg.replace(dtype="float32")
    got = S.run_production_streaming(cfg32, state.to(dtype=torch.float32), str(tmp_path),
                                     backend="rows", chunk_samples=2, device="cpu",
                                     stats=stats)
    assert stats["carry"] == "state" and "not bit-exact" in capfd.readouterr().err
    assert got.series.dtype == torch.float32 and got.series.shape == (5, cfg.n_samples)
    assert torch.isfinite(got.series).all()


def test_carry_structure_mismatch_and_unflattenable_carry():
    cfg, state = _cfg("small"), _state("small")
    rows = make_engine(cfg, "rows", "cpu")
    carry, _ = rows.init(state)
    structure, leaves = pckpt.flatten_carry(carry)
    assert structure.startswith("RowCarry(r=T,") and [p for p, _ in leaves][:2] == ["r.", "ru."]
    saved = pckpt.CarryArrays("RowCarry", structure, [p for p, _ in leaves],
                              [t.numpy() for _, t in leaves])
    other = make_engine(cfg, "dense", "cpu")
    _, how = S._restore_carry(other, state, saved)
    assert how == "state"
    got, how = S._restore_carry(rows, state, saved)
    assert how == "verbatim" and all(torch.equal(getattr(got, k), getattr(carry, k))
                                     for k in ("r", "v", "a"))
    with pytest.raises(TypeError, match="cannot flatten"):
        pckpt.flatten_carry((carry, 3))


def test_checkpoints_cross_packages(tmp_path, monkeypatch):
    """A JAX streaming checkpoint: the port reads its state, means and
    series, ignores its carry leaves and resumes from the state; the JAX
    loader reads the port's state, means and series and no carry."""
    jcfg = j_config_from_density(dtype="float64", **CFGS["small"])
    jstate = jsim.initialize(jcfg, backend="dense")
    jdir = str(tmp_path / "jax")
    want = jstream.run_production_streaming(jcfg, jstate, str(tmp_path / "jfull"),
                                            backend="dense", chunk_samples=2)
    orig = jstream._save
    calls = {"n": 0}

    def crash(*a, **kw):
        orig(*a, **kw)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt

    monkeypatch.setattr(jstream, "_save", crash)
    with pytest.raises(KeyboardInterrupt):
        jstream.run_production_streaming(jcfg, jstate, jdir, backend="dense", chunk_samples=2)
    monkeypatch.undo()
    jck = jckpt.load_checkpoint(jstream._checkpoint_path(jdir))
    ck = pckpt.load_checkpoint(S._checkpoint_path(jdir))
    assert ck.carry is None and jck.carry_leaves is not None
    assert ck.sample_idx == jck.sample_idx == 4
    np.testing.assert_array_equal(ck.series, jck.series)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ck.state, k).numpy(),
                                      np.asarray(getattr(jck.state, k)))
    np.testing.assert_array_equal(ck.means.moments.numpy(), np.asarray(jck.means.moments))
    np.testing.assert_array_equal(ck.means.shift.numpy(), np.asarray(jck.means.shift))
    assert float(ck.means.count) == float(jck.means.count)

    pstate = convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS})
    stats = {}
    got = S.run_production_streaming(_cfg("small"), pstate, jdir, backend="rows",
                                     chunk_samples=2, device="cpu", stats=stats)
    assert stats["resumed_from"] == 4 and stats["carry"] == "state"
    np.testing.assert_array_equal(got.series[:, :4].numpy(), np.asarray(want.series)[:, :4])
    np.testing.assert_allclose(got.series.numpy(), np.asarray(want.series), rtol=1e-9,
                               atol=1e-11)

    cfg, state = _cfg("small"), _state("small")
    carry, _ = make_engine(cfg, "rows", "cpu").init(state)
    acc = S.means_init(dtype=torch.float64)
    path = str(tmp_path / "port.npz")
    pckpt.save_checkpoint(path, state, step=7, means=acc, series=np.ones((5, 3)),
                          sample_idx=3, carry=carry)
    jback = jckpt.load_checkpoint(path)
    assert jback.carry_leaves is None and jback.sample_idx == 3 and jback.step == 7
    np.testing.assert_array_equal(np.asarray(jback.state.v), state.v.numpy())
    np.testing.assert_array_equal(jback.series, np.ones((5, 3)))


def _frames(n_frames=5, n=7, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n_frames, n, 3)) for _ in FIELDS]


def test_async_writer_equals_python_writer(tmp_path):
    """The native writer's file equals the Python writer's and write_rva's
    byte for byte, written in blocks and single frames, and reopened for
    append."""
    frames = _frames()
    args = (7, 4.5, 0.005, 10)
    paths = {}
    for name, cls in (("native", AsyncTrajectoryWriter), ("python", TrajectoryWriter)):
        p = str(tmp_path / f"{name}.dat")
        w = cls(p, *args, 5)
        w.append(*(f[:2] for f in frames))
        w.sync()
        w.close()
        w = cls.open_for_append(p, *args, 2)
        w.append(*(f[2] for f in frames))
        w.append(*(f[3:] for f in frames))
        assert w.frames_written == 5
        w.close()
        paths[name] = p
    write_rva(str(tmp_path / "whole.dat"), 4.5, 0.005, 10, *frames)
    whole = (tmp_path / "whole.dat").read_bytes()
    assert open(paths["native"], "rb").read() == whole
    assert open(paths["python"], "rb").read() == whole
    native.write_rva_native(str(tmp_path / "bulk.dat"), 4.5, 0.005, 10, *frames)
    assert (tmp_path / "bulk.dat").read_bytes() == whole
    got = native.read_rva_native(paths["native"])
    np.testing.assert_array_equal(got.ru, frames[1])
    assert (got.n, got.n_snapshots, got.output_interval) == (7, 5, 10)


def test_native_ran3_matches_python():
    from ljmd_tpu_torch.utils.ran3 import Ran3

    for seed in (-12345, 0, 7):
        np.testing.assert_array_equal(native.ran3_fill(seed, 300), Ran3(seed).uniform(300))


def test_native_sync_failure_raises(tmp_path, monkeypatch):
    """A failed drain / fsync on the native side raises from sync(): it is
    never swallowed."""
    w = AsyncTrajectoryWriter(str(tmp_path / "rva.dat"), 7, 4.5, 0.005, 10, 5)
    assert w.native
    w.append(*(f[:1] for f in _frames()))
    lib = native.load()
    monkeypatch.setattr(lib, "ljmd_rva_async_sync", lambda handle: -5)
    with pytest.raises(RuntimeError, match="ljmd_rva_async_sync failed: -5"):
        w.sync()
    monkeypatch.undo()
    w.sync()
    w.close()


def test_python_fallback_says_so(tmp_path, monkeypatch, capfd):
    monkeypatch.setattr(native, "async_writer_open", lambda *a, **k: None)
    w = AsyncTrajectoryWriter(str(tmp_path / "rva.dat"), 7, 4.5, 0.005, 10, 5)
    assert not w.native
    w.append(*(f[:1] for f in _frames()))
    w.close()
    err = capfd.readouterr().err
    assert err.count("\n") == 1 and "Python writer" in err


def test_validate_state_as_jax():
    cfg, state = _cfg("small"), _state("small")
    jstate = convert.state_to_numpy(state)
    from ljmd_tpu.state import MDState as JState

    js = JState(**{k: jnp.asarray(v) for k, v in jstate.items()})
    cases = {
        "healthy": (state, js),
        "nan": (dataclasses.replace(state, v=state.v.clone().index_fill_(0, torch.tensor([0]),
                                                                         float("nan"))),
                dataclasses.replace(js, v=js.v.at[0].set(jnp.nan))),
        "unwrapped": (dataclasses.replace(state, r=state.r + cfg.box_length),
                      dataclasses.replace(js, r=js.r + cfg.box_length)),
        "shape": (dataclasses.replace(state, a=state.a[:, :2]),
                  dataclasses.replace(js, a=js.a[:, :2])),
        "disagree": (dataclasses.replace(state, a=state.a[:-1]),
                     dataclasses.replace(js, a=js.a[:-1])),
    }
    for name, (p, j) in cases.items():
        outcome = []
        for fn, s in ((debug.validate_state, p), (jdebug.validate_state, j)):
            try:
                fn(s, cfg.box_length)
                outcome.append(None)
            except (ValueError, FloatingPointError) as e:
                outcome.append(type(e))
        assert outcome[0] == outcome[1], (name, outcome)
        assert (outcome[0] is None) == (name == "healthy"), name


def test_nan_guard_flags_divergence():
    """The guard leaves the trajectory alone and keeps its flag down on a
    healthy run; two overlapping particles (r = 0: non-finite forces) set it,
    and it sticks."""
    cfg, state = _cfg("small"), _state("small")
    plain = make_engine(cfg, "dense", "cpu")
    eng = debug.nan_guard(plain)
    carry, _ = eng.init(state)
    ref, _ = plain.init(state)
    for _ in range(2):
        carry, _ = eng.step(carry)
        ref, _ = plain.step(ref)
    assert not bool(eng.diagnostics(carry)["nonfinite_observables"])
    _equal_states(eng.get_state(carry), plain.get_state(ref))
    r = state.r.clone()
    r[1] = r[0]
    carry, _ = eng.init(dataclasses.replace(state, r=r))
    for _ in range(3):
        carry, _ = eng.step(carry)
    assert bool(eng.diagnostics(carry)["nonfinite_observables"])


def test_throughput_time_fn_and_trace(tmp_path):
    for cls in (profiling.Throughput, jprof.Throughput):
        t = cls(n_particles=100)
        t.start()
        t.stop(steps_done=50)
        rep = t.report()
        assert set(rep) == {"steps", "elapsed_s", "steps_per_sec", "particle_steps_per_sec"}
        assert rep["steps"] == 50 and rep["particle_steps_per_sec"] > 0
        with pytest.raises(RuntimeError, match="without start"):
            cls(n_particles=1).stop(1)
    assert profiling.time_fn(lambda x: x * 2, torch.ones(8), iters=2) >= 0
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(16).sum()
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
