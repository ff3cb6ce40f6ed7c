"""PyTorch port engines (``ljmd_tpu_torch/models/engine.py``) against the
JAX package's engines and the golden fixtures, float64 on the CPU.

Both packages start from one numpy state (``ljmd_tpu_torch.utils.convert``);
the JAX rows engine runs its Pallas kernels in interpret mode. Tolerances
are those of tests/test_engine_pallas.py, tests/test_fused.py,
tests/test_compensated.py and tests/test_golden_parity.py.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _pallas_rows_engine
from ljmd_tpu.models.engine import make_engine as j_make_engine
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice, remove_com_velocity
from ljmd_tpu_torch.ops.fused import MAX_CHUNK_STEPS
from ljmd_tpu_torch.state import MDState
from ljmd_tpu_torch.utils import convert
from ljmd_tpu_torch.utils.ran3 import reference_initial_velocities

# Small tensors: one intra-op thread per test worker (the suite runs in
# several worker processes at once).
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
FIELDS = ("r", "ru", "v", "a")


def _port_cfg(jcfg) -> SimConfig:
    """The port's SimConfig with the same init fields as a JAX config."""
    import dataclasses

    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _jax_state_np(state) -> dict:
    return {k: np.asarray(getattr(state, k)) for k in FIELDS}


def _assert_states_close(got: MDState, want, rtol, atol):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def small():
    """N=108 at rho*=0.7 (the configs of tests/test_fused.py), one state."""
    jcfg = config_from_density(
        num_cells=3, density=0.7, dt=0.003, dtype="float64",
        total_steps=10, warmup_steps=0, target_total_energy=-500.0,
    )
    jstate = j_initialize(jcfg, backend="dense")
    return jcfg, jstate, convert.state_from_numpy(_jax_state_np(jstate))


def test_rows_engine_matches_jax_rows_engine(small):
    jcfg, jstate, pstate = small
    jeng = _pallas_rows_engine(jcfg, interpret=True)
    peng = pe.make_engine(_port_cfg(jcfg), "rows", device="cpu")

    jc, jo = jeng.init(jstate)
    pc, po = peng.init(pstate)
    for k in ("epot", "ekin", "d_epot", "dd_epot"):
        assert float(getattr(po, k)) == pytest.approx(float(getattr(jo, k)), rel=1e-12), k

    jc, jobs = jax.jit(lambda c: jax.lax.scan(lambda c, _: jeng.step(c), c, None, length=20))(jc)
    pobs = []
    for _ in range(20):
        pc, ob = peng.step(pc)
        pobs.append(ob)
    for k in ("epot", "ekin", "d_epot", "dd_epot"):
        np.testing.assert_allclose([float(getattr(o, k)) for o in pobs],
                                   np.asarray(getattr(jobs, k)), rtol=1e-9, err_msg=k)
    _assert_states_close(peng.get_state(pc), jeng.get_state(jc), rtol=1e-9, atol=1e-9)
    # the carry itself, re-padded to the JAX engine's columns
    rows = convert.row_carry_to_numpy(pc, jcfg.n, jc.r.shape[1])
    for k in ("r", "v", "a"):
        np.testing.assert_allclose(rows[k], np.asarray(getattr(jc, k)), rtol=1e-9, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("compensated", [False, True])
def test_rows_run_fast_matches_jax(small, compensated):
    """run_fast (fused chunks, _ext when compensated) against the JAX rows
    engine's run_fast over 25 steps, at tests/test_fused.py's 1e-10."""
    jcfg, jstate, pstate = small
    jeng = _pallas_rows_engine(jcfg, interpret=True, compensated=compensated)
    peng = pe._rows_engine(_port_cfg(jcfg), torch.device("cpu"), compensated=compensated)
    jc = jax.jit(lambda c: jeng.run_fast(c, 25))(jeng.init(jstate)[0])
    pc = peng.run_fast(peng.init(pstate)[0], 25)
    _assert_states_close(peng.get_state(pc), jeng.get_state(jc), rtol=1e-10, atol=1e-10)


def test_rows_run_fast_chunk_split(small):
    """n_steps > MAX_CHUNK_STEPS splits into chunks (256 + 37), wrapping
    between them; another split of the same stretch (150 + 143) lands on
    the same trajectory (tests/test_fused.py's conservation check)."""
    jcfg, _, pstate = small
    peng = pe.make_engine(_port_cfg(jcfg), "rows", device="cpu")
    c0, _ = peng.init(pstate)
    n_steps = MAX_CHUNK_STEPS + 37
    c1 = peng.run_fast(c0, n_steps)
    c2 = peng.run_fast(peng.run_fast(c0, 150), n_steps - 150)
    _, ob1 = peng.step(c1)
    _, ob2 = peng.step(c2)
    e1, e2 = float(ob1.etot), float(ob2.etot)
    assert abs(e1 - e2) / abs(e2) < 1e-9, (e1, e2)
    _assert_states_close(peng.get_state(c1), peng.get_state(c2), rtol=1e-9, atol=1e-9)
    s1 = peng.get_state(c1)
    np.testing.assert_allclose(s1.v.sum(0).numpy(), 0.0, atol=1e-9)
    assert float(s1.r.min()) >= 0.0 and float(s1.r.max()) < jcfg.box_length


def test_dense_engine_matches_jax(small):
    jcfg, jstate, pstate = small
    jeng = j_make_engine(jcfg, "dense")
    peng = pe.make_engine(_port_cfg(jcfg), "dense", device="cpu")
    jc, _ = jeng.init(jstate)
    pc, _ = peng.init(pstate)
    jc = jax.jit(lambda c: jax.lax.scan(lambda c, _: jeng.step(c), c, None, length=10))(jc)[0]
    for _ in range(10):
        pc, ob = peng.step(pc)
    _assert_states_close(pc, jc, rtol=1e-9, atol=1e-9)


def test_compensation_reduces_f32_error():
    """tests/test_compensated.py's check: at dt=1e-4 in float32 the
    compensated rows engine tracks the float64 oracle much more closely
    than the plain one."""
    jcfg64 = config_from_density(num_cells=2, density=0.7, dt=1e-4, total_steps=10,
                                 warmup_steps=0, target_total_energy=-70.0, seed=3,
                                 dtype="float64")
    state64 = convert.state_from_numpy(_jax_state_np(j_initialize(jcfg64, backend="dense")))
    state32 = state64.to(dtype=torch.float32)
    cfg64 = _port_cfg(jcfg64)
    cfg32 = cfg64.replace(dtype="float32")
    cpu = torch.device("cpu")

    def run(eng, state, n_steps=400):
        c, _ = eng.init(state)
        for _ in range(n_steps):
            c, _ = eng.step(c)
        return eng.get_state(c)

    ref_v = run(pe.make_engine(cfg64, "dense", device="cpu"), state64).v.numpy()
    err = {}
    for comp in (False, True):
        s = run(pe._rows_engine(cfg32, cpu, compensated=comp), state32)
        err[comp] = np.abs(s.v.double().numpy() - ref_v).max()
    assert err[True] < err[False] * 0.5, err


def test_dtype_policy_and_compensation_rule():
    """float64 is honoured (no truncation); compensation follows the JAX
    rule (compensated_sum or dt <= 1e-3) and dtype == float32."""
    ref = SimConfig(num_cells=2, box_length=4.0, rc_over_box=0.45, dt=1e-4,
                    dtype="float64", compensated_sum=True, target_total_energy=-60.0)
    assert pe._effective_dtype(ref) == torch.float64
    assert pe.make_engine(ref, "rows", device="cpu").run_fast.__name__ == "run_fast"
    assert pe.make_engine(ref.replace(dtype="float32"), "rows", device="cpu").run_fast.__name__ == "run_fast_ext"
    big_dt = ref.replace(dtype="float32", dt=0.005, compensated_sum=False)
    assert pe.make_engine(big_dt, "rows", device="cpu").run_fast.__name__ == "run_fast"


def test_make_engine_backends():
    cfg = SimConfig(num_cells=2, box_length=4.0, rc_over_box=0.45, target_total_energy=-60.0)
    assert pe.make_engine(cfg, "auto", device="cpu").run_fast is not None  # auto = rows on the CPU
    assert pe.make_engine(cfg, "dense", device="cpu").run_fast is None
    # neighbor is ported: rc + skin must stay below L/2, as in JAX
    with pytest.raises(ValueError, match="below L/2"):
        pe.make_engine(cfg, "neighbor", device="cpu")
    # cellpair is ported: this box holds fewer than 3 pencils, as in JAX
    with pytest.raises(ValueError, match="pencils"):
        pe.make_engine(cfg, "cellpair", device="cpu")
    # zsort is ported: this box (rc ~ L/2) leaves it no room, as in JAX
    with pytest.raises(ValueError, match="box too small"):
        pe.make_engine(cfg, "zsort", device="cpu")
    # pallas is the JAX package's name for the rows engine
    assert (pe.make_engine(cfg, "pallas", device="cpu").run_fast.__name__
            == pe.make_engine(cfg, "rows", device="cpu").run_fast.__name__ == "run_fast_ext")
    with pytest.raises(ValueError, match="unknown backend"):
        pe.make_engine(cfg, "tiles", device="cpu")


@pytest.mark.parametrize("backend,match", [("neighbor", "below L/2"), ("cellpair", "pencils"),
                                           ("zsort", "box too small"),
                                           ("tiles", "unknown backend")])
def test_replica_factory_refuses_what_make_engine_refuses(backend, match):
    """Both factories resolve and route through one builder: on a box that
    holds none of these engines (or a name that is no backend) the ensemble
    factory raises the ValueError ``make_engine`` raises, and
    ``resolve_backend`` refuses only the unknown name."""
    cfg = SimConfig(num_cells=2, box_length=4.0, rc_over_box=0.45, target_total_energy=-60.0)
    for build in (lambda: pe.make_engine(cfg, backend, device="cpu"),
                  lambda: pe.make_replica_engine(cfg, 2, backend, device="cpu")):
        with pytest.raises(ValueError, match=match):
            build()
    if backend == "tiles":
        with pytest.raises(ValueError, match="unknown backend"):
            pe.resolve_backend(cfg, backend, "cpu")
    else:
        assert pe.resolve_backend(cfg, backend, "cpu") == backend


def test_make_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = SimConfig(num_cells=2, box_length=4.0, rc_over_box=0.45, target_total_energy=-60.0)
    with pytest.raises(RuntimeError, match="cuda"):
        pe.make_engine(cfg, "rows", device="cuda")


def test_entry_points_default_to_the_card():
    """make_engine, initialize and simulate run on the card unless asked
    for the CPU: without one, the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ljmd_tpu_torch.models import simulation as psim

    cfg = SimConfig(num_cells=2, box_length=4.0, rc_over_box=0.45, target_total_energy=-60.0)
    for call in (lambda: pe.make_engine(cfg, "rows"), lambda: psim.initialize(cfg),
                 lambda: psim.simulate(cfg)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_row_carry_conversion_repads(small):
    """A JAX rows carry at n_pad=256 (tile_j=256) converts to the port's
    padding and back without changing a value."""
    jcfg, jstate, _ = small
    jeng = _pallas_rows_engine(jcfg, interpret=True, tile_j=256)
    jc, _ = jeng.init(jstate)
    assert jc.r.shape[1] == 256
    pc = convert.row_carry_from_numpy({k: np.asarray(getattr(jc, k)) for k in convert.ROW_FIELDS},
                                      jcfg.n)
    assert pc.r.shape == (8, pe.ROW_PAD)
    back = convert.row_carry_to_numpy(pc, jcfg.n, 256)
    for k in convert.ROW_FIELDS:
        np.testing.assert_array_equal(back[k], np.asarray(getattr(jc, k)), err_msg=k)
    with pytest.raises(ValueError, match="must be zero"):
        bad = {k: np.asarray(getattr(jc, k)).copy() for k in convert.ROW_FIELDS}
        bad["r"][4, 0] = 1.0
        convert.row_carry_from_numpy(bad, jcfg.n)


# ---------------------------------------------------------------- golden
def _golden(k):
    with open(os.path.join(GOLDEN_DIR, f"golden_k{k}.json")) as f:
        return json.load(f)


def _golden_cfg(g) -> SimConfig:
    return SimConfig(num_cells=g["num_cells"], box_length=g["box_length"],
                     rc_over_box=g["rc_over_box"], dt=g["dt"], total_steps=10,
                     output_interval=1, warmup_steps=0,
                     target_total_energy=g["target_total_energy"], dtype="float64")


def _golden_state(cfg, ekin_after_rescale) -> MDState:
    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64)
    v = remove_com_velocity(torch.as_tensor(reference_initial_velocities(cfg.n)))
    v = v * np.sqrt(ekin_after_rescale / (0.5 * float(torch.sum(v * v))))
    return MDState(r=r, ru=r.clone(), v=v, a=torch.zeros_like(r))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("backend", ["dense", "rows"])
def test_lattice_energies_forces_match_golden(k, backend):
    g = _golden(k)
    cfg = _golden_cfg(g)
    eng = pe.make_engine(cfg, backend, device="cpu")
    carry, obs = eng.init(_golden_state(cfg, g["lattice"]["ekin_after_rescale"]))
    gl = g["lattice"]
    assert abs(float(obs.epot) - gl["epot"]) < 1e-9 * abs(gl["epot"])
    assert abs(float(obs.d_epot) - gl["d_epot"]) < 1e-9 * max(1.0, abs(gl["d_epot"]))
    assert abs(float(obs.dd_epot) - gl["dd_epot"]) < 1e-9 * abs(gl["dd_epot"])
    a = eng.get_state(carry).a.numpy()
    np.testing.assert_allclose(a[:3], np.asarray(gl["forces_first3"]), rtol=1e-9, atol=1e-9)
    assert abs(float(np.sum(np.abs(a))) - gl["force_abs_sum"]) < 1e-8


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("backend", ["dense", "rows"])
def test_verlet_trajectory_matches_golden(k, backend):
    g = _golden(k)
    cfg = _golden_cfg(g)
    eng = pe.make_engine(cfg, backend, device="cpu")
    carry, _ = eng.init(_golden_state(cfg, g["lattice"]["ekin_after_rescale"]))
    for step_golden in g["verlet"]:
        carry, obs = eng.step(carry)
        for key in ("epot", "ekin", "d_epot", "dd_epot"):
            got, want = float(getattr(obs, key)), step_golden[key]
            assert abs(got - want) < 1e-9 * max(1.0, abs(want)), (key, got, want)
    r = eng.get_state(carry).r.numpy()
    np.testing.assert_allclose(r[:3], np.asarray(g["final_r_first3"]), rtol=1e-9, atol=1e-9)
    assert abs(float(np.sum(np.abs(r))) - g["final_r_abs_sum"]) < 1e-8 * g["final_r_abs_sum"]
