"""The zsort engine's resort triggers (``ljmd_tpu_torch/models/engine.py``
``_zsort_engine(..., trigger=...)``) against the JAX package's, float64 on
the CPU, and the batched engine under each trigger against the one-system
engine.

Both packages start from one ``ZSortCarry`` (``ljmd_tpu_torch.utils.convert``)
and step chunk by chunk; the JAX engine runs its Pallas kernels in interpret
mode with ``inner_chunk=8``, as tests/test_torch_zsort.py runs it. Equal
``ids`` and ``r_ref`` after every chunk mean the same resorts happened; the
states and observables are held to that file's tolerances (rtol 1e-10). The
fluid (N=500, rho* 0.8, dt 0.004: the cond'd triggers' auto skin 0.464) makes
``static`` and ``predictive`` fire at some checks and not at others.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _zsort_engine as j_zsort_engine
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models import simulation as psim
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

FIELDS = ("r", "ru", "v", "a")
OBS = ("epot", "ekin", "d_epot", "dd_epot")
CHUNK = 8
CHECKS = 6
R = 2


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


@pytest.fixture(scope="module")
def fluid():
    """N=500 at rho* 0.8, dt 0.004, dense-initialized by the JAX package."""
    jcfg = config_from_density(num_cells=5, density=0.8, dt=0.004, dtype="float64",
                               total_steps=10, warmup_steps=30, target_total_energy=-2300.0)
    return jcfg, j_initialize(jcfg, backend="dense")


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


@pytest.mark.parametrize("trigger", ["always", "static", "predictive", "never"])
def test_trigger_geometry_matches_jax(fluid, trigger):
    """The skin (the one-chunk travel bound under "always", the auto skin
    under the cond'd triggers), the flag window and both thresholds equal
    the JAX engine's; the one-chunk travel check binds "always" only."""
    jcfg, _ = fluid
    je = j_zsort_engine(jcfg, interpret=True, inner_chunk=CHUNK, trigger=trigger)
    geo = pe.zsort_geometry(_port_cfg(jcfg), CHUNK, trigger=trigger)
    for name in ("sort_skin", "window", "invalid_thresh", "resort_thresh"):
        assert getattr(geo, name) == _closure_value(je.run_fast, name), name
    assert geo.sort_skin == (0.3 if trigger == "always" else 0.464)
    # dt 0.02 at chunk 64: the box cannot hold the one-chunk travel skin
    hot = _port_cfg(jcfg).replace(dt=0.02)
    if trigger == "always":
        with pytest.raises(ValueError, match="cond'd trigger"):
            pe.zsort_geometry(hot, 64, trigger=trigger)
    else:
        assert pe.zsort_geometry(hot, 64, trigger=trigger).sort_skin == 0.7


@pytest.mark.parametrize("trigger", ["static", "predictive", "never"])
def test_trigger_matches_jax_chunk_by_chunk(fluid, trigger):
    """CHECKS chunks of 8 from one carry: the same resorts (ids and r_ref
    after every chunk), the states within rtol 1e-10, the sticky flag; a
    run_sample's observables within 1e-10. ``static`` and ``predictive``
    fire at some checks and not at all; the host reads one flag a check,
    and the carry counts the resorts."""
    jcfg, jstate = fluid
    je = j_zsort_engine(jcfg, interpret=True, inner_chunk=CHUNK, trigger=trigger)
    peng = pe._zsort_engine(_port_cfg(jcfg), "cpu", inner_chunk=CHUNK, trigger=trigger)
    jc, _ = jax.jit(je.init)(jstate)
    pc = convert.zsort_carry_from_numpy(jax.device_get(jc))
    chunk = jax.jit(lambda c: je.run_fast(c, CHUNK))
    reads = pe.HOST_READS["zsort_fire"]
    fired = 0
    for k in range(CHECKS):
        ref = np.asarray(jc.r_ref)
        jc, pc = chunk(jc), peng.run_fast(pc, CHUNK)
        fired += not np.array_equal(ref, np.asarray(jc.r_ref))
        np.testing.assert_array_equal(pc.ids.numpy(), np.asarray(jc.ids), err_msg=str(k))
        np.testing.assert_allclose(pc.r_ref.numpy(), np.asarray(jc.r_ref), rtol=1e-10,
                                   atol=1e-10, err_msg=str(k))
        assert bool(pc.invalid) == bool(jax.device_get(jc.invalid))
    assert int(pc.resorts) == fired
    assert pe.HOST_READS["zsort_fire"] - reads == (0 if trigger == "never" else CHECKS)
    if trigger == "never":
        assert fired == 0
    else:
        assert 0 < fired < CHECKS, fired
    got, want = peng.get_state(pc), je.get_state(jc)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-10, atol=1e-10, err_msg=k)
    jc2, jo = jax.jit(lambda c: je.run_sample(c, CHUNK))(jc)
    pc2, po = peng.run_sample(pc, CHUNK)
    for k in OBS:
        assert float(getattr(po, k)) == pytest.approx(float(getattr(jo, k)), rel=1e-10), k
    np.testing.assert_array_equal(pc2.ids.numpy(), np.asarray(jc2.ids))


def test_skipped_check_launches_no_resort(fluid):
    """A check that does not fire leaves the carry's sorted rows, lists and
    reference as they were (no resort ran); "always" resorts every chunk and
    reads nothing on the host."""
    jcfg, jstate = fluid
    cfg = _port_cfg(jcfg)
    state = convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS})
    static = pe._zsort_engine(cfg, "cpu", inner_chunk=CHUNK, trigger="static")
    c, _ = static.init(state)
    before = pe.HOST_READS["zsort_fire"]
    c1 = static.run_fast(c, CHUNK)  # the first check: nothing has moved yet
    assert pe.HOST_READS["zsort_fire"] == before + 1 and int(c1.resorts) == 0
    assert c1.r_ref is c.r_ref and c1.tiles is c.tiles and c1.ids is c.ids
    always = pe._zsort_engine(cfg, "cpu", inner_chunk=CHUNK)
    c, _ = always.init(state)
    c = always.run_fast(c, 3 * CHUNK)
    assert pe.HOST_READS["zsort_fire"] == before + 1 and int(c.resorts) == 3


def _same_carry(c, q, one):
    for f in dataclasses.fields(pe.ZSortCarry):
        if f.name == "tiles":  # entries past the counts are unspecified
            continue
        assert torch.equal(getattr(c, f.name)[q], getattr(one, f.name)), f.name


@pytest.mark.parametrize("trigger,extended", [("static", False), ("predictive", False),
                                              ("predictive", True), ("never", False),
                                              ("always", False)])
def test_batched_trigger_replicas_equal_one_system(fluid, trigger, extended):
    """R=2 replicas (the second 1.6x hotter) under each trigger: after every
    chunk (and a run_sample) replica q's carry, its resort count included,
    is the one-system engine's bit for bit; under the cond'd triggers the replicas' resorts
    differ somewhere (each decides for itself), and the host reads one flag
    a check for both."""
    jcfg, _ = fluid
    cfg = _port_cfg(jcfg).replace(dtype="float32" if extended else "float64",
                                  compensated_sum=extended)
    states = psim.initialize_replicas(cfg, psim.replica_generators(11, R), backend="dense",
                                      device="cpu")
    # replica 1 runs hotter, so that the replicas' triggers fire apart
    hotter = torch.tensor([1.0, 1.6], dtype=states.v.dtype)[:, None, None]
    states = dataclasses.replace(states, v=states.v * hotter)
    kw = dict(inner_chunk=CHUNK, trigger=trigger, extended=extended)
    eng = pe._zsort_engine(cfg, "cpu", replicas=R, **kw)
    one = pe._zsort_engine(cfg, "cpu", **kw)
    c, _ = eng.init(states)
    ones = [one.init(pe.replica_state(states, q))[0] for q in range(R)]
    history = []
    reads = pe.HOST_READS["zsort_fire"]
    for _ in range(CHECKS):
        c = eng.run_fast(c, CHUNK)
        ones = [one.run_fast(cq, CHUNK) for cq in ones]
        for q in range(R):
            _same_carry(c, q, ones[q])
        history.append(c.resorts.tolist())
    cond = trigger in ("static", "predictive")
    assert pe.HOST_READS["zsort_fire"] - reads == (1 + R) * CHECKS * cond
    if cond:
        assert any(a != b for a, b in history), history
        assert all(0 < n < CHECKS for n in history[-1]), history
    c, obs = eng.run_sample(c, CHUNK)
    for q in range(R):
        cq, oq = one.run_sample(ones[q], CHUNK)
        _same_carry(c, q, cq)
        assert torch.equal(obs.epot[q], oq.epot) and torch.equal(obs.ekin[q], oq.ekin)
        got, want = eng.get_state(c), one.get_state(cq)
        for k in FIELDS:
            assert torch.equal(getattr(got, k)[q], getattr(want, k)), k
    if trigger != "never":
        assert not bool(eng.diagnostics(c)["zsort_invalid"].any())
