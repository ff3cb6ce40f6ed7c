"""The port's sharded pencil engine (``ljmd_tpu_torch/parallel/
spatial_pencil.py``) against the JAX package's
(``ljmd_tpu/parallel/spatial_pencil.py``) on the CPU, float64.

The dryrun's config (N=256, rc = 1.4, skin 0.5: 4x4 pencils of capacity
128) on 1, 2 and 4 strips, under each rebin trigger: ``init``, a step, a
fused ``run_fast(8)``, a step. JAX runs on the 8-device virtual mesh of
tests/conftest.py (its plain sweep, the default off the TPU); the port runs
the kernel wrapper's twin (the strip sweep with ``n_pencils_i``), in JAX's
chunks of 8. Both start from the same numpy state; the
port's ``run_fast`` also starts from JAX's own carry (``utils/convert.py``).
Tolerance: atol 1e-9, tests/test_parallel.py's bar for its pencil paths
(the sums run in another order; measured ~1e-14).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ljmd_tpu.config import config_from_density as j_config
from ljmd_tpu.parallel.spatial_pencil import make_sharded_pencil_engine as j_engine
from ljmd_tpu.state import MDState as JState
from ljmd_tpu_torch.config import config_from_density
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.parallel.mesh import make_mesh
from ljmd_tpu_torch.parallel.spatial_pencil import make_sharded_pencil_engine
from ljmd_tpu_torch.utils.convert import (
    sharded_pencil_carry_from_numpy,
    sharded_pencil_carry_to_numpy,
    state_from_numpy,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_cells=4, density=0.5, rc=1.4, dt=0.002, dtype="float64", total_steps=8,
          output_interval=4, warmup_steps=0, neighbor_skin=0.5, target_total_energy=-100.0)
M_XY = 4
FIELDS = ("r", "ru", "v", "a")


def _fluid(box_length, seed, vscale):
    rng = np.random.default_rng(seed)
    r = fcc_lattice(4, box_length, dtype=torch.float64).numpy()
    r = (r + rng.normal(0, 0.05, r.shape)) % box_length
    v = rng.normal(0, vscale, r.shape)
    v -= v.mean(axis=0)
    return dict(r=r, ru=r.copy(), v=v, a=np.zeros_like(r))


def _jax_run(cfg, st, d, **kw):
    eng = j_engine(j_config(**cfg), Mesh(np.array(jax.devices()[:d]), ("particle",)), **kw)
    c, obs0 = jax.jit(eng.init)(JState(*(jnp.asarray(st[k]) for k in FIELDS)))
    c1, _ = jax.jit(eng.step)(c)
    c2 = jax.jit(lambda cc: eng.run_fast(cc, 8))(c1)
    c3, obs = jax.jit(eng.step)(c2)
    return dict(obs0=obs0, obs=obs, after_step=c1, end=c3, state=eng.get_state(c3),
                overflow=bool(c3.overflow))


def _close_state(got, want, tag):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-9, err_msg=f"{tag} {f}")


@pytest.mark.parametrize("trigger", ["always", "predictive", "never"])
@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_pencil_matches_jax(d, trigger):
    cfg = config_from_density(**KW)
    st = _fluid(cfg.box_length, 1, 1.2)
    want = _jax_run(KW, st, d, rebin_trigger=trigger)
    mesh = make_mesh(particle=d, device="cpu")
    try:
        tag = f"d={d} {trigger}"
        eng = make_sharded_pencil_engine(cfg, mesh, rebin_trigger=trigger, inner_chunk=8)
        c, obs0 = eng.init(state_from_numpy(st))
        for f in ("epot", "ekin", "d_epot", "dd_epot"):
            assert float(getattr(obs0, f)) == pytest.approx(
                float(getattr(want["obs0"], f)), rel=1e-12), (tag, f)
        c, _ = eng.step(c)
        got = sharded_pencil_carry_to_numpy(c, mesh, M_XY)
        ref = want["after_step"]
        for k in ("counts", "overflow"):
            assert np.array_equal(got[k], np.asarray(getattr(ref, k))), (tag, k)
        for k in ("r", "ru", "v", "a", "r_ref"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k)), rtol=0,
                                       atol=1e-9, err_msg=f"{tag} {k}")
        # run_fast from JAX's own carry, and from the port's
        for start in (sharded_pencil_carry_from_numpy(ref, mesh, M_XY), c):
            cc, obs = eng.step(eng.run_fast(start, 8))
            _close_state(eng.get_state(cc), want["state"], tag)
            assert float(obs.epot) == pytest.approx(float(want["obs"].epot), rel=1e-11)
            assert float(obs.d_epot) == pytest.approx(float(want["obs"].d_epot), rel=1e-11)
            assert bool(cc[0].overflow) == want["overflow"]
    finally:
        mesh.close()


def test_sharded_pencil_per_step_rebin_matches_jax():
    """A hot fluid at dt = 0.01: the per-step displacement check fires and
    the engine rebins inside ``step`` (one host read per step), as JAX's
    ``lax.cond`` does; 2 strips, 12 steps."""
    kw = dict(KW, dt=0.01)
    cfg = config_from_density(**kw)
    st = _fluid(cfg.box_length, 2, 3.0)
    jeng = j_engine(j_config(**kw), Mesh(np.array(jax.devices()[:2]), ("particle",)))
    jc, _ = jax.jit(jeng.init)(JState(*(jnp.asarray(st[k]) for k in FIELDS)))
    jstep = jax.jit(jeng.step)
    mesh = make_mesh(particle=2, device="cpu")
    try:
        eng = make_sharded_pencil_engine(cfg, mesh, inner_chunk=8)
        c, _ = eng.init(state_from_numpy(st))
        pe.HOST_READS["sharded_pencil_moved"] = 0
        rebins = 0
        for _ in range(12):
            ref = c[0].r_ref
            c, obs = eng.step(c)
            jc, jobs = jstep(jc)
            rebins += int(c[0].r_ref is not ref)
        assert pe.HOST_READS["sharded_pencil_moved"] == 12 and rebins >= 1
        _close_state(eng.get_state(c), jeng.get_state(jc), "per-step rebin")
        assert float(obs.epot) == pytest.approx(float(jobs.epot), rel=1e-11)
    finally:
        mesh.close()


def test_sharded_pencil_compensated_matches_jax():
    """float32 at dt = 1e-4: the compensated carry and the predictive
    trigger in both packages; after a step and run_fast(8), positions and
    velocities (with their remainders) within 1e-6 (float32 sums in another
    order)."""
    kw = dict(KW, dt=1e-4, dtype="float32")
    cfg = config_from_density(**kw)
    st = _fluid(cfg.box_length, 3, 1.0)
    st32 = {k: x.astype(np.float32) for k, x in st.items()}
    jeng = j_engine(j_config(**kw), Mesh(np.array(jax.devices()[:2]), ("particle",)))
    jc, _ = jax.jit(jeng.init)(JState(*(jnp.asarray(st32[k]) for k in FIELDS)))
    jc = jax.jit(lambda c: jeng.run_fast(jeng.step(c)[0], 8))(jc)
    mesh = make_mesh(particle=2, device="cpu")
    try:
        eng = make_sharded_pencil_engine(cfg, mesh, inner_chunk=8)
        c, _ = eng.init(state_from_numpy(st32, dtype=torch.float32))
        c = eng.run_fast(eng.step(c)[0], 8)
        got = sharded_pencil_carry_to_numpy(c, mesh, M_XY)
    finally:
        mesh.close()
    for k, lo in (("r", "rc"), ("v", "vc")):
        np.testing.assert_allclose(
            got[k].astype(np.float64) + got[lo], np.asarray(getattr(jc, k), np.float64)
            + np.asarray(getattr(jc, lo), np.float64), rtol=0, atol=1e-6, err_msg=k)


def test_sharded_pencil_rejects_non_divisor_axis():
    cfg = config_from_density(**KW)  # 4x4 pencils
    mesh = make_mesh(particle=3, device="cpu")
    try:
        with pytest.raises(ValueError, match="does not split"):
            make_sharded_pencil_engine(cfg, mesh)
    finally:
        mesh.close()


def test_sharded_pencil_default_chunk_keeps_drift_check_clear():
    """JAX's fixed chunk of 8 lets the fastest particles of a hot fluid
    outrun the 3-D skin / 2 drift check between rebins (``pencil_overflow``
    set); the default chunk, sized from the state's top speed, keeps it
    clear over the same 16 steps, and the rule itself: BASELINE config 5
    (dt 0.005, skin / 2 = 0.2) at a top speed of 4.5 gets 5 steps."""
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.parallel.spatial_pencil import MAX_INNER_CHUNK, default_inner_chunk

    cfg5 = load_config(f"{REPO}/examples/n62500_large.json")
    assert default_inner_chunk(cfg5, 4.5) == 5
    assert default_inner_chunk(cfg5, 0.0) == MAX_INNER_CHUNK
    assert default_inner_chunk(cfg5, 1e3) == 1
    kw = dict(KW, dt=0.01)
    cfg = config_from_density(**kw)
    st = state_from_numpy(_fluid(cfg.box_length, 4, 1.0))
    top = float(torch.sqrt((st.v * st.v).sum(dim=1)).max())
    assert default_inner_chunk(cfg, top) < 8
    mesh = make_mesh(particle=2, device="cpu")
    try:
        flags = {}
        for chunk in (8, None):
            eng = make_sharded_pencil_engine(cfg, mesh, inner_chunk=chunk)
            c = eng.run_fast(eng.init(st)[0], 16)
            flags[chunk] = bool(eng.diagnostics(c)["pencil_overflow"])
    finally:
        mesh.close()
    assert flags == {8: True, None: False}
