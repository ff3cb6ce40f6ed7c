"""The port's particle-sharded path (``ljmd_tpu_torch/parallel/``) against
the JAX package's (``ljmd_tpu/parallel/spatial.py``) on the CPU, and its
meshes:

- one step of ``make_spatial_step_fn`` for every ``comm`` at d = 1, 2, 3, 4
  (no hop, the half hop alone, a full hop, full plus half) at N=108, five
  steps against JAX's step on the 8-device virtual mesh of
  tests/conftest.py and against the port's single-device dense engine, at
  tests/test_parallel.py's rtol 1e-11 (r) / 1e-10 (v, observables);
- the compensated step (float32, dt = 1e-4) against JAX's;
- ``run_production`` through the sharded engine against the single-device
  run, rtol 1e-9 as in tests/test_parallel.py;
- ``ThreadMesh``'s collectives, a raise in one rank (surfaces, no hang),
  ``dryrun_multichip`` on the CPU, and one half-ring step on 2 gloo ranks of
  ``DistMesh`` held to ``ThreadMesh``'s result bit for bit.

States are made with numpy from a seed and handed to both packages
(``utils/convert.py``); everything is float64 unless named.
"""

import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density as j_config
from ljmd_tpu.parallel.mesh import make_mesh as j_make_mesh
from ljmd_tpu.parallel.spatial import make_spatial_step_fn as j_step_fn
from ljmd_tpu.parallel.spatial import shard_state as j_shard_state
from ljmd_tpu.state import MDState as JState
from ljmd_tpu_torch.config import config_from_density
from ljmd_tpu_torch.models.engine import make_engine
from ljmd_tpu_torch.models.simulation import run_production
from ljmd_tpu_torch.parallel.mesh import ThreadMesh, make_mesh
from ljmd_tpu_torch.parallel.spatial import make_spatial_engine, make_spatial_step_fn
from ljmd_tpu_torch.utils.convert import (
    spatial_carry_from_numpy,
    spatial_carry_to_numpy,
    state_from_numpy,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_cells=3, density=0.6, total_steps=120, output_interval=10, warmup_steps=20,
          dt=0.002, dtype="float64", target_total_energy=-200.0, seed=3)  # N=108
STEPS = 5


def _fluid(num_cells, box_length, seed, vscale=0.5):
    """{r, ru, v, a}: a jittered FCC lattice and uniform velocities (zero
    total momentum), a = 0, as numpy (N, 3) arrays."""
    from ljmd_tpu_torch.models.lattice import fcc_lattice

    rng = np.random.default_rng(seed)
    r = fcc_lattice(num_cells, box_length, dtype=torch.float64).numpy()
    r = (r + rng.normal(0, 0.05, r.shape)) % box_length
    v = rng.uniform(-vscale, vscale, r.shape)
    v -= v.mean(axis=0)
    return dict(r=r, ru=r.copy(), v=v, a=np.zeros_like(r))


def _jax_state(st, dtype=jnp.float64):
    return JState(*(jnp.asarray(st[k], dtype=dtype) for k in ("r", "ru", "v", "a")))


@pytest.fixture(scope="module")
def fluid():
    cfg = config_from_density(**KW)
    st = _fluid(3, cfg.box_length, 5)
    # the single-device reference: the port's dense engine, stepped from the
    # same carry (a = 0, as the sharded steps below start)
    eng = make_engine(cfg, "dense", "cpu")
    c = state_from_numpy(st)
    for _ in range(STEPS):
        c, obs = eng.step(c)
    return cfg, st, eng.get_state(c), obs


@pytest.mark.parametrize("d", [1, 2, 3, 4])
@pytest.mark.parametrize("comm", ["half_ring", "ring", "all_gather"])
def test_spatial_step_matches_jax_and_dense(fluid, comm, d):
    cfg, st, dense, dense_obs = fluid
    jcfg = j_config(**KW)
    jmesh = j_make_mesh(replica=1, particle=d)
    jstep = j_step_fn(jcfg, jmesh, comm=comm)
    run = jax.jit(lambda s: jax.lax.scan(lambda c, _: jstep(c), s, None, length=STEPS))
    jst, jobs = run(j_shard_state(_jax_state(st), jmesh))
    want = {k: np.asarray(getattr(jst, k)) for k in ("r", "ru", "v", "a")}

    mesh = make_mesh(particle=d, device="cpu")
    try:
        fn = make_spatial_step_fn(cfg, mesh, comm=comm)  # the kernels' twins
        c = spatial_carry_from_numpy(st, mesh)
        for _ in range(STEPS):
            c, obs = fn(c)
        got = spatial_carry_to_numpy(c, mesh)
        tag = f"{comm} d={d}"
        np.testing.assert_allclose(got["r"], want["r"], rtol=1e-11, atol=1e-12, err_msg=tag)
        np.testing.assert_allclose(got["v"], want["v"], rtol=1e-10, atol=1e-12, err_msg=tag)
        np.testing.assert_allclose(got["r"], dense.r.numpy(), rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(got["v"], dense.v.numpy(), rtol=1e-10, atol=1e-12)
        for f in ("epot", "ekin", "d_epot", "dd_epot"):
            assert float(getattr(obs, f)) == pytest.approx(
                float(getattr(jobs, f)[-1]), rel=1e-10), (tag, f)
            assert float(getattr(obs, f)) == pytest.approx(
                float(getattr(dense_obs, f)), rel=1e-10), (tag, f)
    finally:
        mesh.close()


def test_spatial_rejects_non_divisor_axis(fluid):
    cfg = fluid[0]
    mesh = make_mesh(particle=5, device="cpu")  # 108 % 5 != 0
    try:
        with pytest.raises(ValueError, match="not divisible"):
            make_spatial_step_fn(cfg, mesh)
    finally:
        mesh.close()


def test_compensated_step_matches_jax():
    """float32 at dt = 1e-4 takes the Neumaier-compensated carry in both
    packages; five steps agree to float32 rounding of sums taken in another
    order: r + rc and v + vc within 1e-8 (1.5e-11 and 4.1e-10 measured),
    the energies within 1e-6 relative."""
    kw = dict(KW, dt=1e-4, dtype="float32")
    cfg = config_from_density(**kw)
    st = _fluid(3, cfg.box_length, 6)
    jmesh = j_make_mesh(replica=1, particle=2)
    jstep = j_step_fn(j_config(**kw), jmesh)
    assert jstep.compensated
    jstate = j_shard_state(_jax_state(st, jnp.float32), jmesh)
    zero = jnp.zeros_like(jstate.r)
    jc = jax.jit(lambda c: jax.lax.scan(lambda cc, _: jstep(*cc), c, None, length=STEPS))(
        (jstate, zero, zero))
    (jst, jrc, jvc), jobs = jc

    mesh = make_mesh(particle=2, device="cpu")
    try:
        fn = make_spatial_step_fn(cfg, mesh)
        assert fn.compensated
        zeros = np.zeros_like(st["r"])
        c = spatial_carry_from_numpy((st, zeros, zeros), mesh, dtype=torch.float32)
        for _ in range(STEPS):
            c, obs = fn(c)
        got, rc, vc = spatial_carry_to_numpy(c, mesh)
    finally:
        mesh.close()
    np.testing.assert_allclose(got["r"] + rc.astype(np.float64),
                               np.asarray(jst.r) + np.asarray(jrc, np.float64), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got["v"] + vc.astype(np.float64),
                               np.asarray(jst.v) + np.asarray(jvc, np.float64), rtol=0,
                               atol=1e-8)
    for f in ("epot", "ekin", "d_epot"):
        assert float(getattr(obs, f)) == pytest.approx(float(getattr(jobs, f)[-1]), rel=1e-6)


@pytest.mark.parametrize("comm", ["half_ring", "ring"])
def test_spatial_production_matches_single_device(comm):
    """run_production through the sharded engine (4 ranks, the kernels'
    twins) == the single-device dense run (sampling cadence, means,
    correlations), rtol 1e-9."""
    cfg = config_from_density(num_cells=4, density=0.7, total_steps=40, output_interval=10,
                              warmup_steps=5, dt=0.002, dtype="float64",
                              target_total_energy=-1200.0)
    state = state_from_numpy(_fluid(4, cfg.box_length, 7))
    want = run_production(cfg, state, backend="dense", device="cpu")
    mesh = make_mesh(particle=4, device="cpu")
    try:
        got = run_production(cfg, state, engine=make_spatial_engine(cfg, mesh, comm=comm))
    finally:
        mesh.close()
    np.testing.assert_allclose(got.series.numpy(), want.series.numpy(), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got.means.means.numpy(), want.means.means.numpy(), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(got.final_state.r.numpy(), want.final_state.r.numpy(),
                               rtol=1e-9, atol=1e-11)


def test_spatial_run_fast_matches_per_step(fluid):
    """k fast steps inside one mesh.run == k per-step calls (the same step
    body; JAX's tests/test_parallel.py holds its fused chunk to atol 1e-12)."""
    cfg, st = fluid[0], fluid[1]
    mesh = make_mesh(particle=4, device="cpu")
    try:
        eng = make_spatial_engine(cfg, mesh)
        c1, _ = eng.init(state_from_numpy(st))
        c2 = c1
        c1 = eng.run_fast(c1, 3)
        for _ in range(3):
            c2, _ = eng.step(c2)
        s1, s2 = eng.get_state(c1), eng.get_state(c2)
    finally:
        mesh.close()
    for f in ("r", "ru", "v", "a"):
        np.testing.assert_allclose(getattr(s1, f).numpy(), getattr(s2, f).numpy(), rtol=0,
                                   atol=1e-12, err_msg=f)


def test_thread_mesh_collectives():
    mesh = ThreadMesh(4, "cpu")
    try:
        def body(comm, x):
            return (comm.ppermute(x, 1), comm.ppermute(x, -2), comm.psum(x), comm.pmax(x),
                    comm.all_gather(x))

        xs = [torch.tensor([float(r), 10.0 - r], dtype=torch.float64) for r in range(4)]
        outs = mesh.run(body, xs)
        for r, (fwd, back2, total, mx, gathered) in enumerate(outs):
            assert torch.equal(fwd, xs[(r - 1) % 4])   # JAX [(s, s + 1)]: from s - 1
            assert torch.equal(back2, xs[(r + 2) % 4])
            assert torch.equal(total, ((xs[0] + xs[1]) + xs[2]) + xs[3])  # rank order
            assert torch.equal(mx, torch.tensor([3.0, 10.0], dtype=torch.float64))
            assert torch.equal(gathered, torch.cat(xs))
        g = mesh.gather(xs)
        assert all(torch.equal(a, b) for a, b in zip(mesh.split(g), xs))
        assert mesh.on_root(lambda: 7) == 7
    finally:
        mesh.close()


def test_thread_mesh_raise_in_one_rank_surfaces_without_hang():
    """A rank that raises before a collective aborts the others' wait; the
    error reaches the caller, and the mesh runs again afterwards."""
    mesh = ThreadMesh(3, "cpu")
    try:
        def body(comm, x):
            if comm.rank == 1:
                raise ValueError("rank 1 failed")
            return comm.psum(x)

        t0 = time.time()
        with pytest.raises(ValueError, match="rank 1 failed"):
            mesh.run(body, [torch.ones(2)] * 3)
        assert time.time() - t0 < 30
        out = mesh.run(lambda comm, x: comm.psum(x), [torch.ones(2)] * 3)
        assert torch.equal(out[0], torch.full((2,), 3.0))
        with pytest.raises(ValueError, match="length"):
            mesh.run(lambda comm, x: x, [1, 2])
    finally:
        mesh.close()
    assert not any(t.name.startswith("ljmd-rank-") and t.is_alive()
                   for t in threading.enumerate())


def test_make_mesh_rejects_what_it_does_not_have():
    with pytest.raises(ValueError, match="at least one rank"):  # an axis of no rank
        make_mesh(particle=2, replica=0, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        make_mesh(particle=2, device="cpu", kind="mpi")
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(particle=2, kind="dist", device="cpu")


def test_dryrun_multichip_on_cpu(capsys):
    from ljmd_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "half-ring" in out and "sharded-pencil" in out and "compensated" in out


_DIST_CHILD = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    from ljmd_tpu_torch.config import config_from_density
    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.parallel.spatial import make_spatial_step_fn
    from ljmd_tpu_torch.utils.convert import spatial_carry_from_numpy

    rank = int(sys.argv[1])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://localhost:{port}", world_size=2,
                            rank=rank)
    st = torch.load({state!r}, weights_only=False)
    cfg = config_from_density(**{kw!r})
    mesh = make_mesh(particle=2, kind="dist", device="cpu")
    fn = make_spatial_step_fn(cfg, mesh, comm="half_ring")
    (shard,), obs = fn(spatial_carry_from_numpy(st, mesh))
    torch.save({{"shard": shard, "obs": obs}}, {out!r}.format(rank))
    from ljmd_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2, device="cpu", kind="dist")
    dist.destroy_process_group()
""")


def test_dist_mesh_gloo_matches_thread_mesh(fluid, tmp_path):
    """One half-ring step on 2 gloo ranks (one process each) == the same
    step on a 2-rank ThreadMesh, bit for bit (sums in rank order); then
    ``dryrun_multichip(2, kind="dist")`` on the same process group (the
    sharded pencil's rebin through ``DistMesh.on_root``)."""
    cfg, st = fluid[0], fluid[1]
    state_path = str(tmp_path / "state.pt")
    torch.save(st, state_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = _DIST_CHILD.format(repo=REPO, port=port, state=state_path, kw=KW,
                              out=str(tmp_path / "rank{}.pt"))
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    assert all("sharded-pencil OK" in out and "compensated spatial OK" in out for out in outs)

    mesh = make_mesh(particle=2, device="cpu")
    try:
        fn = make_spatial_step_fn(cfg, mesh, comm="half_ring")
        want, want_obs = fn(spatial_carry_from_numpy(st, mesh))
    finally:
        mesh.close()
    for r in range(2):
        got = torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False)
        for f in ("r", "ru", "v", "a"):
            assert torch.equal(getattr(got["shard"], f), getattr(want[r], f)), (r, f)
        for f in ("epot", "ekin", "d_epot", "dd_epot"):
            assert torch.equal(getattr(got["obs"], f), getattr(want_obs, f)), (r, f)
