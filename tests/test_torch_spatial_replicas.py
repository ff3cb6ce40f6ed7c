"""The port's replica x particle path (``ljmd_tpu_torch/parallel/``) on the
CPU against the JAX package's (``ljmd_tpu/parallel/spatial.py``
``make_ensemble_spatial_step_fn``, ``parallel/ensemble.py`` with a mesh,
``parallel/mesh.py``), float64 unless named:

- the replica x particle step on a ``ThreadMesh(replica=2, particle=2)``
  against JAX's on a (2, 2) mesh of tests/conftest.py's virtual CPU devices
  (``use_pallas=True``: the Pallas kernels in interpret mode) for every
  ``comm``, plain and compensated, at tests/test_torch_spatial.py's
  tolerances (those of tests/test_parallel.py);
- replica q of that step against ``make_spatial_step_fn`` on a particle
  mesh run on replica q alone, bit for bit (states and observables);
- the replica twins of kernels 6 and 7 against JAX's ``vmap``ped Pallas
  calls (interpret), and replica q against the one-replica twin bit for bit;
- ``ensemble_simulate(mesh=make_mesh(replica=4))`` against the unsharded
  run (tests/test_parallel.py:102-113);
- ``dryrun_multichip(4)``'s replica x particle mesh, the meshes' rows, their
  validation beside JAX's, and one step on 4 gloo processes
  (``DistMesh(replica=2)``) held to ``ThreadMesh``'s bit for bit.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ljmd_tpu.config import config_from_density as j_config
from ljmd_tpu.ops import pallas_lj as jpl
from ljmd_tpu.parallel.mesh import make_mesh as j_make_mesh
from ljmd_tpu.parallel.spatial import make_ensemble_spatial_step_fn as j_ens_step_fn
from ljmd_tpu.state import MDState as JState
from ljmd_tpu_torch.config import SimConfig, config_from_density
from ljmd_tpu_torch.models.lattice import fcc_lattice
from ljmd_tpu_torch.ops import pair_sweep as pps
from ljmd_tpu_torch.parallel import ensemble as pens
from ljmd_tpu_torch.parallel import spatial as psp
from ljmd_tpu_torch.parallel.mesh import (
    PARTICLE_AXIS,
    REPLICA_AXIS,
    ThreadMesh,
    make_mesh,
)
from ljmd_tpu_torch.state import MDState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(num_cells=3, density=0.6, total_steps=120, output_interval=10, warmup_steps=20,
          dt=0.002, dtype="float64", target_total_energy=-200.0, seed=3)  # N=108
R = 4
STEPS = 3
FIELDS = ("r", "ru", "v", "a")
COMMS = ("half_ring", "ring", "all_gather")


def _fluids(kw, seed, replicas=R):
    """{r, ru, v, a} of R jittered FCC lattices with uniform velocities (zero
    total momentum each), a = 0: numpy (R, N, 3) arrays."""
    box = config_from_density(**kw).box_length
    rng = np.random.default_rng(seed)
    lattice = fcc_lattice(kw["num_cells"], box, dtype=torch.float64).numpy()
    r = np.stack([(lattice + rng.normal(0, 0.05, lattice.shape)) % box
                  for _ in range(replicas)])
    v = rng.uniform(-0.5, 0.5, r.shape)
    v -= v.mean(axis=1, keepdims=True)
    return dict(r=r, ru=r.copy(), v=v, a=np.zeros_like(r))


def _state(st, dtype=torch.float64):
    return MDState(*(torch.tensor(st[k], dtype=dtype) for k in FIELDS))


def _kw(compensated):
    return dict(KW, dt=1e-4, dtype="float32") if compensated else KW


def _port_steps(cfg, st, mesh, comm, compensated, steps=STEPS):
    """The t = 0 force evaluation, then ``steps`` replica x particle steps
    from st: (the initial accelerations, {r, v} as (R, N, 3) float64 arrays,
    r + rc and v + vc when compensated, the last step's observables)."""
    fn = psp.make_ensemble_spatial_step_fn(cfg, mesh, comm=comm)
    assert fn.compensated == compensated
    c, _ = fn.init(psp.shard_replica_states(st, mesh, cfg, compensated))
    a0 = psp.gather_replica_states(c, mesh, compensated).a.numpy()
    for _ in range(steps):
        c, obs = fn(c)
    axes = ((0, 1), (REPLICA_AXIS, PARTICLE_AXIS))

    def glob(parts):
        return mesh.gather(parts, *axes).double().numpy()

    if compensated:
        out = {"r": glob([x[0].r for x in c]) + glob([x[1] for x in c]),
               "v": glob([x[0].v for x in c]) + glob([x[2] for x in c])}
    else:
        out = {"r": glob([x.r for x in c]), "v": glob([x.v for x in c])}
    return a0, out, obs


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "compensated"])
@pytest.mark.parametrize("comm", COMMS)
def test_ensemble_step_matches_jax(comm, compensated):
    """STEPS steps after the t = 0 force evaluation, 4 replicas on a (2, 2)
    mesh in both packages: r rtol 1e-11, v and the observables 1e-10
    (float64); compensated (float32, dt = 1e-4): r + rc and v + vc within
    1e-8, the energies 1e-6 relative (tests/test_torch_spatial.py's)."""
    kw = _kw(compensated)
    cfg = config_from_density(**kw)
    st = _fluids(kw, 5)
    jdt = jnp.float32 if compensated else jnp.float64
    dtype = torch.float32 if compensated else torch.float64
    mesh = make_mesh(particle=2, replica=2, device="cpu")
    try:
        a0, got, obs = _port_steps(cfg, _state(st, dtype), mesh, comm, compensated)
    finally:
        mesh.close()
    # JAX's step has no init of its own: it starts from the port's t = 0
    # accelerations (the same forces in both packages to 1e-12)
    st["a"] = a0
    jmesh = j_make_mesh(replica=2, particle=2)
    jstep = j_ens_step_fn(j_config(**kw), jmesh, comm=comm, use_pallas=True)
    assert jstep.compensated == compensated
    spec = NamedSharding(jmesh, P("replica", "particle", None))
    jst = JState(*(jax.device_put(jnp.asarray(st[k], dtype=jdt), spec) for k in FIELDS))
    if compensated:
        zero = jnp.zeros_like(jst.r)

        def body(c, _):
            return jstep(*c)

        (js, jrc, jvc), jobs = jax.jit(lambda c: jax.lax.scan(body, c, None, length=STEPS))(
            (jst, zero, zero))
        want_r = np.asarray(js.r, np.float64) + np.asarray(jrc, np.float64)
        want_v = np.asarray(js.v, np.float64) + np.asarray(jvc, np.float64)
        np.testing.assert_allclose(got["r"], want_r, rtol=0, atol=1e-8)
        np.testing.assert_allclose(got["v"], want_v, rtol=0, atol=1e-8)
        fields, rel = ("epot", "ekin", "d_epot"), 1e-6
    else:
        js, jobs = jax.jit(lambda s: jax.lax.scan(lambda c, _: jstep(c), s, None,
                                                  length=STEPS))(jst)
        np.testing.assert_allclose(got["r"], np.asarray(js.r), rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(got["v"], np.asarray(js.v), rtol=1e-10, atol=1e-12)
        fields, rel = ("epot", "ekin", "d_epot", "dd_epot"), 1e-10
    for f in fields:
        g, w = getattr(obs, f).numpy(), np.asarray(getattr(jobs, f))[-1]
        assert g.shape == w.shape == (R,)
        np.testing.assert_allclose(g, w, rtol=rel, err_msg=f)


@pytest.mark.parametrize("compensated", [False, True], ids=["plain", "compensated"])
@pytest.mark.parametrize("comm", COMMS)
def test_replicas_equal_one_replica_sharded_runs(comm, compensated):
    """Replica q of the replica x particle step == make_spatial_step_fn on
    a 2-rank particle mesh on replica q alone, bit for bit."""
    kw = _kw(compensated)
    cfg = config_from_density(**kw)
    dtype = torch.float32 if compensated else torch.float64
    st = _state(_fluids(kw, 6), dtype)
    mesh = make_mesh(particle=2, replica=2, device="cpu")
    one_mesh = make_mesh(particle=2, device="cpu")
    try:
        fn = psp.make_ensemble_spatial_step_fn(cfg, mesh, comm=comm)
        c, obs = fn.init(psp.shard_replica_states(st, mesh, cfg, compensated))
        for _ in range(STEPS):
            c, obs = fn(c)
        got = c
        one_fn = psp.make_spatial_step_fn(cfg, one_mesh, comm=comm)
        init_local = psp._make_local_step(cfg, comm).init_local
        for q in range(R):
            cq = psp.shard_state(MDState(*(getattr(st, k)[q] for k in FIELDS)), one_mesh, cfg,
                                 compensated)
            cq = tuple(x for x, _ in one_mesh.run(init_local, cq))
            for _ in range(STEPS):
                cq, oq = one_fn(cq)
            row, k = divmod(q, R // 2)  # replica q lives on mesh row q // 2, index q % 2
            for p in range(2):
                mine, theirs = got[2 * row + p], cq[p]
                if compensated:
                    mine, theirs = (mine[0], *mine[1:]), (theirs[0], *theirs[1:])
                    for x, y in zip(mine[1:], theirs[1:]):
                        assert torch.equal(x[k], y)
                    mine, theirs = mine[0], theirs[0]
                for f in FIELDS:
                    assert torch.equal(getattr(mine, f)[k], getattr(theirs, f)), (q, p, f)
            for f in ("epot", "ekin", "d_epot", "dd_epot"):
                assert torch.equal(getattr(obs, f)[q], getattr(oq, f)), (q, f)
    finally:
        mesh.close()
        one_mesh.close()


L, RC2 = 6.8, 6.25


@pytest.fixture(scope="module")
def replica_blocks():
    """3 jittered N=256 FCC fluids (L=6.8) as (R, 8, pad) row blocks of
    their first 100 and next 156 particles."""
    rng = np.random.default_rng(12)
    lattice = fcc_lattice(4, L, dtype=torch.float64).numpy()
    a, b = np.zeros((3, 8, 128)), np.zeros((3, 8, 256))
    for q in range(3):
        r = (lattice + rng.normal(0, 0.06, lattice.shape)) % L
        a[q, 0:3, :100], b[q, 0:3, :156] = r[:100].T, r[100:].T
    return a, b


@pytest.mark.parametrize("want_obs", [True, False])
def test_replica_rect_twins_match_vmapped_pallas(replica_blocks, want_obs):
    """Kernel 6's twin on a hop between unequal blocks and kernel 7's on the
    gated half hop (both ranks' halves) and the self offset, over (3, 8,
    pad) stacks: against JAX's vmapped Pallas kernels (rtol = atol = 1e-9,
    tests/test_torch_rect.py's) and replica q against the one-replica twin
    bit for bit."""
    pi, pj = replica_blocks
    ti, tj = torch.tensor(pi), torch.tensor(pj)
    want = jax.vmap(lambda x, y: jpl.pallas_pair_sweep_rect(
        x, y, 100, 156, 0, 100, L, RC2, tile_i=128, tile_j=128, interpret=True,
        want_observables=want_obs))(jnp.asarray(pi), jnp.asarray(pj))
    got = pps.pair_sweep_rect(ti, tj, 100, 156, 0, 100, L, RC2, want_obs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-9)
    for q in range(3):
        assert torch.equal(got[q], pps.pair_sweep_rect(ti[q], tj[q], 100, 156, 0, 100, L, RC2,
                                                       want_obs))
    pj2 = pj[:, :, :128].copy()
    pj2[:, :, 100:] = 0.0
    tj2 = torch.tensor(pj2)
    for gj0, i_lo, j_hi in ((100, 50, 100), (100, 0, 50), (0, 0, 100)):
        pos_j, tpos_j = (pi, ti) if gj0 == 0 else (pj2, tj2)
        wi, wj = jax.vmap(lambda x, y: jpl.pallas_pair_sweep_rect_newton(
            x, y, 100, 100, 0, gj0, L, RC2, i_lo=i_lo, j_hi=j_hi, tile_i=128, tile_j=128,
            interpret=True, want_observables=want_obs))(jnp.asarray(pi), jnp.asarray(pos_j))
        gi, gj = pps.pair_sweep_rect_newton(ti, tpos_j, 100, 100, 0, gj0, L, RC2, i_lo, j_hi,
                                            want_obs)
        np.testing.assert_allclose(gi.numpy(), np.asarray(wi), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(gj.numpy(), np.asarray(wj), rtol=1e-9, atol=1e-9)
        assert not np.any(gj.numpy()[:, 3:])
        for q in range(3):
            oi, oj = pps.pair_sweep_rect_newton(ti[q], tpos_j[q], 100, 100, 0, gj0, L, RC2,
                                                i_lo, j_hi, want_obs)
            assert torch.equal(gi[q], oi) and torch.equal(gj[q], oj)


def test_ensemble_on_mesh_matches_unsharded():
    """tests/test_parallel.py:102-113: the replicas split over a replica=4
    mesh give the unsharded ensemble (here bit for bit: each row runs the
    same batched engine on its replicas), and a replica x particle mesh's
    particle axis does not split replicas."""
    cfg = SimConfig(num_cells=2, box_length=3.6, rc_over_box=0.45, total_steps=60,
                    output_interval=10, warmup_steps=10, dt=0.003, dtype="float64",
                    target_total_energy=-60.0, seed=5, n_runs=8)
    local, lres = pens.ensemble_simulate(cfg, backend="rows", device="cpu",
                                         keep_per_replica=True)
    for replica, particle in ((4, 1), (2, 2)):
        mesh = make_mesh(particle=particle, replica=replica, device="cpu")
        try:
            sharded, sres = pens.ensemble_simulate(cfg, backend="rows", mesh=mesh,
                                                   keep_per_replica=True)
        finally:
            mesh.close()
        for k in ("replica_means", "replica_stds", "mean_of_means", "std_of_means",
                  "corr_mean_runs", "replica_ok"):
            assert torch.equal(getattr(sharded, k), getattr(local, k)), (replica, k)
        assert torch.equal(sres.series, lres.series)
        for k in FIELDS:
            assert torch.equal(getattr(sres.final_state, k), getattr(lres.final_state, k))
    mesh = make_mesh(particle=1, replica=3, device="cpu")
    try:
        with pytest.raises(ValueError, match="not divisible"):
            pens.ensemble_simulate(cfg, backend="rows", mesh=mesh)
    finally:
        mesh.close()


def test_dryrun_multichip_runs_the_replica_x_particle_step(capsys):
    from ljmd_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")
    out = capsys.readouterr().out
    assert "mesh=(replica=2, particle=2)" in out and "4 replicas of N=32" in out
    assert "sharded-pencil" in out and "compensated" in out


def test_thread_mesh_rows_and_axes():
    """Collectives act over a rank's row; split / gather take both axes."""
    mesh = ThreadMesh(3, "cpu", replica=2)
    try:
        assert mesh.coords == ((0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2))

        def body(comm, x):
            return (comm.replica, comm.rank, comm.replica_size, comm.size, comm.ppermute(x, 1),
                    comm.psum(x), comm.all_gather(x))

        xs = [torch.tensor([float(g)]) for g in range(6)]
        for g, (q, p, nq, np_, fwd, total, gathered) in enumerate(mesh.run(body, xs)):
            assert (q, p, nq, np_) == (g // 3, g % 3, 2, 3)
            row = xs[3 * q:3 * q + 3]
            assert torch.equal(fwd, row[(p - 1) % 3])
            assert torch.equal(total, (row[0] + row[1]) + row[2])
            assert torch.equal(gathered, torch.cat(row))
        t = torch.arange(2 * 6 * 2.0).reshape(2, 6, 2)
        parts = mesh.split(t, (0, 1), (REPLICA_AXIS, PARTICLE_AXIS))
        assert [tuple(x.shape) for x in parts] == [(1, 2, 2)] * 6
        assert torch.equal(mesh.gather(parts, (0, 1), (REPLICA_AXIS, PARTICLE_AXIS)), t)
        rows = mesh.split(t, 0, REPLICA_AXIS)
        assert torch.equal(rows[4], t[1:]) and torch.equal(mesh.gather(rows, 0, REPLICA_AXIS), t)
        with pytest.raises(ValueError, match="length"):
            mesh.run(lambda comm, x: x, [1, 2, 3])
    finally:
        mesh.close()


def test_mesh_validation_raises_as_jax():
    """JAX raises ValueError for a mesh of more devices than there are and
    for a particle axis that does not divide N; the port for an axis of no
    rank, a process group of another size (the dist child below), N or R
    not divisible by the axes."""
    with pytest.raises(ValueError):
        j_make_mesh(replica=16, particle=1)
    for kw in (dict(replica=0), dict(particle=0, replica=2)):
        with pytest.raises(ValueError, match="at least one rank"):
            make_mesh(device="cpu", **kw)
    cfg = config_from_density(**KW)
    mesh = make_mesh(particle=5, replica=2, device="cpu")  # 108 % 5 != 0
    try:
        with pytest.raises(ValueError, match="not divisible"):
            psp.make_ensemble_spatial_step_fn(cfg, mesh)
    finally:
        mesh.close()
    mesh = make_mesh(particle=2, replica=3, device="cpu")
    try:
        with pytest.raises(ValueError, match="not divisible"):
            psp.shard_replica_states(_state(_fluids(KW, 1)), mesh)  # 4 % 3 != 0
    finally:
        mesh.close()


_DIST_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, {repo!r})
    from ljmd_tpu_torch.config import config_from_density
    from ljmd_tpu_torch.parallel import spatial as psp
    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.state import MDState

    rank = int(sys.argv[1])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="tcp://localhost:{port}", world_size=4,
                            rank=rank)
    try:
        make_mesh(particle=2, replica=1, kind="dist", device="cpu")
    except ValueError as err:
        print("refused:", err)
    st = torch.load({state!r}, weights_only=False)
    cfg = config_from_density(**{kw!r})
    mesh = make_mesh(particle=2, replica=2, kind="dist", device="cpu")
    fn = psp.make_ensemble_spatial_step_fn(cfg, mesh, comm="half_ring")
    c, _ = fn.init(psp.shard_replica_states(st, mesh, cfg))
    for _ in range(2):
        c, obs = fn(c)
    whole = psp.gather_replica_states(c, mesh)
    torch.save({{"shard": c[0], "whole": whole, "obs": obs}}, {out!r}.format(rank))
    dist.destroy_process_group()
""")


def test_dist_mesh_replica_rows_match_thread_mesh(tmp_path):
    """Two replica x particle steps on 4 gloo processes (DistMesh, replica=2:
    a process group a row) == the same steps on a (2, 2) ThreadMesh, bit for
    bit: each rank's shard, the gathered states and the observables; the
    processes refuse a mesh of another size first."""
    st = _state(_fluids(KW, 8))
    cfg = config_from_density(**KW)
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
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    assert all("refused: mesh needs 2 ranks" in out for out in outs), outs

    mesh = make_mesh(particle=2, replica=2, device="cpu")
    try:
        fn = psp.make_ensemble_spatial_step_fn(cfg, mesh, comm="half_ring")
        c, _ = fn.init(psp.shard_replica_states(st, mesh, cfg))
        for _ in range(2):
            c, obs = fn(c)
        whole = psp.gather_replica_states(c, mesh)
    finally:
        mesh.close()
    for g in range(4):
        got = torch.load(str(tmp_path / f"rank{g}.pt"), weights_only=False)
        for f in FIELDS:
            assert torch.equal(getattr(got["shard"], f), getattr(c[g], f)), (g, f)
            assert torch.equal(getattr(got["whole"], f), getattr(whole, f)), (g, f)
        for f in ("epot", "ekin", "d_epot", "dd_epot"):
            assert torch.equal(getattr(got["obs"], f), getattr(obs, f)), (g, f)
