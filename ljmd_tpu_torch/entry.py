"""The flagship single-step entry point (counterpart of
``__graft_entry__.py:20-58``).

``entry(device="cuda")`` returns ``(fn, example_args)``: ``fn(r, ru, v, a)``
is one velocity-Verlet step of the flagship config (N = 4000 at rho* = 0.8442,
rc = 2.5, dt = 0.005, float32) through ``make_force_fn(cfg, "auto")`` (on the
card the ordered-sweep kernel, ``csrc/pair_sweep.cu``; on the CPU the dense
oracle) and returns the new (r, ru, v, a) and the step's epot, ekin, d_epot,
dd_epot. It computes in the dtype of the tensors it is given.

``dryrun_multichip(n_devices, device="cuda", kind="thread")`` is the
counterpart of the JAX module's (``__graft_entry__.py:98-252``): it builds
rank meshes (``parallel/mesh.py``; ``kind="thread"``: ranks as threads on
one device, the counterpart of the JAX virtual CPU mesh; ``kind="dist"``:
one process per rank over an initialised ``torch.distributed`` group of
``n_devices``) and runs, on tiny shapes:

1. one sampled interval of the particle-sharded half-ring step
   (``parallel/spatial.py``, the kernels on a card) with the means
   accumulator updated: the JAX phase's replica x particle mesh waits for
   the ensemble's port (ROADMAP §1.7), so the step here is particle-only at
   the same config, on all n_devices ranks;
2. the sharded pencil engine (``parallel/spatial_pencil.py``) on 4, 2 or 1
   strips: a step, a fused 8-step ``run_fast``, a step;
3. the compensated spatial engine (float32 at dt = 1e-4) on 2 ranks: its
   carry holds the compensation terms; a 4-step ``run_fast`` and a step.

Each phase checks that its observables are finite and prints one line.
"""

from __future__ import annotations

import torch

from ljmd_tpu_torch.config import SimConfig, config_from_density
from ljmd_tpu_torch.models.forces import make_force_fn, resolve_device
from ljmd_tpu_torch.models.integrators import velocity_verlet_step
from ljmd_tpu_torch.models.lattice import fcc_lattice, random_velocities, remove_com_velocity
from ljmd_tpu_torch.state import MDState

__all__ = ["dryrun_multichip", "entry", "flagship_cfg"]


def flagship_cfg() -> SimConfig:
    """N = 4 * 10^3 = 4000 at the classic liquid state point (BASELINE
    config 3 scale), rc = 2.5 sigma."""
    return config_from_density(num_cells=10, density=0.8442, dt=0.005, dtype="float32",
                               total_steps=2000, output_interval=100, warmup_steps=200,
                               target_total_energy=-4000.0)


def entry(device="cuda"):
    """(fn, example_args) of the flagship step on ``device`` (default the
    card; raises where there is none). The example state is the FCC lattice
    with velocities uniform in [-0.5, 0.5) from ``torch.Generator`` seed 0
    (not JAX's numbers), the centre-of-mass motion removed, a = 0."""
    device = resolve_device(device)
    cfg = flagship_cfg()
    force_fn = make_force_fn(cfg, "auto", device)

    def fn(r, ru, v, a):
        new, obs = velocity_verlet_step(MDState(r=r, ru=ru, v=v, a=a), force_fn, cfg.dt,
                                        cfg.box_length)
        return new.r, new.ru, new.v, new.a, obs.epot, obs.ekin, obs.d_epot, obs.dd_epot

    r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float32, device=device)
    v = remove_com_velocity(random_velocities(torch.Generator().manual_seed(0), cfg.n,
                                              dtype=torch.float32, device=device))
    return fn, (r, r, v, torch.zeros_like(r))


def dryrun_multichip(n_devices: int, device="cuda", kind: str = "thread") -> None:
    """Run the three multi-device phases of the module docstring on meshes
    of up to ``n_devices`` ranks, on ``device`` (default the card; raises
    where there is none). Raises if an observable is not finite."""
    import torch.distributed as dist

    from ljmd_tpu_torch.parallel.mesh import make_mesh
    from ljmd_tpu_torch.parallel.spatial import (
        make_spatial_engine,
        make_spatial_step_fn,
        shard_state,
    )
    from ljmd_tpu_torch.parallel.spatial_pencil import make_sharded_pencil_engine
    from ljmd_tpu_torch.stats.moments import means_init, means_update

    device = resolve_device(device)
    if kind == "dist" and dist.get_world_size() != n_devices:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, "
                         f"asked for {n_devices}")

    def mesh_of(k: int):
        """A k-rank mesh, or None on a process outside it (kind="dist")."""
        if kind != "dist":
            return make_mesh(particle=k, device=device, kind=kind)
        group = None if k == n_devices else dist.new_group(list(range(k)))
        if dist.get_rank() >= k:
            return None
        return make_mesh(particle=k, device=device, kind="dist", group=group)

    def fluid(cfg, seed):
        r = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float32, device=device)
        v = remove_com_velocity(random_velocities(torch.Generator().manual_seed(seed), cfg.n,
                                                  dtype=torch.float32, device=device))
        return MDState(r=r, ru=r, v=v, a=torch.zeros_like(r))

    def finite(obs, what):
        if not (bool(torch.isfinite(obs.epot).all()) and bool(torch.isfinite(obs.ekin).all())):
            raise RuntimeError(f"non-finite observables in {what}: epot={obs.epot} "
                               f"ekin={obs.ekin}")

    # 1. One sampled interval of the half-ring step on every rank (N = 32).
    cfg = config_from_density(num_cells=2, density=0.7, dt=0.002, dtype="float32",
                              total_steps=8, output_interval=4, warmup_steps=0,
                              target_total_energy=-20.0)
    mesh = mesh_of(n_devices)
    try:
        step = make_spatial_step_fn(cfg, mesh, comm="half_ring")
        st = fluid(cfg, 0)
        st = MDState(st.r, st.ru, st.v, make_force_fn(cfg, "dense", device)(st.r).a)
        carry = shard_state(st, mesh, cfg)
        for _ in range(cfg.output_interval):
            carry, obs = step(carry)
        acc = means_update(means_init(torch.float32, device), obs, cfg.n, cfg.volume)
        finite(obs, "the half-ring step")
        if not bool(torch.isfinite(acc.moments).all()):
            raise RuntimeError("non-finite means accumulator in the half-ring dryrun")
        print(f"dryrun_multichip OK: half-ring on {n_devices} particle ranks ({kind} mesh, "
              f"{device}), N={cfg.n}, one interval of {cfg.output_interval} steps; "
              f"epot={float(obs.epot):.4f} ekin={float(obs.ekin):.4f}")
    finally:
        mesh.close()

    # 2. The sharded pencil engine: 4x4 pencils on 4, 2 or 1 strips (N = 256).
    pd = 4 if n_devices % 4 == 0 else (2 if n_devices % 2 == 0 else 1)
    cfg_p = config_from_density(num_cells=4, density=0.5, rc=1.4, dt=0.002, dtype="float32",
                                total_steps=8, output_interval=4, warmup_steps=0,
                                neighbor_skin=0.5, target_total_energy=-100.0)
    pmesh = mesh_of(pd)
    if pmesh is not None:
        try:
            eng = make_sharded_pencil_engine(cfg_p, pmesh)
            c, _ = eng.init(fluid(cfg_p, 1))
            c, _ = eng.step(c)
            c = eng.run_fast(c, 8)
            c, obs = eng.step(c)
            finite(obs, "the sharded-pencil dryrun")
            print(f"dryrun sharded-pencil OK (incl. fused 8-step chunk): {pd}-way pencil "
                  f"strips, N={cfg_p.n}; epot={float(obs.epot):.4f}")
        finally:
            pmesh.close()

    # 3. The compensated spatial engine: float32 at dt = 1e-4 (N = 32).
    cfg_c = config_from_density(num_cells=2, density=0.7, dt=1e-4, dtype="float32",
                                total_steps=8, output_interval=4, warmup_steps=0,
                                target_total_energy=-20.0)
    cmesh = mesh_of(2 if n_devices >= 2 else pd)
    if cmesh is not None:
        try:
            eng = make_spatial_engine(cfg_c, cmesh, comm="half_ring")
            c, _ = eng.init(fluid(cfg_c, 2))
            if not all(isinstance(x, tuple) and len(x) == 3 for x in c):
                raise RuntimeError("the dt=1e-4 float32 step must carry compensation terms")
            c = eng.run_fast(c, 4)
            c, obs = eng.step(c)
            finite(obs, "the compensated dryrun")
            print(f"dryrun compensated spatial OK (incl. fused 4-step chunk): "
                  f"epot={float(obs.epot):.4f}")
        finally:
            cmesh.close()
