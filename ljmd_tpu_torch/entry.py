"""The flagship single-step entry point (counterpart of
``__graft_entry__.py:20-58``).

``entry(device="cuda")`` returns ``(fn, example_args)``: ``fn(r, ru, v, a)``
is one velocity-Verlet step of the flagship config (N = 4000 at rho* = 0.8442,
rc = 2.5, dt = 0.005, float32) through ``make_force_fn(cfg, "auto")`` (on the
card the ordered-sweep kernel, ``csrc/pair_sweep.cu``; on the CPU the dense
oracle) and returns the new (r, ru, v, a) and the step's epot, ekin, d_epot,
dd_epot. It computes in the dtype of the tensors it is given.

The JAX module's ``dryrun_multichip`` (the sharded production step on a
device mesh) waits for the multi-device slice of the port (ROADMAP.md Open
items §1.11); it has no counterpart here yet.
"""

from __future__ import annotations

import torch

from ljmd_tpu_torch.config import SimConfig, config_from_density
from ljmd_tpu_torch.models.forces import make_force_fn, resolve_device
from ljmd_tpu_torch.models.integrators import velocity_verlet_step
from ljmd_tpu_torch.models.lattice import fcc_lattice, random_velocities, remove_com_velocity
from ljmd_tpu_torch.state import MDState

__all__ = ["entry", "flagship_cfg"]


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
