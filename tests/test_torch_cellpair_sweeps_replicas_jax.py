"""The batched cell-pair engine's full sweeps and unfused chunk
(``_cellpair_engine(..., replicas=R)`` with ``half_shell=False``,
``z_band=True`` or ``use_fused=False``) against ``jax.vmap`` of the JAX
package's ``_cellpair_engine`` (interpret mode), float64 on the CPU with one
thread: init and a few steps at tests/test_torch_cellpair.py's tolerances
(trajectories rtol 1e-9 / atol 1e-10, accelerations 1e-8, the observables
rel 1e-9; counts and window tables exactly). Each variant's JAX engine
compiles its interpreted sweep once for init and once for a chunk (about
15 s each for the z-band at capacity 512), so this file stands apart from
the bit-for-bit engine tests.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu.models.engine import _cellpair_engine as j_cellpair_engine
from ljmd_tpu.models.simulation import initialize as j_initialize
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.utils import convert

torch.set_num_threads(1)

R = 2
FIELDS = ("r", "ru", "v", "a")
OBS = ("epot", "ekin", "d_epot", "dd_epot")


def _port_cfg(jcfg) -> SimConfig:
    return SimConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(jcfg) if f.init})


def _jcfg(**kw):
    base = dict(num_cells=5, density=0.66, dt=0.002, dtype="float64", neighbor_skin=0.3,
                total_steps=60, output_interval=10, warmup_steps=10,
                target_total_energy=-2000.0)
    base.update(kw)
    return config_from_density(**base)


# (variant, capacity, inner chunk, run_fast steps). JAX's interpreted
# sweeps compile slowly at capacity 512, so the z-band runs init and one
# 1-step chunk (a z-ordered rebin and new windows first).
JAX_CASES = {
    "full9": (dict(half_shell=False), 0, 2, 2),
    "zband": (dict(z_band=True), 512, 1, 1),
    "unfused": (dict(use_fused=False), 0, 3, 3),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_batched_variants_match_vmapped_jax_engine(name):
    """init, run_fast and (full sweeps, unfused) a sampled step of the
    batched engine against jax.vmap of the JAX engine's from JAX's vmapped
    initial states."""
    kw, cap, chunk, n_steps = JAX_CASES[name]
    jcfg = _jcfg(neighbor_capacity=cap, seed=2)
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed), R)
    jstates = jax.jit(jax.vmap(lambda k: j_initialize(jcfg, k, backend="dense")))(keys)
    states = convert.state_from_numpy({k: np.asarray(getattr(jstates, k)) for k in FIELDS})
    je = j_cellpair_engine(jcfg, interpret=True, inner_chunk=chunk, **kw)
    peng = pe._cellpair_engine(_port_cfg(jcfg), "cpu", replicas=R, inner_chunk=chunk, **kw)

    def close(pc, jc):
        got, want = peng.get_state(pc), jax.vmap(je.get_state)(jc)
        for k in FIELDS:
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                       rtol=1e-9, atol=1e-8 if k == "a" else 1e-10, err_msg=k)
        arrays = convert.pencil_replicas_to_numpy(pc, R)
        for k in ("counts", "win_a", "win_b", "use_b", "overflow"):
            np.testing.assert_array_equal(arrays[k], np.asarray(getattr(jc, k)), k)

    jc, jo = jax.jit(jax.vmap(je.init))(jstates)
    pc, po = peng.init(states)
    for k in OBS:
        np.testing.assert_allclose(getattr(po, k).numpy(), np.asarray(getattr(jo, k)),
                                   rtol=1e-9, err_msg=k)
    close(pc, jc)
    assert bool((pc.use_b > 0).any()) == (name == "zband")
    jc = jax.jit(jax.vmap(lambda c: je.run_fast(c, n_steps)))(jc)
    pc = peng.run_fast(pc, n_steps)
    close(pc, jc)
    if name == "zband":
        return
    jc, jo = jax.jit(jax.vmap(je.step))(jc)
    pc, po = peng.step(pc)
    for k in OBS:
        np.testing.assert_allclose(getattr(po, k).numpy(), np.asarray(getattr(jo, k)),
                                   rtol=1e-9, err_msg=k)
    close(pc, jc)
