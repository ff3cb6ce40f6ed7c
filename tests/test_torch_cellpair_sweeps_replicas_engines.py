"""The batched cell-pair engine's full sweeps and unfused chunk
(``_cellpair_engine(..., replicas=R)`` with ``half_shell=False``,
``z_band=True`` or ``use_fused=False``) against one-system engines, float64
on the CPU with one thread: replica q of the three variants against the
one-system engine at the same capacity, bit for bit (rows, counts, window
tables, flag, state, observables), with a step on which only one replica
rebins, the unfused chunk's default length from the stack's fastest
replica, and a NaN that stays in its replica. (The kernels over the stack:
tests/test_torch_cellpair_sweeps_replicas.py; the engines against JAX's:
tests/test_torch_cellpair_sweeps_replicas_jax.py.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from ljmd_tpu.config import config_from_density
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models import simulation as psim
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


@pytest.fixture(scope="module")
def small():
    """tests/test_torch_cellpair_replicas.py's R=2 states (the second
    replica 1.5x hotter) and their census capacity."""
    cfg = _port_cfg(_jcfg())
    states = psim.initialize_replicas(cfg, psim.replica_generators(4, R), backend="dense",
                                      device="cpu")
    hotter = torch.tensor([1.0, 1.5], dtype=states.v.dtype)[:, None, None]
    states = dataclasses.replace(states, v=states.v * hotter)
    return cfg, states, pe.replica_capacity(cfg, states)


# (engine options, capacity: None = the census) of each variant; the
# z-band needs capacity 512 to be live in this box.
VARIANTS = {
    "full9": (dict(half_shell=False), None),
    "zband": (dict(z_band=True), 512),
    "unfused": (dict(use_fused=False), None),
    "unfused_predictive": (dict(use_fused=False, compensated=True), None),
}


def _same(c, ones, obs=None, one_obs=None):
    got = convert.pencil_replicas_to_numpy(c, R)
    for q, cq in enumerate(ones):
        for k in convert.PENCIL_REPLICA_FIELDS:
            assert np.array_equal(got[k][q], getattr(cq, k).numpy()), (q, k)
    if obs is not None:
        for q, oq in enumerate(one_obs):
            for k in OBS:
                assert torch.equal(getattr(obs, k)[q], getattr(oq, k)), (q, k)


def _variant(small, name):
    cfg, states, census = small
    kw, cap = VARIANTS[name]
    return cfg.replace(neighbor_capacity=cap or census), states, kw


class OneSystem:
    """One-system engines of a variant; ``pinned(ones)`` is the one whose
    ``inner_chunk`` is the length the batched engine takes for the stack of
    the carries ``ones``: ``chunk_from_speed`` of the fastest replica's top
    speed over the drift rows (xy; z-band: xyz) against half the slack."""

    def __init__(self, cfg, name, kw):
        self.cfg, self.kw, self.engines = cfg, kw, {}
        self.compensated = kw.get("compensated", False)
        if name == "zband":
            self.rows, self.slack = slice(0, 3), cfg.neighbor_skin
        else:
            grid = pe.make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                       cfg.density, cfg.neighbor_capacity)
            self.rows, self.slack = slice(0, 2), grid.pencil_width - cfg.rc
        self.plain = self.get(None)

    def get(self, k):
        if k not in self.engines:
            self.engines[k] = pe._cellpair_engine(self.cfg, "cpu", inner_chunk=k, **self.kw)
        return self.engines[k]

    def pinned(self, ones):
        top = 0.0
        for c in ones:
            v = (c.v + c.vc if self.compensated else c.v)[self.rows]
            speed = float(torch.sqrt(torch.max(torch.sum(v * v, dim=0))))
            top = max(top, speed) if np.isfinite(speed) else top
        return self.get(pe.chunk_from_speed(self.cfg.dt, 0.5 * self.slack, top,
                                            pe.UNFUSED_MAX_CHUNK))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_batched_variants_equal_one_system(small, name):
    """init, run_fast (8 steps, then 3), step after each: replica q is the
    one-system engine's bit for bit. The batched run takes its unfused
    chunk from the stack's fastest replica (one host read a run): the
    one-system engines get that length as ``inner_chunk``."""
    cfg, states, kw = _variant(small, name)
    eng = pe._cellpair_engine(cfg, "cpu", replicas=R, **kw)
    one = OneSystem(cfg, name, kw)
    c, obs = eng.init(states)
    pairs = [one.plain.init(pe.replica_state(states, q)) for q in range(R)]
    ones = [p[0] for p in pairs]
    _same(c, ones, obs, [p[1] for p in pairs])
    assert eng.run_fast.__name__ == "run_fast_unfused"
    for n_fast in (8, 3):
        reads = pe.HOST_READS["cellpair_chunk"]
        c = eng.run_fast(c, n_fast)
        assert pe.HOST_READS["cellpair_chunk"] == reads + 1
        pinned = one.pinned(ones)
        ones = [pinned.run_fast(cq, n_fast) for cq in ones]
        _same(c, ones)
        c, obs = eng.step(c)
        pairs = [one.plain.step(cq) for cq in ones]
        ones = [p[0] for p in pairs]
        _same(c, ones, obs, [p[1] for p in pairs])
    got = eng.get_state(c)
    for q in range(R):
        want = one.plain.get_state(ones[q])
        for f in FIELDS:
            assert torch.equal(getattr(got, f)[q], getattr(want, f)), (q, f)
    # In this short box a slice's z margin wraps at both faces, which the
    # window flag raises for both replicas (as in JAX); elsewhere no flag.
    assert eng.diagnostics(c)["pencil_overflow"].tolist() == [name == "zband"] * R


@pytest.mark.parametrize("name", ["full9", "zband"])
def test_moved_rebin_for_one_replica(small, name):
    """The sampled step's "moved" check fires for replica 1 alone: replica
    1 is rebinned (z-band: new window tables), replica 0 keeps its bins and
    tables, each bit for bit as its one-system engine; a NaN in replica 1
    then stays there through an unfused chunk (its length comes from
    replica 0, the stack's only finite one)."""
    cfg, states, kw = _variant(small, name)
    eng = pe._cellpair_engine(cfg, "cpu", replicas=R, **kw)
    one = OneSystem(cfg, name, kw)
    c, _ = eng.init(states)
    ones = [one.plain.init(pe.replica_state(states, q))[0] for q in range(R)]
    ns = ones[0].r.shape[1]
    shift = torch.zeros_like(c.r)
    shift[0, ns:] = 0.3 * c.r[3, ns:]
    c = dataclasses.replace(c, r=c.r + shift)
    ones[1] = dataclasses.replace(ones[1], r=ones[1].r + shift[:, ns:])
    reads = pe.HOST_READS["cellpair_moved"]
    c2, _ = eng.step(c)
    assert pe.HOST_READS["cellpair_moved"] == reads + 1
    ones2 = [one.plain.step(cq)[0] for cq in ones]
    _same(c2, ones2)
    assert torch.equal(c2.r_ref[:, :ns], c.r_ref[:, :ns])
    assert not torch.equal(c2.r_ref[:, ns:], c.r_ref[:, ns:])
    v = c2.v.clone()
    v[0, ns + 5] = float("nan")
    c3 = eng.run_fast(dataclasses.replace(c2, v=v), 6)
    c3, obs = eng.step(c3)
    o0, oo = one.plain.step(one.pinned(ones2[:1]).run_fast(ones2[0], 6))
    got = convert.pencil_replicas_to_numpy(c3, R)
    for f in convert.PENCIL_REPLICA_FIELDS:
        assert np.array_equal(got[f][0], getattr(o0, f).numpy()), f
    assert torch.equal(obs.epot[0], oo.epot) and not bool(torch.isfinite(obs.ekin[1]))
