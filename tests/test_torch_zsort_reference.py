"""The zsort engine as ``make_engine`` / ``make_replica_engine`` build it for
a state (the sort skin sized from the state's kinetic temperature) against
the benchmark's plain reference (``ljbench/reference/lj.py``), on the CPU in
float64, one system and an R=3 stack.

The box is the smallest FCC box the zsort geometry takes at rho* 0.8442 and
rc 2.5: N=864 (k=6), L = 10.08 > 4 rc. The state is the lattice with small
random displacements and Maxwell velocities at T ~0.84, so no warmup runs.
Several chunks of 16 steps and a ``run_sample`` advance it; the reference
then works out forces, U and P from the port's final positions and runs the
same steps from the first state.

Tolerances (relative, each over its scale): 1e-10. Both sides sum the same
pairs in float64 in other orders (~1e-14 apart over ~24,000 pairs), and 48
steps grow a difference of that size by a few times at most. A float32 pair
sum is ~1e-7 off, and the tests show the float32 reference failing the
force tolerance.

The planted fast particle: v_z = 8 in that fluid (the JAX skin's rule
assumes v_max ~4.4) travels ~0.48 along z in a chunk, past the JAX skin's
invalid bound (0.6 x 0.68 = 0.408), so an engine with the JAX geometry sets
``zsort_invalid``; the skin sized from the state's temperature keeps it
clear, and the forces still match the reference.
"""

import json
import math
from pathlib import Path

import pytest
import torch

from ljbench.reference import lj
from ljbench.spec import load_cell
from ljmd_tpu_torch.config import config_from_density
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.lattice import fcc_lattice, remove_com_velocity
from ljmd_tpu_torch.state import MDState, StepObs

torch.set_num_threads(1)

TOL = 1e-10
CHUNK = 16
FAST_VZ = 8.0


def _cfg():
    return config_from_density(num_cells=6, density=0.8442, dt=0.005, dtype="float64",
                               total_steps=100, output_interval=50, warmup_steps=0,
                               target_total_energy=-4050.0)


def _states(cfg, replicas, seed=23):
    """(R, N, 3) perturbed-lattice states at T ~0.84, one generator draw
    each."""
    g = torch.Generator().manual_seed(seed)
    lat = fcc_lattice(cfg.num_cells, cfg.box_length, dtype=torch.float64, device="cpu")
    r = torch.stack([(lat + 0.05 * torch.randn(lat.shape, generator=g, dtype=torch.float64))
                     % cfg.box_length for _ in range(replicas)])
    v = remove_com_velocity(math.sqrt(0.84) * torch.randn(r.shape, generator=g,
                                                          dtype=torch.float64))
    return MDState(r=r, ru=r, v=v, a=torch.zeros_like(r))


def _force_err(acc, r, cfg, pair_dtype=None):
    """max |a - F_ref| / rms |F_ref| of (R, N, 3) accelerations at r."""
    ref, _, _, _ = lj.forces(r, lj.pair_list(r, cfg.box_length, cfg.rc), cfg.box_length,
                             cfg.rc, cfg.volume, cfg.use_tail_corrections, pair_dtype)
    rms = float(torch.sqrt((ref * ref).sum(dim=-1).mean()))
    return float((acc - ref).norm(dim=-1).max()) / rms


def _check_against_reference(cfg, start: MDState, end: MDState, obs, steps):
    """Forces, U, K, P and the advance of (R, N, 3) states against the
    reference."""
    r, v = end.r, end.v
    assert _force_err(end.a, r, cfg) < TOL
    acc, epot, d_epot, _ = lj.forces(r, lj.pair_list(r, cfg.box_length, cfg.rc),
                                     cfg.box_length, cfg.rc, cfg.volume,
                                     cfg.use_tail_corrections)
    ref = lj.observables(epot, d_epot, v, cfg.volume)
    n, vol = cfg.n, cfg.volume
    temp = 2.0 * obs.ekin / (3.0 * n)
    press = (n / vol) * temp - obs.d_epot / (3.0 * vol)
    scale_p = (n / vol) * ref[:, 3] + d_epot.abs() / (3.0 * vol)
    assert float(((obs.epot - ref[:, 0]) / ref[:, 0].abs()).abs().max()) < TOL
    assert float(((obs.ekin - ref[:, 1]) / ref[:, 1]).abs().max()) < TOL
    assert float(((press - ref[:, 4]) / scale_p).abs().max()) < TOL
    r_ref, v_ref, _ = lj.advance(start.r, start.v, steps, cfg.box_length, cfg.rc, cfg.dt,
                                 cfg.volume, tail=cfg.use_tail_corrections)
    dr = lj.minimum_image(r - r_ref, cfg.box_length)
    moved = lj.minimum_image(r_ref - start.r, cfg.box_length)
    assert float(dr.norm(dim=-1).max()) / float(moved.norm(dim=-1).pow(2).mean().sqrt()) < TOL
    assert float((v - v_ref).norm(dim=-1).max()) / float(v_ref.norm(dim=-1).max()) < TOL


def _run(eng, state):
    c, _ = eng.init(state)
    c = eng.run_fast(c, 2 * CHUNK)
    c, obs = eng.run_sample(c, CHUNK)
    return c, obs


def test_one_system_engine_matches_the_reference():
    """``make_engine(cfg, "zsort", state=...)``: two chunks and a sampled
    chunk, its forces, U, K, P and advance within 1e-10 of the reference;
    the skin is the travel skin, past the JAX one, and no flag is set. The
    float32 reference's forces fail the tolerance."""
    cfg = _cfg()
    states = _states(cfg, 1)
    state = pe.replica_state(states, 0)
    temp = pe.kinetic_temperature(state)
    geo = pe.zsort_geometry(cfg, CHUNK, temperature=temp)
    assert geo.sort_skin == pytest.approx(pe.zsort_travel_skin(temp, CHUNK, cfg.dt))
    assert geo.sort_skin > pe.zsort_geometry(cfg, CHUNK).sort_skin
    eng = pe.make_engine(cfg, "zsort", "cpu", state=state)
    c, obs = _run(eng, state)
    assert not bool(eng.diagnostics(c)["zsort_invalid"])
    end = eng.get_state(c)
    stack = MDState(r=end.r[None], ru=end.ru[None], v=end.v[None], a=end.a[None])
    obs = StepObs(epot=obs.epot.reshape(1), ekin=obs.ekin.reshape(1),
                  d_epot=obs.d_epot.reshape(1), dd_epot=obs.dd_epot.reshape(1))
    _check_against_reference(cfg, states, stack, obs, 3 * CHUNK)
    assert _force_err(end.a[None], end.r[None], cfg, torch.float32) > 10 * TOL


def test_replica_engine_matches_the_reference():
    """``make_replica_engine(cfg, 3, "zsort", states=...)``: the same
    chunks over the stack, each replica within 1e-10 of the reference; the
    skin comes from the hottest replica."""
    cfg = _cfg()
    states = _states(cfg, 3, seed=29)
    eng = pe.make_replica_engine(cfg, 3, "zsort", "cpu", states=states)
    c, obs = _run(eng, states)
    assert not bool(eng.diagnostics(c)["zsort_invalid"].any())
    temps = [pe.kinetic_temperature(pe.replica_state(states, q)) for q in range(3)]
    assert pe.kinetic_temperature(states) == pytest.approx(max(temps), rel=1e-14)
    _check_against_reference(cfg, states, eng.get_state(c), obs, 3 * CHUNK)


def test_planted_fast_particle_flags_only_under_the_jax_skin():
    """A particle at v_z = 8: the JAX geometry (no temperature: the skin of
    ``8.5 x chunk x dt``) sets ``zsort_invalid`` and reads a travel share
    past 1; the engine built for the state keeps it clear, with a share
    under 1, and its forces match the reference."""
    cfg = _cfg()
    states = _states(cfg, 1)
    v = states.v.clone()
    v[0, 0] = torch.tensor([0.0, 0.0, FAST_VZ], dtype=torch.float64)
    states = MDState(r=states.r, ru=states.ru, v=v, a=states.a)
    state = pe.replica_state(states, 0)
    shares = {}
    for name, eng in (("jax", pe._zsort_engine(cfg, "cpu")),
                      ("state", pe.make_engine(cfg, "zsort", "cpu", state=state))):
        c, _ = eng.init(state)
        c = eng.run_fast(c, 2 * CHUNK)
        shares[name] = float(eng.counters(c)["zsort_travel_share"])
        assert bool(eng.diagnostics(c)["zsort_invalid"]) == (name == "jax")
        end = eng.get_state(c)
        assert _force_err(end.a[None], end.r[None], cfg) < TOL
    assert shares["jax"] > 1.0 > shares["state"]


def test_config3_cells_run_the_published_configuration_on_zsort():
    """The benchmark's config-3 file holds ``examples/n4000_production.json``
    but for the keys ``BENCHMARK.json`` lists as reduced (and the seed each
    run's --seed replaces); ``auto`` on the card routes both cells to the
    zsort engine, whose "always" skin a T 0.84 state sizes past the JAX
    one."""
    root = Path(__file__).resolve().parent.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "bl3_n4000_f32")
    mine = json.loads((root / entry["file"]).read_text())
    theirs = json.loads((root / "examples" / "n4000_production.json").read_text())
    for key, value in theirs.items():
        if key not in entry["reduced"] and key != "seed":
            assert mine[key] == value, key
    for cell in ("n4000.r64.i50", "n4000.single.i50"):
        cfg = load_cell(cell, 2 ** 31 + 99).cfg
        assert cfg.n == 4000 and cfg.output_interval == 50 and cfg.dtype == "float32"
        assert pe.auto_backend(cfg, True, cfg.output_interval) == "zsort"
        jax_skin = pe.zsort_geometry(cfg, CHUNK).sort_skin
        assert jax_skin == pytest.approx(0.68)
        assert pe.zsort_geometry(cfg, CHUNK, temperature=0.84).sort_skin > 1.3 * jax_skin
