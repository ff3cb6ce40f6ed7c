"""The check against faults planted under a run, and against the control,
on the CPU at a test size: the harness's run of a cell (set-up, window,
finalize, check) with its look for a card skipped, the engine's plain
twins in place of the kernels."""

import dataclasses

import pytest
import torch

from ljbench import check, harness
from ljbench.reference import lj
from ljbench.spec import Cell, load_limits
from ljmd_tpu_torch.config import SimConfig
from ljmd_tpu_torch.ops.lj import tail_corrections

# The cell whose limits the test-size runs are held to.
LIMITS = "n62500.single.i2"


def tiny_cell(replicas: int, seed: int) -> Cell:
    k, rho = 4, 0.8442
    box = (4 * k ** 3 / rho) ** (1.0 / 3.0)
    cfg = SimConfig(num_cells=k, box_length=box, rc_over_box=2.5 / box, dt=0.005,
                    total_steps=1000, output_interval=5, warmup_steps=20,
                    target_total_energy=-1100.0, dtype="float32", seed=seed)
    return Cell(name="tiny", cfg=cfg, replicas=replicas, chips=1, end_to_end=(), per_layer=(),
                limits=load_limits(LIMITS))


def verdict(cell: Cell, seconds: float = 0.4):
    torch.set_num_threads(2)
    out = harness.run_cell(cell, seconds, cell.cfg.seed, False, device="cpu")
    ok, over = check.verdict(out["numbers"], cell.limits)
    return ok and out["failed_samples"] == 0, over, out


def planted(monkeypatch, fault):
    """Make the harness's engine factories return engines with ``fault``
    applied to every carry and observable they produce."""
    for name in ("make_engine", "make_replica_engine"):
        real = getattr(harness, name)

        def factory(*args, _real=real, **kwargs):
            eng = _real(*args, **kwargs)
            return eng._replace(**{k: fault(getattr(eng, k), k) for k in harness.ENGINE_CALLS
                                   if getattr(eng, k) is not None})

        monkeypatch.setattr(harness, name, factory)


def on_carries(transform):
    """A fault that replaces every carry an engine call returns by
    ``transform(new, old)``, its observables left real."""
    def fault(fn, kind):
        def call(c, *n):
            out = fn(c, *n)
            if kind == "run_fast":
                return transform(out, c)
            return transform(out[0], c), out[1]
        return call
    return fault


def _half_the_replicas(new, old):
    r = new.r.shape[0]
    keep = (torch.arange(r) < r // 2).reshape(r, 1, 1)
    return dataclasses.replace(new, **{f.name: torch.where(keep, getattr(new, f.name),
                                                             getattr(old, f.name))
                                       for f in dataclasses.fields(new)})


def _half_the_forces(new, old):
    a = new.a.clone()
    a[..., 0:3, a.shape[-1] // 2:] = 0.0
    return dataclasses.replace(new, a=a)


# A step that returns its state unchanged; replicas R/2.. left out (they keep
# their old state); the forces of half the particles left out.
unchanged = on_carries(lambda new, old: old)
half_the_replicas = on_carries(_half_the_replicas)
half_the_particles = on_carries(_half_the_forces)


def altered_energy(fn, kind):
    """The sampled potential energy altered where it is produced: its tail
    correction left out."""
    cfg = tiny_cell(1, 0).cfg
    e_tail = tail_corrections(cfg.n, cfg.volume, cfg.rc)[0]

    def alter(out):
        new, obs = out
        return new, dataclasses.replace(obs, epot=obs.epot - e_tail)

    if kind == "run_sample":
        return lambda c, n: alter(fn(c, n))
    if kind == "step":
        return lambda c: alter(fn(c))
    return fn


@pytest.mark.parametrize("replicas", [1, 3])
def test_sound_runs_are_correct(replicas):
    ok, over, out = verdict(tiny_cell(replicas, 20261018 + replicas))
    assert ok, (over, out["numbers"])
    assert out["checked_cycles"] in (1, 2) and out["cycles"] > 2


@pytest.mark.parametrize("fault, replicas, caught_by", [
    (unchanged, 1, "advance_err"),
    (unchanged, 3, "advance_err"),
    (half_the_replicas, 4, "advance_err"),
    (half_the_particles, 1, "force_err"),
    (altered_energy, 1, "obs_err"),
])
def test_planted_faults_make_the_run_incorrect(monkeypatch, fault, replicas, caught_by):
    planted(monkeypatch, fault)
    ok, over, out = verdict(tiny_cell(replicas, 4242))
    assert not ok
    assert caught_by in over, out["numbers"]


def test_control_reads_over_every_limit():
    """The reference in bfloat16 put in the port's place reads over the
    limit of every number it produces."""
    cell = tiny_cell(2, 99)
    device = torch.device("cpu")
    run = harness.setup(cell, device)
    win = harness.window(cell, run, 0.3, 99, False, device)
    inputs = harness.check_inputs(cell, run, win)
    cycles = [check.control_cycle(c, cell.cfg) for c in inputs["cycles"]]
    means = lj.means(inputs["series"].to(torch.bfloat16))
    numbers = check.readings(cycles, means, inputs["series"], 0, 0, cell.cfg)
    for name in ("force_err", "obs_err", "advance_err", "means_err"):
        assert numbers[name] > cell.limits[name], (name, numbers)
