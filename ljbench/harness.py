"""One run of one cell: set-up, the timed window, and the check.

The window drives the port's production loop as ``run_production`` builds
it (``ljmd_tpu_torch.models.simulation``):

- set-up: ``initialize`` (or ``initialize_replicas`` over
  ``replica_generators(seed, R)``), the engine ``make_engine(cfg, "auto",
  state=..., sample_interval=interval)`` (``make_replica_engine`` for R > 1),
  ``engine.init``, the prologue, and one untimed ``sample_cycle`` that warms
  the cell's shapes;
- the window: ``sample_cycle`` back to back until ``seconds`` have passed
  on the host clock, then one synchronize. A CUDA event is recorded at
  every cycle boundary (no synchronize); nothing else is added;
- after it: the peak memory is read, ``finalize`` runs, and the check
  (``check.py``) compares the last cycle and one cycle drawn from the seed
  with the plain reference, once the port's state is freed.

A traced run profiles a stretch of whole cycles at the window's start, at
most ``TRACE_SECONDS`` and ``TRACE_CYCLES``, inside ``record_function``
spans around ``sample_cycle`` and around each engine call it makes; it
synchronizes at the stretch's end and runs the rest of the window without
the profiler.
"""

from __future__ import annotations

import contextlib
import random
import time

import torch

from ljmd_tpu_torch.models.engine import (
    HOST_READS,
    auto_backend,
    make_engine,
    make_replica_engine,
)
from ljmd_tpu_torch.models.simulation import (
    _advance,
    finalize,
    initialize,
    initialize_replicas,
    replica_generators,
    sample_cycle,
)
from ljmd_tpu_torch.ops._cuda import LAUNCHES
from ljmd_tpu_torch.stats.moments import means_init

from ljbench import check
from ljbench.spec import Cell

TRACE_SECONDS = 2.0
TRACE_CYCLES = 400
ENGINE_CALLS = ("step", "step_fast", "run_fast", "run_sample")


def _spanned(engine):
    """The engine with each call inside a ``record_function`` span."""
    from torch.profiler import record_function

    def wrap(name, fn):
        def call(*args):
            with record_function(f"ljbench.engine.{name}"):
                return fn(*args)
        return call

    return engine._replace(**{k: wrap(k, getattr(engine, k)) for k in ENGINE_CALLS
                              if getattr(engine, k) is not None})


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def setup(cell: Cell, device) -> dict:
    """The engine, its carry after the prologue and the warm cycle, the
    means accumulator and the warm cycle's column."""
    cfg, reps = cell.cfg, cell.replicas
    interval = cfg.output_interval
    if reps == 1:
        state = initialize(cfg, device=device)
        engine = make_engine(cfg, "auto", device, state=state, sample_interval=interval)
    else:
        state = initialize_replicas(cfg, replica_generators(cfg.seed, reps), device=device)
        engine = make_replica_engine(cfg, reps, "auto", device, states=state,
                                     sample_interval=interval)
    carry, _ = engine.init(state)
    del state
    prologue = (cfg.warmup_steps // interval) * interval
    carry, _ = _advance(engine, carry, prologue, want_obs=False)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    acc = means_init(dtype=dtype, device=device, batch=(reps,) if reps > 1 else ())
    carry, acc, col = sample_cycle(engine, cfg, carry, acc)
    _sync(device)
    return {"engine": engine, "carry": carry, "acc": acc, "cols": [col], "prologue": prologue,
            "backend": auto_backend(cfg, device.type == "cuda", interval)}


def window(cell: Cell, run: dict, seconds: float, seed: int, trace: bool, device) -> dict:
    """Run sample cycles for ``seconds``; keep what the check and the
    metrics read."""
    cfg = cell.cfg
    engine, carry, acc, cols = run["engine"], run["carry"], run["acc"], run["cols"]
    pick = random.Random(seed)
    sampled = None
    prof = None
    stretch = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        engine = _spanned(engine)
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        span = lambda: record_function("ljbench.sample_cycle")  # noqa: E731
    else:
        span = contextlib.nullcontext
    stretch_start = carry
    launches0, reads0 = LAUNCHES.snapshot(), dict(HOST_READS)
    t0 = time.perf_counter()
    events = [_event(device)]
    k = 0
    while True:
        prev = carry
        with span():
            carry, acc, col = sample_cycle(engine, cfg, carry, acc)
        cols.append(col)
        events.append(_event(device))
        k += 1
        if pick.random() * k < 1.0:
            sampled = (prev, carry, col)
        elapsed = time.perf_counter() - t0
        if prof is not None and (elapsed >= TRACE_SECONDS or k >= TRACE_CYCLES):
            _sync(device)
            stretch = {"cycles": k, "wall_s": time.perf_counter() - t0, "start": stretch_start,
                       "end": carry, "profile": prof}
            prof.stop()
            prof = None
            span = contextlib.nullcontext
            engine = run["engine"]
        if elapsed >= seconds and prof is None:
            break
    _sync(device)
    wall = time.perf_counter() - t0
    return {"t0": t0, "cycles": k, "wall_s": wall, "carry": carry, "prev": prev, "acc": acc,
            "cols": cols, "sampled": sampled, "events": events, "stretch": stretch,
            "launches": {n: c - launches0[n] for n, c in LAUNCHES.snapshot().items()
                         if c != launches0[n]},
            "host_reads": {n: c - reads0[n] for n, c in HOST_READS.items() if c != reads0[n]}}


def cycle_ms(events) -> list:
    """Device-timeline durations (ms) between consecutive boundary events."""
    if events[0] is None:
        return []
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def check_inputs(cell: Cell, run: dict, win: dict) -> dict:
    """After the window: ``finalize`` over the window's samples (the warm
    cycle's first), the checked cycles' states, the flags and the stretch's
    states, all detached from the engine."""
    cfg, reps = cell.cfg, cell.replicas
    engine = run["engine"]
    samples = len(win["cols"])
    done = cfg.replace(total_steps=run["prologue"] + samples * cfg.output_interval)
    series = torch.stack(win["cols"], dim=-1)
    result = finalize(done, engine, win["carry"], series, win["acc"], None)

    def state(c):
        s = engine.get_state(c)
        return tuple(x.reshape(reps, -1, 3) for x in (s.r, s.v, s.a))

    picked = [(win["prev"], win["carry"], win["cols"][-1])]
    if win["sampled"] is not None and win["sampled"][1] is not win["carry"]:
        picked.append(win["sampled"])
    cycles = []
    for c0, c1, col in picked:
        r0, v0, _ = state(c0)
        r1, v1, a1 = state(c1)
        cycles.append(check.Cycle(r0=r0, v0=v0, r1=r1, v1=v1, a1=a1, col=col.reshape(reps, 5)))
    flags_set = {k: int(torch.as_tensor(x).sum()) for k, x in result.diagnostics.items()}
    counted = result.means.count.reshape(-1)
    out = {"cycles": cycles, "series": series.reshape(reps, 5, samples),
           "means": result.means.means.reshape(reps, -1)[:, :5],
           "flags": sum(flags_set.values()), "flags_set": flags_set,
           "mean_temp": float(result.means.means.reshape(reps, -1)[:, 3].mean()),
           "samples_gap": int((counted - samples).abs().max()),
           "failed_samples": int((~torch.isfinite(series.reshape(reps, 5, samples)[..., 1:]))
                                 .any(dim=1).sum())}
    if win["stretch"] is not None:
        out["stretch_r"] = [state(win["stretch"][k])[0] for k in ("start", "end")]
    return out


def run_cell(cell: Cell, seconds: float, seed: int, trace: bool, device="cuda") -> dict:
    """Set up, run the window, and read everything a result line needs
    (``run.py`` prints it)."""
    device = torch.device(device)
    t_setup = time.perf_counter()
    run = setup(cell, device)
    setup_in_process = time.perf_counter() - t_setup
    win = window(cell, run, seconds, seed, trace, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    inputs = check_inputs(cell, run, win)
    ms = cycle_ms(win["events"])
    stretch = win["stretch"]
    traced = None
    if stretch is not None:
        from ljbench.trace import read_stretch

        traced = read_stretch(stretch["profile"].events())
        traced.update(cycles=stretch["cycles"], wall_s=stretch["wall_s"],
                      steps=stretch["cycles"] * cell.cfg.output_interval)
    out = {"cycles": win["cycles"], "wall_s": win["wall_s"], "cycle_ms": ms,
           "steps": win["cycles"] * cell.cfg.output_interval, "peak_bytes": peak,
           "launches": win["launches"], "host_reads": win["host_reads"],
           "backend": run["backend"], "setup_in_process_s": setup_in_process,
           "window_t0": win["t0"], "traced": traced}
    del run, win, stretch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"] = check.readings(inputs["cycles"], inputs["means"], inputs["series"],
                                    inputs["flags"], inputs["samples_gap"], cell.cfg)
    out["failed_samples"] = inputs["failed_samples"]
    out["flags_set"], out["mean_temp"] = inputs["flags_set"], inputs["mean_temp"]
    out["checked_cycles"] = len(inputs["cycles"])
    if "stretch_r" in inputs:
        from ljbench.reference import lj

        counts = [lj.count_pairs(r.double(), cell.cfg.box_length, cell.cfg.rc)
                  for r in inputs["stretch_r"]]
        out["traced"]["pairs"] = float(sum(c.sum() for c in counts)) / 2.0
    return out
