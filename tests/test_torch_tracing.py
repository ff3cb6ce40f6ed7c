"""The program's spans (``ljmd_tpu_torch/utils/profiling.py`` ``span``) in
the sample cycle, the host-read counter behind them, the operator's span
table, and the benchmark's readers of the span tally, on the CPU.

A span records only while a torch profiler records: then it is a
function-scope record, nested under the caller's ``record_function`` spans,
and its host time adds to the tally. The engines are the port's cell-pair
engine on tests/test_cellpair.py's N=500 geometry (3 x 3 pencils, skin 0.3)
and its zsort engine on N=500 at rho* 0.8, both initialized by the port.
"""

import dataclasses
import math
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ljbench.spec import reader
from ljmd_tpu_torch.config import config_from_density
from ljmd_tpu_torch.models import engine as pe
from ljmd_tpu_torch.models.simulation import initialize, run_production, sample_cycle
from ljmd_tpu_torch.ops.geometry import minimum_image
from ljmd_tpu_torch.stats.moments import means_init
from ljmd_tpu_torch.utils import profiling
from ljmd_tpu_torch.utils.profiling import reset_spans, span, span_table, span_totals

torch.set_num_threads(1)

FUSED_CHUNK = 8
REBIN = "ljmd.cellpair.rebin"


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _counts():
    return {k: v["count"] for k, v in span_totals().items()}


@pytest.fixture(scope="module")
def pencil_fluid():
    cfg = config_from_density(num_cells=5, density=0.66, dt=0.002, dtype="float64",
                              neighbor_skin=0.3, total_steps=60, output_interval=10,
                              warmup_steps=10, target_total_energy=-2000.0)
    return cfg, initialize(cfg, backend="dense", device="cpu")


@pytest.fixture(scope="module")
def zsort_fluid():
    cfg = config_from_density(num_cells=5, density=0.8, dt=0.004, dtype="float64",
                              total_steps=10, warmup_steps=30, target_total_energy=-2300.0)
    return cfg, initialize(cfg, backend="dense", device="cpu")


def _pencil_engine(pencil_fluid, interval=10):
    cfg, state = pencil_fluid
    cfg = cfg.replace(output_interval=interval)
    eng = pe._cellpair_engine(cfg, "cpu", rebin_trigger="always")
    carry, _ = eng.init(state)
    return cfg, eng, carry


def test_spans_without_a_profiler_leave_the_tally_empty(pencil_fluid, monkeypatch):
    """No profiler: every span is the one shared no-op, and a cell-pair
    ``run_fast`` and ``step`` record nothing. With one or without, no span
    enters a ``record_function`` (a user-scope range, which the profiler
    mirrors on the device's timeline)."""
    entered = []
    real_enter = torch.autograd.profiler.record_function.__enter__

    def counted(self):
        entered.append(self.name)
        return real_enter(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counted)
    reset_spans()
    assert span("ljmd.a") is span("ljmd.b")
    cfg, eng, carry = _pencil_engine(pencil_fluid)
    carry = eng.run_fast(carry, 3)
    eng.step(carry)
    assert span_totals() == {}
    with _cpu_profile():
        sample_cycle(eng, cfg, carry, means_init(dtype=torch.float64))
    assert span_totals() and entered == []
    reset_spans()


@pytest.mark.parametrize("interval", [2, 10])
def test_cycle_span_counts_follow_the_chunks(pencil_fluid, interval):
    """One sample cycle under a CPU profile: a rebin ("always", the drift
    check folded into it: no check span) and a chunk per fused chunk of the
    cycle's ``interval - 1`` steps, one read
    of the moved flag (the counter's own delta), one sampled sweep and one
    statistics span. The drift of <= 9 steps stays far inside the slack, so
    the moved check adds no rebin. The profile holds the same spans."""
    cfg, eng, carry = _pencil_engine(pencil_fluid, interval)
    acc = means_init(dtype=torch.float64)
    chunks = math.ceil((interval - 1) / FUSED_CHUNK)
    reset_spans()
    reads = dict(pe.HOST_READS)
    with _cpu_profile() as prof:
        sample_cycle(eng, cfg, carry, acc)
    moved = pe.HOST_READS["cellpair_moved"] - reads["cellpair_moved"]
    assert moved == 1
    assert _counts() == {REBIN: chunks, "ljmd.cellpair.chunk": chunks, "ljmd.read.cellpair_moved": moved,
                         "ljmd.cellpair.sweep": 1, "ljmd.driver.stats": 1}
    assert all(v["total_ns"] > 0 for v in span_totals().values())
    seen = {}
    for e in prof.events():
        if e.name.startswith("ljmd."):
            seen[e.name] = seen.get(e.name, 0) + 1
    assert seen == _counts()


def test_program_spans_are_direct_children_of_the_engine_spans(pencil_fluid):
    """Wrapped as the harness wraps each engine call, the rebin and chunk
    spans are direct ``cpu_children`` of ``ljbench.engine.run_fast``,
    the read and the sweep of ``ljbench.engine.step``; no program span has
    a program span above it."""
    cfg, eng, carry = _pencil_engine(pencil_fluid)

    def spanned(name, fn):
        def call(*args):
            with record_function(f"ljbench.engine.{name}"):
                return fn(*args)
        return call

    eng = eng._replace(run_fast=spanned("run_fast", eng.run_fast),
                       step=spanned("step", eng.step))
    with _cpu_profile() as prof:
        with record_function("ljbench.sample_cycle"):
            sample_cycle(eng, cfg, carry, means_init(dtype=torch.float64))
    events = prof.events()
    children = {e.name: {c.name for c in e.cpu_children} for e in events
                if e.name.startswith("ljbench.")}
    assert {REBIN, "ljmd.cellpair.chunk"} <= children["ljbench.engine.run_fast"]
    assert {"ljmd.read.cellpair_moved", "ljmd.cellpair.sweep"} <= children["ljbench.engine.step"]
    assert "ljmd.driver.stats" in children["ljbench.sample_cycle"]
    program = [e for e in events if e.name.startswith("ljmd.")]
    assert program
    for e in program:
        parent = e.cpu_parent
        while parent is not None:
            assert not parent.name.startswith("ljmd."), (e.name, parent.name)
            parent = parent.cpu_parent


# A chunk's spans: the resort (the travel check runs inside it), then the
# fused chunk.
ZSORT_SPANS = ("ljmd.zsort.resort", "ljmd.zsort.chunk")


@pytest.mark.parametrize("call", ["run_fast", "run_sample"])
def test_zsort_resort_span(zsort_fluid, call):
    """One zsort chunk, plain (``run_fast``) or in obs_last mode
    (``run_sample``), resorts once and records one ``ljmd.zsort.resort`` and
    one ``ljmd.zsort.chunk``, and no host read."""
    cfg, state = zsort_fluid
    eng = pe._zsort_engine(cfg, "cpu", inner_chunk=FUSED_CHUNK)
    carry, _ = eng.init(state)
    reads = dict(pe.HOST_READS)
    reset_spans()
    with _cpu_profile():
        out = getattr(eng, call)(carry, FUSED_CHUNK)
    counts = _counts()
    if call == "run_sample":
        out, obs = out
        assert math.isfinite(float(obs.epot))
    assert int(out.resorts) - int(carry.resorts) == 1
    assert counts == dict.fromkeys(ZSORT_SPANS, 1)
    assert dict(pe.HOST_READS) == reads


def _zsort_engine_and_carry(zsort_fluid, replicas):
    cfg, state = zsort_fluid
    if replicas is not None:
        state = pe.stack_states([state] * replicas)
    eng = pe._zsort_engine(cfg, "cpu", inner_chunk=FUSED_CHUNK, replicas=replicas)
    return cfg, eng, eng.init(state)[0]


def _chunk_spans(eng, carry, chunks):
    """Without a profiler a zsort ``run_fast`` records nothing. Under one,
    wrapped as the harness wraps ``run_fast``: the span tally and the program
    spans directly under the engine span, in order, none of them under
    another program span."""
    reset_spans()
    eng.run_fast(carry, FUSED_CHUNK)
    assert span_totals() == {}

    def run_fast(*args):
        with record_function("ljbench.engine.run_fast"):
            return eng.run_fast(*args)

    with _cpu_profile() as prof:
        run_fast(carry, chunks * FUSED_CHUNK)
    counts = _counts()
    events = prof.events()
    outer = [e for e in events if e.name == "ljbench.engine.run_fast"]
    assert len(outer) == 1
    children = [c.name for c in outer[0].cpu_children if c.name.startswith("ljmd.")]
    for e in events:
        if e.name.startswith("ljmd."):
            parent = e.cpu_parent
            while parent is not None:
                assert not parent.name.startswith("ljmd."), (e.name, parent.name)
                parent = parent.cpu_parent
    reset_spans()
    return counts, children


@pytest.mark.parametrize("replicas", [None, 2], ids=["one", "stacked"])
def test_zsort_spans_are_direct_children_only_under_a_profiler(zsort_fluid, replicas):
    """Each chunk records one ``ljmd.zsort.resort`` (the travel check
    folded into it) and one
    ``ljmd.zsort.chunk``, each a direct child of the engine span, none under
    another program span; nothing without a profiler."""
    cfg, eng, carry = _zsort_engine_and_carry(zsort_fluid, replicas)
    chunks = 2
    counts, children = _chunk_spans(eng, carry, chunks)
    assert counts == dict.fromkeys(ZSORT_SPANS, chunks)
    assert children == list(ZSORT_SPANS) * chunks


@pytest.mark.parametrize("replicas", [None, 2], ids=["one", "stacked"])
def test_zsort_travel_counter_is_the_largest_chunk_travel(zsort_fluid, replicas):
    """``counters``' ``zsort_travel_share`` after each chunk is the largest
    sorted-axis travel of the chunks checked so far (each chunk's z travel
    from its resort, read from the carry), as a share of the invalid bound,
    a replica's each; it adds no host read."""
    cfg, eng, carry = _zsort_engine_and_carry(zsort_fluid, replicas)
    if replicas is not None:  # replicas apart: a different state each
        carry = dataclasses.replace(carry, v=carry.v * torch.tensor([1.0, 1.3])[:, None, None])
    bound2 = pe.zsort_geometry(cfg, FUSED_CHUNK).invalid_thresh
    reads = dict(pe.HOST_READS)
    seen = torch.zeros(() if replicas is None else (replicas,), dtype=torch.float64)
    for _ in range(4):
        before = seen.clone()
        carry = eng.run_fast(carry, FUSED_CHUNK)
        got = eng.counters(carry)["zsort_travel_share"]
        assert got.shape == seen.shape
        torch.testing.assert_close(got, torch.sqrt(before / bound2), rtol=1e-12, atol=0.0)
        d = minimum_image(carry.r[..., 2, :] - carry.r_ref[..., 2, :], cfg.box_length)
        travel2 = torch.where(carry.ids >= 0, d * d, 0.0).amax(dim=-1)
        seen = torch.maximum(seen, travel2)
    assert bool((seen > 0).all())
    if replicas is not None:
        assert float(seen[1]) > float(seen[0])
    assert dict(pe.HOST_READS) == reads


def test_production_result_carries_the_engine_counters(zsort_fluid):
    """``run_production``'s result holds the engine's counters at its end
    (what the operator's report prints): the zsort travel share of a short
    production, inside (0, 1); none from an engine without counters."""
    cfg, state = zsort_fluid
    cfg = cfg.replace(total_steps=2 * FUSED_CHUNK + 10, output_interval=10, warmup_steps=10)
    res = run_production(cfg, state, backend="zsort", device="cpu")
    share = res.counters["zsort_travel_share"]
    assert share.shape == () and 0.0 < float(share) < 1.0
    assert run_production(cfg, state, backend="rows", device="cpu").counters == {}


@pytest.mark.parametrize("replicas", [None, 2], ids=["one", "stacked"])
def test_pencil_drift_counter_is_the_largest_chunk_drift(pencil_fluid, replicas):
    """``counters``' ``pencil_drift_share`` after each fused chunk is the
    largest xy drift of the chunks checked so far (each chunk's drift from
    its rebin, read from the carry; the check rides in the next chunk's
    rebin), as a share of half the coverage slack, a replica's each; it adds
    no host read."""
    from ljmd_tpu_torch.ops.cell_list import make_pencil_grid

    cfg, state = pencil_fluid
    eng = pe._cellpair_engine(cfg, "cpu", rebin_trigger="always", replicas=replicas)
    if replicas is not None:
        state = pe.stack_states([state, state])
    carry, _ = eng.init(state)
    if replicas is not None:  # replicas apart: a different state each
        ns = carry.v.shape[1] // replicas
        carry = dataclasses.replace(carry, v=torch.cat([carry.v[:, :ns], 1.3 * carry.v[:, ns:]],
                                                       dim=1))
    grid = make_pencil_grid(cfg.n, cfg.box_length, cfg.rc + cfg.neighbor_skin, cfg.density)
    bound2 = (0.5 * (grid.pencil_width - cfg.rc)) ** 2
    reads = dict(pe.HOST_READS)
    seen = torch.zeros(() if replicas is None else (replicas,), dtype=torch.float64)
    for _ in range(4):
        before = seen.clone()
        carry = eng.run_fast(carry, FUSED_CHUNK)
        got = eng.counters(carry)["pencil_drift_share"]
        assert got.shape == seen.shape
        torch.testing.assert_close(got, torch.sqrt(before / bound2), rtol=1e-12, atol=0.0)
        d = minimum_image(carry.r[0:2] - carry.r_ref[0:2], cfg.box_length)
        moved2 = torch.sum(d * d, dim=0) * carry.r[3]
        seen = torch.maximum(seen, moved2.reshape(-1 if replicas is None else replicas,
                                                  moved2.shape[0] // (replicas or 1)).amax(dim=1)
                             .reshape(seen.shape))
    assert bool((seen > 0).all())
    if replicas is not None:
        assert float(seen[1]) > float(seen[0])
    assert dict(pe.HOST_READS) == reads


def test_pencil_chunk_tally_and_the_counters_reset(pencil_fluid):
    """``PENCIL_CHUNKS`` counts the fused chunks ``run_fast`` issues and
    their steps on the host (the fixed 8 without a state: 20 steps are 8, 8
    and 4); ``profiling.reset()`` zeroes it with the launch and host-read
    counters and clears the span tally."""
    cfg, eng, carry = _pencil_engine(pencil_fluid)
    pe.PENCIL_CHUNKS.reset()
    reads = dict(pe.HOST_READS)
    eng.run_fast(carry, 20)
    assert dict(pe.PENCIL_CHUNKS) == {"chunks": 3, "steps": 20}
    assert dict(pe.HOST_READS) == reads
    eng.step(carry)  # the sampled step is no fused chunk
    assert dict(pe.PENCIL_CHUNKS) == {"chunks": 3, "steps": 20}
    _record("ljmd.a", 1)
    pe.HOST_READS["cellpair_moved"] += 1
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    LAUNCHES.bump("rebin_keys")
    profiling.reset()
    assert dict(pe.PENCIL_CHUNKS) == {"chunks": 0, "steps": 0}
    assert not any(pe.HOST_READS.values()) and not any(LAUNCHES.snapshot().values())
    assert span_totals() == {}


def test_reset_zeroes_every_registered_counter():
    """``profiling.counter`` registers a tally for ``profiling.reset``: the
    launch, host-read and fused-chunk counters are registered by the
    modules that keep them (the profiling module imports none of them), and
    a tally registered later is zeroed with them."""
    from ljmd_tpu_torch.ops._cuda import LAUNCHES

    registered = profiling._COUNTERS
    assert all(any(t is c for t in registered)
               for c in (LAUNCHES, pe.HOST_READS, pe.PENCIL_CHUNKS))
    extra = profiling.counter(pe.Tally(x=0))
    try:
        extra["x"] = 3
        pe.PENCIL_CHUNKS["steps"] += 5
        profiling.reset()
        assert extra == {"x": 0} and pe.PENCIL_CHUNKS["steps"] == 0
    finally:
        registered.remove(extra)


def test_engine_temperature_read_is_a_host_read_with_its_span(pencil_fluid):
    """Building an engine for a state reads its kinetic temperature once
    (the fused chunk's rule, the zsort skin): ``host_read`` key
    ``engine_temperature``, its wait the span ``ljmd.read.engine_temperature``;
    a cell-pair engine built without a state reads nothing."""
    cfg, state = pencil_fluid
    reads = pe.HOST_READS["engine_temperature"]
    reset_spans()
    with _cpu_profile():
        pe.make_engine(cfg, "cellpair", "cpu", state=state)
    assert pe.HOST_READS["engine_temperature"] == reads + 1
    assert _counts() == {"ljmd.read.engine_temperature": 1}
    pe.make_engine(cfg, "cellpair", "cpu")
    pe.make_engine(cfg, "rows", "cpu", state=state)
    assert pe.HOST_READS["engine_temperature"] == reads + 1
    reset_spans()


def test_pencil_chunk_steps_reader():
    """Steps over chunks of the program's tally, on a traced run; nothing
    untraced or where no fused chunk was issued."""
    read = reader("pencil_chunk_steps")
    ctx = {"traced": {"idle_gaps": [], "wall_s": 1.0}}
    pe.PENCIL_CHUNKS.reset()
    assert read(ctx) is None
    pe.PENCIL_CHUNKS.update(chunks=10, steps=49)
    assert read(ctx) == pytest.approx(4.9)
    assert read({"traced": None}) is None
    pe.PENCIL_CHUNKS.reset()


def test_pencil_chunk_roofline_reader():
    """Kernel 15's share of its roofline: ``pair_roofline_pct``'s least time
    of the stretch's work over the device time of ``fused_pencil_kernel``
    (not kernel 16's ``fused_pencil_width_kernel``); nothing without it."""
    read = reader("pencil_chunk_roofline_pct")
    cfg = config_from_density(num_cells=40, density=0.8442, dt=0.005, dtype="float32",
                              output_interval=50)
    cell = SimpleNamespace(cfg=cfg, replicas=1)
    ops = [["void ljmd::fused_pencil_kernel<float, false>(ljmd::HsChunkArgs<float>)", 1.5],
           ["void ljmd::pencil_sweep_hs_kernel<float, 4>(...)", 0.05],
           ["void ljmd::fused_pencil_width_kernel<float, false>(ljmd::WidthArgs<float>)", 0.3]]
    traced = {"busy_s": 2.0, "wall_s": 2.1, "steps": 800, "cycles": 16, "pairs": 7.0e6,
              "top_ops": ops, "idle_gaps": []}
    ctx = {"traced": traced, "cell": cell}
    work = 800 * (7.0e6 * 30 + 256_000 * 24) + 16 * 7.0e6 * 10
    assert read(ctx) == pytest.approx(100.0 * work / 67e12 / 1.5)
    assert read(ctx) == pytest.approx(reader("pair_roofline_pct")(ctx) * 2.0 / 1.5)
    assert read({"traced": dict(traced, top_ops=ops[1:]), "cell": cell}) is None
    assert read({"traced": None, "cell": cell}) is None


def test_host_reads_reset_and_read_helper():
    """``HOST_READS`` stays a dict of counts (``dict()``, ``items()``,
    item access and assignment) and gains ``reset``; ``host_read`` bumps
    its key once a read and returns the value cast."""
    reads = pe.HOST_READS
    keys = list(reads)
    assert pe.host_read("cellpair_moved", torch.tensor(True)) is True
    assert pe.host_read("cellpair_chunk", torch.tensor(2.5), float) == 2.5
    assert reads["cellpair_moved"] >= 1 and reads["cellpair_chunk"] >= 1
    reads["neighbor_rebuild"] = 7
    reads.reset()
    assert isinstance(reads, dict) and list(reads) == keys
    assert dict(reads) == dict.fromkeys(keys, 0)
    assert all(v == 0 for _, v in reads.items())
    pe.host_read("neighbor_rebuild", torch.tensor(False))
    assert reads["neighbor_rebuild"] == 1
    reads.reset()


def _record(name, times, seconds=0.0):
    with _cpu_profile():
        for _ in range(times):
            with span(name):
                time.sleep(seconds)


GAPS = [["ljbench.engine.run_fast / ljmd.cellpair.rebin (3 gaps)", 0.5],
        ["ljbench.engine.run_fast (4 gaps)", 2.0],
        ["ljbench.engine.run_fast / aten::where (9 gaps)", 1.0],
        ["ljbench.engine.step / ljmd.cellpair.rebin (2 gaps)", 0.25],
        ["ljbench.engine.step / ljmd.cellpair.rebinned (1 gaps)", 4.0],
        ["host loop between cycles (1 gaps)", 0.1]]


@pytest.mark.parametrize("metric,name", [("rebin_host_ms", REBIN),
                                         ("stats_host_ms", "ljmd.driver.stats"),
                                         ("resort_host_ms", "ljmd.zsort.resort")])
def test_host_ms_readers(metric, name):
    """The mean host ms of the span's tally; nothing without a traced
    stretch or without the span."""
    read = reader(metric)
    ctx = {"traced": {"idle_gaps": [], "wall_s": 1.0}}
    reset_spans()
    assert read(ctx) is None
    _record(name, 3, 0.002)
    tally = span_totals()[name]
    assert read(ctx) == pytest.approx(1e-6 * tally["total_ns"] / 3)
    assert read(ctx) >= 2.0
    assert read({"traced": None}) is None
    reset_spans()


def test_rebin_idle_reader():
    """The idle seconds of every gap whose child is the rebin span (not a
    name that merely starts with it, nor another child or the bare engine
    span) over the stretch's wall; nothing without a traced stretch or
    without rebin spans."""
    read = reader("rebin_idle_pct")
    ctx = {"traced": {"idle_gaps": GAPS, "wall_s": 2.0}}
    reset_spans()
    assert read(ctx) is None
    _record(REBIN, 1)
    assert read(ctx) == pytest.approx(100.0 * 0.75 / 2.0)
    assert read({"traced": {"idle_gaps": GAPS[1:3], "wall_s": 2.0}}) == 0.0
    assert read({"traced": None}) is None
    reset_spans()


def test_resort_idle_reader():
    """The rebin reader's rule for the zsort resort span: the idle seconds
    of gaps whose child is ``ljmd.zsort.resort`` over the stretch's wall;
    nothing without resort spans in the tally."""
    read = reader("resort_idle_pct")
    gaps = [["ljbench.engine.run_sample / ljmd.zsort.resort (40 gaps)", 0.3],
            ["ljbench.engine.run_fast / ljmd.zsort.resort (10 gaps)", 0.1],
            ["ljbench.engine.run_fast / ljmd.zsort.resorted (1 gaps)", 1.0],
            ["ljbench.engine.run_fast / ljmd.zsort.check (5 gaps)", 0.2],
            ["ljbench.engine.run_fast (4 gaps)", 2.0]]
    ctx = {"traced": {"idle_gaps": gaps, "wall_s": 4.0}}
    reset_spans()
    assert read(ctx) is None
    _record("ljmd.zsort.resort", 1)
    assert read(ctx) == pytest.approx(100.0 * 0.4 / 4.0)
    assert read({"traced": None}) is None
    reset_spans()


def test_list_roofline_reader():
    """Kernel 10's share of its roofline: ``pair_roofline_pct``'s least time
    of the stretch's work over the device time of the operations named
    ``fused_list_kernel`` (one-system and replica instantiations summed);
    nothing without such an operation or without the pair count."""
    read = reader("list_roofline_pct")
    cfg = config_from_density(num_cells=10, density=0.8442, dt=0.005, dtype="float32",
                              output_interval=50)
    cell = SimpleNamespace(cfg=cfg, replicas=2)
    ops = [["void fused_list_kernel<float, false, true>(ListArgs<float>, int, int)", 0.6],
           ["void pack_window_lists_kernel<true>(...)", 0.05],
           ["void fused_list_kernel<float, false, false>(ListArgs<float>, int, int)", 0.2]]
    traced = {"busy_s": 1.0, "wall_s": 1.2, "steps": 1000, "cycles": 20, "pairs": 2.2e5,
              "top_ops": ops, "idle_gaps": []}
    ctx = {"traced": traced, "cell": cell}
    work = 1000 * (2.2e5 * 30 + 2 * 4000 * 24) + 20 * 2.2e5 * 10
    assert read(ctx) == pytest.approx(100.0 * work / 67e12 / 0.8)
    assert read(ctx) == pytest.approx(reader("pair_roofline_pct")(ctx) / 0.8)
    assert read({"traced": dict(traced, top_ops=ops[1:2]), "cell": cell}) is None
    assert read({"traced": {k: v for k, v in traced.items() if k != "pairs"},
                 "cell": cell}) is None
    assert read({"traced": None, "cell": cell}) is None


def test_span_table_from_a_cpu_profile(pencil_fluid):
    """The operator's table from a CPU profile of a sample cycle: a row per
    span with the tally's counts, host time inside the profile's intervals,
    and no device time or operations (no device)."""
    cfg, eng, carry = _pencil_engine(pencil_fluid, 2)
    reset_spans()
    with _cpu_profile() as prof:
        sample_cycle(eng, cfg, carry, means_init(dtype=torch.float64))
    table = span_table(prof.events())
    assert {k: v["count"] for k, v in table.items()} == _counts()
    for row in table.values():
        assert row["host_ms"] > 0 and row["host_ms_mean"] == pytest.approx(
            row["host_ms"] / row["count"])
        assert row["idle_ms"] == 0.0 and row["device_ops"] == 0 == row["device_ops_mean"]


def _event(name, start, end, device="cpu", kernels=0, children=(), scope=0):
    from torch.autograd import DeviceType

    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device == "cuda" else DeviceType.CPU,
        kernels=[None] * kernels, cpu_children=list(children), scope=scope)


def test_span_table_gap_midpoints_and_launches():
    """Each idle gap between the device's merged intervals goes to the span
    holding its midpoint; a span's device operations are its own launches
    and its descendants'. The device's mirror of a ``record_function``
    range (user scope) is not device work."""
    op = _event("aten::sort", 11, 12, kernels=2, children=[_event("aten::copy_", 11, 12,
                                                                  kernels=1)])
    events = [
        _event("ljmd.cellpair.rebin", 10, 30, kernels=1, children=[op]), op, *op.cpu_children,
        _event("ljmd.cellpair.rebin", 40, 60),
        _event("ljmd.cellpair.chunk", 70, 80, kernels=1),
        _event("ljbench.engine.run_fast", 0, 100,
               scope=int(torch._C._profiler.RecordScope.USER_SCOPE)),
        _event("ljbench.engine.run_fast", 0, 100, "cuda"),
        # device: busy [0, 12] and [11, 14] merge; gaps (14, 24) mid 19 in
        # rebin 1, (26, 50) mid 38 in none, (52, 58) mid 55 in rebin 2,
        # (60, 90) mid 75 in the chunk
        _event("k", 0, 12, "cuda"), _event("k", 11, 14, "cuda"), _event("k", 24, 26, "cuda"),
        _event("k", 50, 52, "cuda"), _event("k", 58, 60, "cuda"), _event("k", 90, 95, "cuda"),
    ]
    table = span_table(events)
    assert set(table) == {"ljmd.cellpair.rebin", "ljmd.cellpair.chunk"}
    rebin, chunk = table["ljmd.cellpair.rebin"], table["ljmd.cellpair.chunk"]
    assert rebin["count"] == 2 and rebin["host_ms"] == pytest.approx(0.040)
    assert rebin["idle_ms"] == pytest.approx(0.016) and chunk["idle_ms"] == pytest.approx(0.030)
    assert rebin["device_ops"] == 4 and rebin["device_ops_mean"] == 2.0
    assert chunk["device_ops"] == 1 and chunk["host_ms_mean"] == pytest.approx(0.010)


def test_span_tally_from_threads():
    """Spans closed from several threads at once under one profile lose no
    count (the tally's update is locked)."""
    threads, each = 12, 200
    reset_spans()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with span("ljmd.test.thread"):
                    pass

        with _cpu_profile():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert span_totals()["ljmd.test.thread"]["count"] == threads * each
    reset_spans()
    assert profiling.span_totals() == {}
