"""Tracing and timing (counterpart of ``ljmd_tpu/utils/profiling.py``), and
where a production run's time goes on the card.

- ``span(name)``: the program's spans, ``ljmd.<layer>.<what>``, on while a
  torch profiler records and off otherwise (the cost of one check of the
  profiler's state). On, a span is a function-scope record on the
  profiler's timeline, nested under the caller's spans and never mirrored
  on the device's, and its host time (``time.perf_counter_ns``) adds to an
  in-memory tally by name: ``span_totals()``, cleared by ``reset_spans()``.
- ``reset()``: zero the program's counters (kernel launches, host reads,
  the cell-pair engine's fused chunks: each registered by its module with
  ``counter``) and clear the span tally.
- ``trace(log_dir)``: context manager running the enclosed region under
  ``torch.profiler`` (CPU and, where there is one, CUDA activity) and
  writing a Chrome trace, ``log_dir/trace.json`` (Perfetto,
  chrome://tracing).
- ``Throughput``: wall-clock meter reporting steps/s and particle-steps/s
  (the BASELINE metric), with the JAX package's report keys.
- ``time_fn``: best-of-``iters`` wall time of a call, synchronizing the
  device its tensors live on.
- ``device_breakdown`` / ``span_table`` / ``graph_ops``: the card's busy
  time per kernel under the profiler and the program's spans in the same
  profile, and the device operations of one call counted from a CUDA graph.

Run as a script,

    python -m ljmd_tpu_torch.utils.profiling --config examples/n62500_large.json \\
        --total-steps 2000 --warmup-steps 500 [--backend auto] [--capacity 512]

initializes the config on the card and prints one JSON object:

- ``production``: wall seconds and particle-steps/s of ``run_production``
  without the profiler (after one untimed run);
- ``profile``: the same production under ``torch.profiler`` (CPU and CUDA
  activities), with the kernel-launch and host-read counters and the span
  tally reset before it: its wall, the device busy time (the union of every
  kernel, memcpy and memset interval), the idle share ``1 - busy / wall``
  (an upper bound: the profiler slows the host), device ms and count per
  kernel name (the top 15), the host's CUDA API calls (launches,
  synchronizations) and the ``spans`` table (``span_table``: a rebin's and
  a resort's device operations among them);
- ``counters``: the launches, host reads and fused cell-pair chunks
  (``pencil_chunks``: chunks and their steps) of the profiled production,
  and the engine's own counters at its end (``Engine.counters``; the zsort
  engine's ``zsort_travel_share``: the largest sorted-axis travel of a
  chunk as a share of the invalid bound, a replica's each; its
  ``list_skip_share``: the share of kernel 10's box tests that skipped
  their run of partners; the cell-pair engine's ``pencil_drift_share``: the
  largest xy drift between two rebins as a share of half the coverage
  slack).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["span", "span_totals", "reset_spans", "counter", "reset", "trace", "Throughput", "time_fn",
           "device_breakdown", "span_table", "graph_ops", "main"]

# The program's span names start so; nothing else in a profile does.
SPAN_PREFIX = "ljmd."

# CUgraphNodeType (cuda.h), for graph_ops.
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
               6: "wait_event", 7: "event_record", 8: "semaphore_signal", 9: "semaphore_wait",
               10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


# name -> [count, total host ns] of the spans closed while a profiler recorded.
_SPAN_TALLY: dict[str, list[int]] = {}
_SPAN_LOCK = threading.Lock()


class _SpanOff:
    """A span while no profiler records: entering and leaving do nothing
    (about half the cost of ``contextlib.nullcontext``, whose exit takes
    ``*args``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_SPAN_OFF = _SpanOff()


class _Span:
    """A span while a profiler records: a function-scope record (an ordinary
    host operation to the profiler: no user-scope range, so nothing is
    mirrored on the device's timeline) and its host time in the tally."""

    __slots__ = ("name", "_record", "_t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self._record = torch._C._profiler._RecordFunctionFast(self.name)
        self._record.__enter__()
        self._t0 = time.perf_counter_ns()
        return None

    def __exit__(self, exc_type, exc, tb):
        elapsed = time.perf_counter_ns() - self._t0
        self._record.__exit__(exc_type, exc, tb)
        with _SPAN_LOCK:
            tally = _SPAN_TALLY.setdefault(self.name, [0, 0])
            tally[0] += 1
            tally[1] += elapsed
        return None


def span(name: str):
    """The span ``name`` (``ljmd.<layer>.<what>``) around a ``with`` block:
    recorded while a torch profiler records (``profile.start()`` to
    ``stop()``), else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _SPAN_OFF
    return _Span(name)


def span_totals() -> dict:
    """The tally of the spans closed while a profiler recorded, since the
    last ``reset_spans()``: name -> {"count", "total_ns"} (host time)."""
    with _SPAN_LOCK:
        return {k: {"count": c, "total_ns": t} for k, (c, t) in _SPAN_TALLY.items()}


def reset_spans() -> None:
    with _SPAN_LOCK:
        _SPAN_TALLY.clear()


# The program's counters (kernel launches, host reads, the cell-pair
# engine's fused chunks), each registered by the module that keeps it
# (``counter``), so that ``reset`` knows none of those modules.
_COUNTERS: list = []


def counter(tally):
    """Register ``tally`` (anything with a ``reset()``) for ``reset``;
    returns it."""
    _COUNTERS.append(tally)
    return tally


def reset() -> None:
    """Zero every registered counter (``counter``) and clear the span
    tally."""
    for tally in _COUNTERS:
        tally.reset()
    reset_spans()


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = False):
    """Profile the enclosed region and write ``log_dir/trace.json`` (a
    Chrome trace). CUDA activity is traced where a card is present; host
    Python stacks only with ``host_profiling``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, with_stack=host_profiling) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class Throughput:
    """Step-throughput meter: accumulate (steps, elapsed) batches and report
    rates."""

    n_particles: int
    steps: int = 0
    elapsed: float = 0.0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, steps_done: int) -> None:
        if self._t0 is None:
            raise RuntimeError("Throughput.stop() without start()")
        self.elapsed += time.perf_counter() - self._t0
        self.steps += steps_done
        self._t0 = None

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.elapsed if self.elapsed else 0.0

    @property
    def particle_steps_per_sec(self) -> float:
        return self.steps_per_sec * self.n_particles

    def report(self) -> dict:
        return {
            "steps": self.steps,
            "elapsed_s": self.elapsed,
            "steps_per_sec": self.steps_per_sec,
            "particle_steps_per_sec": self.particle_steps_per_sec,
        }


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _sync_devices(*objs) -> None:
    """Wait for every CUDA device the tensors in ``objs`` live on."""
    for dev in {t.device for o in objs for t in _tensors(o) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def time_fn(fn: Callable, *args, iters: int = 3, sync: Optional[Callable] = None) -> float:
    """Best-of-``iters`` wall seconds of ``fn(*args)``, after one untimed
    call. ``sync(out)`` must wait for the work (default: synchronize the CUDA
    devices of the output's and the arguments' tensors; nothing on the
    CPU)."""
    sync = sync or (lambda out: _sync_devices(out, args))
    sync(fn(*args))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def _merged(intervals) -> list:
    """The union of (start, end) intervals as disjoint, sorted intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _merged_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    return sum(b - a for a, b in _merged(intervals))


def span_table(events) -> dict:
    """The program's spans (``ljmd.*``) in a profile's events, by name:
    ``count``; ``host_ms`` and ``host_ms_mean``, their host intervals;
    ``idle_ms``, the device's idle time under them (each gap between the
    union's device intervals goes to the span whose host interval holds the
    gap's midpoint); ``device_ops`` and ``device_ops_mean``, the device
    operations launched inside them (the profiler's launch correlation: the
    ``kernels`` of the span and of every operation under it). The device's
    mirrors of user-scope ranges (``record_function``) are no device work."""
    from torch.autograd import DeviceType

    user = int(torch._C._profiler.RecordScope.USER_SCOPE)
    ranges = {e.name for e in events if e.device_type != DeviceType.CUDA and e.scope == user}
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA and e.name not in ranges]
    spans = sorted((e for e in events
                    if e.device_type != DeviceType.CUDA and e.name.startswith(SPAN_PREFIX)),
                   key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in spans]
    rows = {}
    for e in spans:
        row = rows.setdefault(e.name, {"count": 0, "host_ms": 0.0, "idle_ms": 0.0,
                                       "device_ops": 0})
        row["count"] += 1
        row["host_ms"] += 1e-3 * (e.time_range.end - e.time_range.start)
        todo = [e]
        while todo:
            op = todo.pop()
            row["device_ops"] += len(op.kernels)
            todo.extend(op.cpu_children)
    busy = _merged(device)
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and spans[k].time_range.end >= mid:
            rows[spans[k].name]["idle_ms"] += 1e-3 * (b - a)
    for row in rows.values():
        row["host_ms_mean"] = row["host_ms"] / row["count"]
        row["device_ops_mean"] = row["device_ops"] / row["count"]
    return rows


def device_breakdown(fn, top: int = 15) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and summarize the device
    activity and the program's spans (module docstring, ``profile``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = {}, {}
    intervals = []
    events = prof.events()
    for e in events:
        if e.device_type == DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            intervals.append((start, end))
            ms, count = device.get(e.name, (0.0, 0))
            device[e.name] = (ms + 1e-3 * (end - start), count + 1)
        elif e.name.startswith("cuda"):
            host[e.name] = host.get(e.name, 0) + 1
    busy = 1e-6 * _merged_length(intervals)
    extent = (1e-6 * (max(b for _, b in intervals) - min(a for a, _ in intervals))
              if intervals else 0.0)
    kernels = sorted(device.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall, "device_busy_s": busy, "device_span_s": extent,
            "idle_share": 1.0 - busy / wall if wall else None,
            "device_ms_by_name": {k: {"ms": ms, "count": n} for k, (ms, n) in kernels},
            "host_cuda_calls": host, "spans": span_table(events)}


def graph_ops(fn) -> dict:
    """The device operations that one ``fn()`` submits, counted exactly:
    after two calls on a side stream, one call is captured into a CUDA graph
    and the graph's nodes are read through the driver (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``). Returns ``ops`` (every node but ``empty`` ones,
    which do nothing) and ``nodes`` (the count by node type). A call that
    reads the card back to the host cannot be captured and raises. Unlike
    ``device_breakdown``, this does not rest on the profiler's activity
    trace, which can come back without a call's launches."""
    import ctypes

    drv = ctypes.CDLL("libcuda.so.1")

    def check(code: int, what: str) -> None:
        if code != 0:
            raise RuntimeError(f"graph_ops: {what} returned CUresult {code}")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(drv.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(drv.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    by_type: dict[str, int] = {}
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        check(drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        name = _NODE_TYPES.get(kind.value, f"type_{kind.value}")
        by_type[name] = by_type.get(name, 0) + 1
    graph.reset()
    return {"ops": sum(v for k, v in by_type.items() if k != "empty"), "nodes": by_type}


def main(argv=None) -> int:
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import HOST_READS, PENCIL_CHUNKS, auto_backend
    from ljmd_tpu_torch.models.simulation import initialize, run_production
    from ljmd_tpu_torch.ops._cuda import LAUNCHES
    from ljmd_tpu_torch.ops.cell_list import capacity_from_state

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--total-steps", type=int)
    ap.add_argument("--warmup-steps", type=int)
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--capacity", type=int, help="cell-pair pencil capacity (default: census)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    cut = {k: v for k, v in (("total_steps", args.total_steps),
                             ("warmup_steps", args.warmup_steps)) if v is not None}
    cfg = cfg.replace(**cut)
    device = torch.device("cuda")
    backend = auto_backend(cfg, True, cfg.output_interval) if args.backend == "auto" else args.backend
    state = initialize(cfg, backend=backend, device=device)
    if backend == "cellpair":
        cap = args.capacity or capacity_from_state(cfg.box_length, cfg.rc + cfg.neighbor_skin,
                                                   state.r)
        cfg = cfg.replace(neighbor_capacity=cap)

    ends = []

    def production():
        ends.append(run_production(cfg, state, backend=backend, device=device).counters)

    production()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    production()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reset()
    report = {"config": args.config, "n": cfg.n, "total_steps": cfg.total_steps,
              "dtype": cfg.dtype, "backend": backend,
              "production": {"wall_s": wall, "particle_steps_per_s": cfg.n * cfg.total_steps / wall},
              "profile": device_breakdown(production),
              "counters": {"launches": {k: v for k, v in LAUNCHES.snapshot().items() if v},
                           "host_reads": dict(HOST_READS),
                           "pencil_chunks": dict(PENCIL_CHUNKS),
                           "engine": {k: v.tolist() for k, v in ends[-1].items()}}}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
