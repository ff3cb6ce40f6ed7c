"""Tracing and timing (counterpart of ``ljmd_tpu/utils/profiling.py``), and
where a production run's time goes on the card.

- ``trace(log_dir)``: context manager running the enclosed region under
  ``torch.profiler`` (CPU and, where there is one, CUDA activity) and
  writing a Chrome trace, ``log_dir/trace.json`` (Perfetto,
  chrome://tracing).
- ``Throughput``: wall-clock meter reporting steps/s and particle-steps/s
  (the BASELINE metric), with the JAX package's report keys.
- ``time_fn``: best-of-``iters`` wall time of a call, synchronizing the
  device its tensors live on.
- ``device_breakdown`` / ``graph_ops``: the card's busy time per kernel
  under the profiler, and the device operations of one call counted from a
  CUDA graph.

Run as a script,

    python -m ljmd_tpu_torch.utils.profiling --config examples/n62500_large.json \\
        --total-steps 2000 --warmup-steps 500 [--backend auto] [--capacity 512]

initializes the config on the card and prints one JSON object:

- ``production``: wall seconds and particle-steps/s of ``run_production``
  without the profiler (after one untimed run);
- ``profile``: the same production under ``torch.profiler`` (CPU and CUDA
  activities): its wall, the device busy time (the union of every kernel,
  memcpy and memset interval), the idle share ``1 - busy / wall`` (an upper
  bound: the profiler slows the host), device ms and count per kernel name
  (the top 15), and the host's CUDA API calls (launches, synchronizations);
- ``cellpair`` (cell-pair engine only): from one carry, ``run_fast(8)``
  with the ``always`` trigger (rebin + chunk) and with ``never`` (drift
  check + chunk), each as CUDA-event ms and as host ms to submit it; the
  difference of the two is what a rebin costs.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, Optional

import torch

__all__ = ["trace", "Throughput", "time_fn", "device_breakdown", "graph_ops", "main"]

# CUgraphNodeType (cuda.h), for graph_ops.
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
               6: "wait_event", 7: "event_record", 8: "semaphore_signal", 9: "semaphore_wait",
               10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


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


def _merged_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_breakdown(fn, top: int = 15) -> dict:
    """Run ``fn()`` once under ``torch.profiler`` and summarize the device
    activity (module docstring, ``profile``)."""
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            intervals.append((start, end))
            ms, count = device.get(e.name, (0.0, 0))
            device[e.name] = (ms + 1e-3 * (end - start), count + 1)
        elif e.name.startswith("cuda"):
            host[e.name] = host.get(e.name, 0) + 1
    busy = 1e-6 * _merged_length(intervals)
    span = 1e-6 * (max(b for _, b in intervals) - min(a for a, _ in intervals)) if intervals else 0.0
    kernels = sorted(device.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_s": wall, "device_busy_s": busy, "device_span_s": span,
            "idle_share": 1.0 - busy / wall if wall else None,
            "device_ms_by_name": {k: {"ms": ms, "count": n} for k, (ms, n) in kernels},
            "host_cuda_calls": host}


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


def _event_ms(fn, reps: int) -> tuple[float, float]:
    """(device ms by CUDA events, host ms to submit) per call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def _cellpair_rebin_cost(cfg, state, device, reps: int = 20) -> dict:
    from ljmd_tpu_torch.models.engine import _cellpair_engine

    out = {"capacity": cfg.neighbor_capacity}
    for trigger in ("always", "never"):
        eng = _cellpair_engine(cfg, device, rebin_trigger=trigger)
        carry, _ = eng.init(state)
        ms, host_ms = _event_ms(lambda: eng.run_fast(carry, 8), reps)
        out[trigger] = {"ms_per_run_fast_8": ms, "host_ms_per_run_fast_8": host_ms}
    return out


def main(argv=None) -> int:
    from ljmd_tpu_torch.config import load_config
    from ljmd_tpu_torch.models.engine import auto_backend
    from ljmd_tpu_torch.models.simulation import initialize, run_production
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

    def production():
        run_production(cfg, state, backend=backend, device=device)

    production()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    production()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    report = {"config": args.config, "n": cfg.n, "total_steps": cfg.total_steps,
              "dtype": cfg.dtype, "backend": backend,
              "production": {"wall_s": wall, "particle_steps_per_s": cfg.n * cfg.total_steps / wall},
              "profile": device_breakdown(production)}
    if backend == "cellpair":
        report["cellpair"] = _cellpair_rebin_cost(cfg, state, device)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
