"""Reading the profiled stretch of a traced run: device busy time, device
operations by name, and the device's idle gaps labelled by what the host
was doing (the harness's spans, ``ljbench.*``, and the operation directly
under the innermost one)."""

from __future__ import annotations

import bisect
from collections import defaultdict

from ljbench.stats import merged, merged_length

SPAN_PREFIX = "ljbench."
CYCLE_SPAN = "ljbench.sample_cycle"
TOP = 10
NAME_CHARS = 120


class _Level:
    """Disjoint (start, end, event) host intervals, searchable by time."""

    def __init__(self, events):
        self.items = sorted(((e.time_range.start, e.time_range.end, e) for e in events),
                            key=lambda x: x[0])
        self.starts = [x[0] for x in self.items]

    def at(self, t: float):
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and self.items[k][1] >= t:
            return self.items[k][2]
        return None


def _label(t: float, cycles: _Level, engine: _Level) -> str:
    span = engine.at(t) or cycles.at(t)
    if span is None:
        return "host loop between cycles"
    child = _Level(span.cpu_children).at(t)
    return span.name + (" / " + child.name if child is not None else "")


def read_stretch(events) -> dict:
    """``busy_s`` (the union of every device operation's interval),
    ``device_ops`` (their number), ``top_ops`` and ``idle_gaps`` (each at
    most ``TOP`` [name, seconds] pairs: device time by operation name, and
    device idle time by the host's span at each gap's midpoint) of a
    profile's events."""
    from torch.autograd import DeviceType

    # The profiler mirrors each record_function span on the device timeline
    # (a user annotation, not an operation): left out of the device's work.
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN_PREFIX)]
    host = [e for e in events if e.device_type != DeviceType.CUDA and e.name.startswith(SPAN_PREFIX)]
    cycles = _Level(e for e in host if e.name == CYCLE_SPAN)
    engine = _Level(e for e in host if e.name != CYCLE_SPAN)
    by_name = defaultdict(float)
    for e in device:
        by_name[e.name[:NAME_CHARS]] += 1e-6 * (e.time_range.end - e.time_range.start)
    busy = merged((e.time_range.start, e.time_range.end) for e in device)
    edges = [(cycles.starts[0], busy[0][0])] if busy and cycles.items else []
    edges += [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    gaps = defaultdict(lambda: [0.0, 0])
    for a, b in edges:
        if b > a:
            g = gaps[_label(0.5 * (a + b), cycles, engine)]
            g[0] += 1e-6 * (b - a)
            g[1] += 1
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": 1e-6 * merged_length(busy),
        "device_ops": len(device),
        "top_ops": [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[f"{k} ({n} gaps)", s] for k, (s, n) in top_gaps],
    }
