"""Small statistics of the benchmark: percentiles of cycle times and the
union of device activity intervals (the interval merge of the port's
``device_breakdown``)."""

from __future__ import annotations


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) by linear interpolation between
    the sorted values (``statistics.quantiles``' inclusive method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def merged_length(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))
