"""Median sample-cycle duration on the device timeline over the traced
run's cycles after its profiled stretch (the first of them, which pays the
profiler's stop, left out)."""

from ljbench.stats import percentile


def read(ctx):
    if ctx["traced"] is None:
        return None
    rest = ctx["cycle_ms"][ctx["traced"]["cycles"] + 1:]
    return percentile(rest, 50) if rest else None
