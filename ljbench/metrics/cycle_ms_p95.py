"""95th percentile of the window's sample-cycle durations on the device
timeline (CUDA events at consecutive cycle boundaries)."""

from ljbench.stats import percentile


def read(ctx):
    return percentile(ctx["cycle_ms"], 95) if ctx["cycle_ms"] else None
