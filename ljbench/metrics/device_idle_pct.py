"""100 x (1 - union of device activity intervals / wall time) over the
profiled stretch. An upper bound: the profiler slows the host."""


def read(ctx):
    t = ctx["traced"]
    if t is None or t["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"])
