"""Host milliseconds to issue one zsort resort (the sort, the tile flags and
the visit-list pack) over the profiled stretch: the program's span tally of
``ljmd.zsort.resort`` (``span_totals``, kept while the profiler records),
total over count. An upper bound: the profiler slows the host. Nothing
where the program has no such span."""

RESORT = "ljmd.zsort.resort"


def read(ctx):
    if ctx["traced"] is None:
        return None
    try:
        from ljmd_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    tally = span_totals().get(RESORT)
    if not tally or not tally["count"]:
        return None
    return 1e-6 * tally["total_ns"] / tally["count"]
