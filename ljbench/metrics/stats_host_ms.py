"""Host milliseconds of one sample cycle's statistics (``means_update``, the
temperature and pressure, the series column) over the profiled stretch: the
program's span tally of ``ljmd.driver.stats`` (``span_totals``, kept while
the profiler records), total over count. An upper bound: the profiler slows
the host. Nothing where the program has no such span."""


def read(ctx):
    if ctx["traced"] is None:
        return None
    try:
        from ljmd_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    tally = span_totals().get("ljmd.driver.stats")
    if not tally or not tally["count"]:
        return None
    return 1e-6 * tally["total_ns"] / tally["count"]
