"""100 x the device's idle seconds while the host issued zsort resorts / the
profiled stretch's wall time: the breakdown's idle gaps whose operation
under the harness's span is the program's ``ljmd.zsort.resort`` (labels
"<span> / <child> (<n> gaps)"). A lower bound where that label falls
outside the gaps the breakdown keeps. Nothing where the program ran no
resort span in the stretch (its span tally, ``span_totals``)."""

RESORT = "ljmd.zsort.resort"


def _child(label: str) -> str:
    name = label.rpartition(" (")[0]
    return name.split(" / ", 1)[1] if " / " in name else ""


def read(ctx):
    t = ctx["traced"]
    if t is None:
        return None
    try:
        from ljmd_tpu_torch.utils.profiling import span_totals
    except ImportError:
        return None
    if not span_totals().get(RESORT, {}).get("count"):
        return None
    idle = sum(s for label, s in t["idle_gaps"] if _child(label) == RESORT)
    return 100.0 * idle / t["wall_s"]
