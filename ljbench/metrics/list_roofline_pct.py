"""100 x the least time of the profiled stretch's needed work / the device
time of the zsort list chunk's kernel (kernel 10, ``fused_list_kernel``,
one-system and replica launches) in it.

The needed work and its least time are ``pair_roofline_pct``'s: the
reference's pairs inside rc, 30 operations a pair-step, 10 more a sampled
step, 24 a particle-step, the state's bytes once, at ``peaks.json``. In the
zsort cells every step, the sampled one included (``run_sample``'s
``obs_last``), runs inside kernel 10, so its device time holds all of
that work. Nothing where the stretch's kept operations (the breakdown's
``top_ops``) hold no such kernel."""

from ljbench.spec import reader

KERNEL = "fused_list_kernel"


def read(ctx):
    t = ctx["traced"]
    if t is None:
        return None
    kernel_s = sum(s for name, s in t["top_ops"] if KERNEL in name)
    share = reader("pair_roofline_pct")(ctx)
    if kernel_s <= 0.0 or share is None:
        return None
    return share * t["busy_s"] / kernel_s
