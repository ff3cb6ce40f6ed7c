"""100 x the least time of the profiled stretch's needed work / the device
time of the cell-pair engine's fused chunk kernel (kernel 15,
``fused_pencil_kernel``) in it.

The needed work and its least time are ``pair_roofline_pct``'s. A cycle's
sampled step runs in kernel 13, outside kernel 15, so at a sample every
``interval`` steps the share counts 1 / ``interval`` of the pair work that
kernel 15 did not do: an upper bound by that much. Nothing where the
stretch's kept operations (the breakdown's ``top_ops``) hold no such
kernel."""

from ljbench.spec import reader

KERNEL = "fused_pencil_kernel"


def read(ctx):
    t = ctx["traced"]
    if t is None:
        return None
    kernel_s = sum(s for name, s in t["top_ops"] if KERNEL in name)
    share = reader("pair_roofline_pct")(ctx)
    if kernel_s <= 0.0 or share is None:
        return None
    return share * t["busy_s"] / kernel_s
