"""Device operations (kernels, memcpy, memset) in the profiled stretch per
MD step in it (stack steps for an ensemble)."""


def read(ctx):
    t = ctx["traced"]
    if t is None or t["device_ops"] == 0:
        return None
    return t["device_ops"] / t["steps"]
