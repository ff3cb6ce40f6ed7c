"""R x N x MD steps completed in the window over the window's host wall
time, which ends in a synchronize."""


def read(ctx):
    cell = ctx["cell"]
    return cell.replicas * cell.cfg.n * ctx["steps"] / ctx["wall_s"]
