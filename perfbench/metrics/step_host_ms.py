"""step_host_ms (model step): the host's time inside ``sgd_step`` a
step (autograd, the kernels' launches, the update's enqueue; no sync),
mean over the window."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["step_s"] / w["steps"] if w["steps"] else None
