"""device_idle_share (device): 1 - (the union of the device's activity
intervals: kernels, copies, fills) / the traced slice's wall time, from
the ``torch.profiler`` capture of a steady slice after the window."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
