"""step_mfu (model step): the least time the chip's peaks allow a step,
the larger of its required bytes over the peak bandwidth and its
required FLOPs over the float32 peak (outside the tensor cores: the step
computes in float32), over the measured time a step (the window's
seconds over its steps), with the card's power limit beside it.

Required work is counted once, from the shapes and from ``u``, the mean
number of distinct ids in B consecutive rows of the benchmark's own
data, never from D: a sparse update reads as a gain, not a stale bound.
FM: the batch, ``u`` rows of w and v read and written, b; the forward
(K1, K3, the loss), the backward (K2, K4, the loss's derivative) and the
update of those rows. LR: the dense batch and w, the product both ways.
"""

# per-row operations of the binary cross-entropy and its derivative
LOSS_FLOPS_FWD, LOSS_FLOPS_BWD = 10, 5


def fm_work(b, k, e, u):
    nbytes = b * k * 8 + b * 8 + 2 * u * (1 + e) * 4 + 8
    fwd = 2 * b * k + 4 * b * k * e + 3 * b * e + LOSS_FLOPS_FWD * b
    bwd = 2 * b * k + 5 * b * k * e + LOSS_FLOPS_BWD * b
    update = 2 * u * (1 + e) + 2
    return nbytes, fwd + bwd + update


def lr_work(b, f):
    nbytes = b * f * 4 + b * 8 + 2 * f * 4 + 8
    flops = 4 * b * f + (LOSS_FLOPS_FWD + LOSS_FLOPS_BWD) * b + 2 * f + 2
    return nbytes, flops


def read(ctx):
    w, c = ctx.window, ctx.counts
    if not w["steps"]:
        return None
    if c["model"] == "fm":
        nbytes, flops = fm_work(c["B"], c["K"], c["E"], c["u"])
    else:
        nbytes, flops = lr_work(c["B"], c["F"])
    per_step = w["seconds"] / w["steps"]
    least = ctx.least_seconds(nbytes, flops)
    if least is None:
        return None
    return (100.0 * least / per_step,
            {"power_limit_w": ctx.power_limit_w})
