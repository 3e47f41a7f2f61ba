"""roofline.fm_pair_bwd (kernels): K4, ``gv[idx,e] += g * x * (s[b,e] -
x v[idx,e])``, tile kernel and flush. Reads the batch, g, s and the
``u`` distinct rows of v, writes the ``u`` touched rows of gv; five
operations an entry and column."""

PARTS = ("fm_pair_bwd_kernel", "fm_pair_bwd_flush_kernel")


def work(b, k, e, u):
    return b * k * 8 + b * 4 + b * e * 4 + 2 * u * e * 4, 5 * b * k * e


def read(ctx):
    return ctx.roofline(PARTS, work)
