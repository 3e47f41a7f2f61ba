"""roofline.ell_matvec_bwd (kernels): K2, ``gw[idx[b,k]] += g[b] *
val[b,k]``, tile kernel and flush. Reads the batch and g, writes the
``u`` touched rows of gw; a multiply and an add an entry."""

PARTS = ("ell_matvec_bwd_kernel", "ell_matvec_bwd_flush_kernel")


def work(b, k, e, u):
    return b * k * 8 + b * 4 + u * 4, 2 * b * k


def read(ctx):
    return ctx.roofline(PARTS, work)
