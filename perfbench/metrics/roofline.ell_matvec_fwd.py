"""roofline.ell_matvec_fwd (kernels): K1, ``out[b] = sum_k val[b,k] *
w[idx[b,k]]``. Reads the batch's ids and values and the ``u`` distinct
rows of w once, writes B scores; a multiply and an add an entry."""

PARTS = ("ell_matvec_fwd_kernel",)


def work(b, k, e, u):
    return b * k * 8 + u * 4 + b * 4, 2 * b * k


def read(ctx):
    return ctx.roofline(PARTS, work)
