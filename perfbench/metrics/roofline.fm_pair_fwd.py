"""roofline.fm_pair_fwd (kernels): K3, ``s = sum_k x v[idx]``, ``pair =
1/2 sum_e (s^2 - sum_k (x v)^2)``. Reads the batch and the ``u``
distinct rows of v once, writes pair and s; four operations an entry
and column, three a row and column to finish."""

PARTS = ("fm_pair_fwd_kernel",)


def work(b, k, e, u):
    return b * k * 8 + u * e * 4 + b * 4 + b * e * 4, 4 * b * k * e + 3 * b * e


def read(ctx):
    return ctx.roofline(PARTS, work)
