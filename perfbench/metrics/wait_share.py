"""wait_share (trainer loop): the share of the window the loop spent
waiting for its next staged batch, epoch reopens included, on the
benchmark's clock around ``next()``."""


def read(ctx):
    w = ctx.window
    return 100.0 * w["wait_s"] / w["seconds"] if w["seconds"] > 0 else None
