"""The hand kernels of a view: the sum over their launches of each launch's
bound, over their summed device time."""


def read(ctx):
    if ctx.mode != "render":
        return None
    return ctx.kernels_roofline()
