"""The hand kernels of a training step: the sum over their launches of each
launch's bound, over their summed device time."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.kernels_roofline()
