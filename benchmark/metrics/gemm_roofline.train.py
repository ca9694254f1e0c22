"""The shader's and the basis's GEMMs in a training step (forward and both backward
contractions, counted from the widths) as a share of the float32 peak over
the GEMM family's device time."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.gemm_roofline()
