"""The shader's and the basis's forward GEMMs of a view, counted from the
widths, as a share of the float32 peak over the GEMM family's device time."""


def read(ctx):
    if ctx.mode != "render":
        return None
    return ctx.gemm_roofline()
