"""The model's operations over the window (shader and basis products, the
lookups' interpolation, counted from the widths) as a share of the float32
peak times the window's seconds."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.mfu()
