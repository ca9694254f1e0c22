"""Device ms a training step in the optimizer's foreach kernels."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.family_ms("adam")
