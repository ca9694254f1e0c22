"""Device ms a view in torch's elementwise kernels and reductions."""


def read(ctx):
    if ctx.mode != "render":
        return None
    return ctx.family_ms("elementwise")
