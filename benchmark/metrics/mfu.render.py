"""The model's forward operations of the window's views as a share of the
float32 peak times the window's seconds."""


def read(ctx):
    if ctx.mode != "render":
        return None
    return ctx.mfu()
