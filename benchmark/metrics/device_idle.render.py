"""% of the traced views in which no operation ran on the card."""


def read(ctx):
    if ctx.mode != "render":
        return None
    return ctx.device_idle()
