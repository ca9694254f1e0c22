"""% of the traced training segment in which no operation ran on the card."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.device_idle()
