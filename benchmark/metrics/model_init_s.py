"""Seconds from the chart's construction to the first warm view: the model
built, the weights installed, the renderer and a two-chunk view."""


def read(ctx):
    if ctx.mode != "render":
        return None
    return ctx.spans.get("model_init_s")
