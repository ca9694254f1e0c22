"""Seconds of the kernels' build or, once built in the checkout, their
lookup."""


def read(ctx):
    return ctx.spans.get("build_s")
