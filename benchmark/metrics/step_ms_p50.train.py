"""The median of the window's step gaps (CUDA events after each step), beside
their 95th percentile (``step_ms_p95.train``)."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.counters.get("step_ms_p50")
