"""The 95th percentile of all the window's step gaps (CUDA events after each
step): a stall of the host or the device lands in it.  A per-layer metric,
not an end-to-end one: its spread depends on how busy the machine's host
is (PERF.md section 2)."""


def read(ctx):
    if ctx.mode != "train":
        return None
    return ctx.counters.get("step_ms_p95")
