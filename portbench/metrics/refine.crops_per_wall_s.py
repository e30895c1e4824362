"""Crops refined and labelled in the traced window over the window's wall
seconds (host clock, under the profiler's CUDA activity tracing, which
slows the host's launch stream): the rate the host's speed sets."""


def read(ctx):
    if not ctx.get("crops") or ctx["window_s"] <= 0:
        return None
    return ctx["crops"] / ctx["window_s"]
