"""Crops refined and labelled in the window over the card's busy seconds in
it (the union of its kernel, copy and fill intervals in the profiler's
trace of the whole window): the cars the card labels for each second of
its own work. End to end in place of the wall-clock rate
(refine.crops_per_wall_s): the host paces the loop, and its speed swings
that rate between runs and within one."""


def read(ctx):
    if ctx["trace"] is None or not ctx.get("crops"):
        return None
    busy = ctx["trace"].busy_s()
    if busy <= 0:
        return None
    return ctx["crops"] / busy
