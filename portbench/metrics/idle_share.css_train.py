"""The device's idle share of the traced window: 1 - (the union of its
kernel, copy and fill intervals) / the window, in %."""

from portbench import common


def read(ctx):
    return common.idle_share(ctx)
