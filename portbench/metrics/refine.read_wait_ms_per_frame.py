"""The host's ms in the driver's one read-back a frame (every crop's
parameters and extents, ``.cpu()``; it waits there for the card to finish
the frame's refine): the mean ``refine.read`` span of the traced
window."""

from portbench import spans


def read(ctx):
    return spans.per("refine.read", "refine.read")
