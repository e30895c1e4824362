"""The host's ms in the refine's forward passes (decode, render, losses:
the launches of ``iteration(...)`` in engine/refine.py) per refine
iteration of the traced window: the summed ``refine.forward`` spans over
the ``refine.iteration`` spans."""

from portbench import spans


def read(ctx):
    return spans.per("refine.forward", "refine.iteration")
