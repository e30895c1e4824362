"""The host's ms a CSS step in the program's train step (``css.train``:
forward, losses, backward, Adam; a step wrapper's own time left out): the
mean ``css.train`` span of the traced window."""

from portbench import spans


def read(ctx):
    return spans.per("css.train", "css.train")
