"""The host's ms in the driver a frame outside the refine loop and the
read-back (letterboxing and batching the inputs, building the batched
refine, the labels): the mean of ``refine.frame`` less its
``refine.loop`` and ``refine.read`` spans in the traced window."""

from portbench import spans


def read(ctx):
    frame = spans.window()
    whole = spans.per("refine.frame", "refine.frame", frame)
    if whole is None:
        return None
    return (whole - spans.per("refine.loop", "refine.frame", frame)
            - spans.per("refine.read", "refine.frame", frame))
