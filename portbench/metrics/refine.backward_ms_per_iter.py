"""The host's ms in autograd's backward pass of the refine
(``torch.autograd.grad``) per refine iteration of the traced window: the
summed ``refine.backward`` spans over the ``refine.iteration`` spans."""

from portbench import spans


def read(ctx):
    return spans.per("refine.backward", "refine.iteration")
