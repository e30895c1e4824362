"""The host's ms a CSS step in the loss print (``css.log``), whose
``float()`` reads wait for the card to finish the step: the mean
``css.log`` span of the traced window."""

from portbench import spans


def read(ctx):
    return spans.per("css.log", "css.log")
