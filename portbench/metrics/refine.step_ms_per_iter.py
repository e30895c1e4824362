"""The host's ms in the refine's guarded step (the NaN / zero-loss guard and
``batch_step``'s Adam and SGD arithmetic) per refine iteration of the
traced window: the summed ``refine.step`` spans over the
``refine.iteration`` spans."""

from portbench import spans


def read(ctx):
    return spans.per("refine.step", "refine.iteration")
