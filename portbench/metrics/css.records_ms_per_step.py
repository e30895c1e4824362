"""The host's ms a CSS step in fetching its batch (``css.records``: the
augmentation draws, the PIL records and the collation of
``data/crops.py``; with ``cpu_threads > 0`` the wait on the prefetch
queue): the mean ``css.records`` span of the traced window."""

from portbench import spans


def read(ctx):
    return spans.per("css.records", "css.records")
