"""The program's spans (sdflabel_tpu_torch/utils/profiling.py) of the traced
window, for the per-layer readers that time the host's layers from inside
the program.

The profiler records spans only while its session records, and the traced
window is the run's one session, so the latest session's spans are the
window's. Only spans whose root span closed inside the window count (a
step that began before the window or ended after it is left out whole).
A program without spans (no ``spans()`` in its profiling module) gives
none, and every reader then returns None.
"""

from __future__ import annotations


def window() -> list:
    """The window's spans whose root closed in it, in the order they
    opened."""
    try:
        from sdflabel_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    recorded = read()
    kept = []
    for sp in recorded:
        root = sp
        while root.parent >= 0:
            root = recorded[root.parent]
        if root.end_ns is not None and sp.end_ns is not None:
            kept.append(sp)
    return kept


def ms(sp) -> float:
    return (sp.end_ns - sp.start_ns) / 1e6


def per(name: str, unit: str, spans: list | None = None):
    """The summed ms of the `name` spans over the number of `unit` spans;
    None when the window has no `unit` span."""
    spans = window() if spans is None else spans
    n = sum(1 for sp in spans if sp.name == unit)
    if not n:
        return None
    return sum(ms(sp) for sp in spans if sp.name == name) / n
