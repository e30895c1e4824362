"""Tracing and throughput helpers.

Counterpart of sdflabel_tpu/utils/profiling.py: a profiler trace of a
block and a throughput meter for the rays/s, crops/hour and frames/hour
metrics.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (host operators, and the card's
    kernels when it has one), written to ``log_dir/trace.json`` in the
    Chrome trace format (chrome://tracing, Perfetto). Yields the
    profiler, whose ``key_averages()`` sums the time by operator."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ThroughputMeter:
    """Counts rays (pixels x iterations), crops and frames per second.

    CUDA calls return before the card finishes: call
    ``torch.cuda.synchronize()`` (or read a result back to the host)
    before each ``tick()``, or the meter counts the enqueue.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self.rays = 0
        self.crops = 0
        self.frames = 0

    def tick(self, rays: int = 0, crops: int = 0, frames: int = 0):
        self.rays += rays
        self.crops += crops
        self.frames += frames

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def rates(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        return {
            "rays_per_s": self.rays / dt,
            "crops_per_hour": self.crops / dt * 3600.0,
            "frames_per_hour": self.frames / dt * 3600.0,
            "elapsed_s": dt,
        }
