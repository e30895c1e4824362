"""Tracing: a profiler trace of a block, and the program's own spans.

Counterpart of sdflabel_tpu/utils/profiling.py's profiler trace.

``trace(log_dir)`` runs its block under torch.profiler and writes a
Chrome trace (chrome://tracing, Perfetto) holding the host's operators,
the card's kernels and the spans below, on one clock.

``span(name, **counts)`` marks a stretch of the program's host time
(a refine frame, iteration, forward pass; a CSS step and its parts).
Spans are recorded only while a torch.profiler session records, by
whoever started it; otherwise a span costs one read of the profiler's
flag. A recorded span keeps its name, its start and end in ns on the
profiler's clock (``time.time_ns``: the exported trace puts its events at
``baseTimeNanoseconds + 1000 * ts`` on that clock), the index of its
parent (the innermost recorded span open on the same thread when it
started; -1 for a root), the thread's native id, a trace id its root
draws and every descendant shares, and the host integers it was given
(``counts``; ``span.count(**counts)`` adds more before it exits). A span
never synchronises with the card, reads no tensor and allocates nothing
there. It enters no ``record_function`` range: a trace of CUDA activity
alone (the benchmark's) does not keep such ranges, and a trace with the
host's operators gets the spans from ``trace()``.

``spans()`` returns the spans of the latest session: the list restarts
at the first span recorded after the recorder has seen recording off
(a span closed after its session stopped, ``spans()`` read between
sessions, or the start of ``trace()``). At most ``MAX_SPANS`` are kept a
session; ``dropped()`` counts those refused past the bound. A span that
was still open when its session stopped keeps ``end_ns`` None.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 16


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int | None  # None while open, or if it closed after its session
    parent: int  # index of the parent in the session's list; -1: a root
    thread: int  # native thread id, as the profiler's trace gives it
    trace: int  # shared by a root span and all its descendants
    counts: dict


class _Off:
    """What ``span`` returns while nothing records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        pass


_OFF = _Off()


class _Recorder:
    """The process's spans: one list a session, a stack a thread."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self.lock = threading.Lock()
        self.spans: list[Span] = []
        self.dropped = 0
        self.over = True  # the next recorded span opens a new session
        self.local = threading.local()
        self.traces = itertools.count()

    def thread(self):
        """This thread's stack of open spans and its native id (read once:
        it is a system call)."""
        try:
            return self.local.stack, self.local.tid
        except AttributeError:
            self.local.stack, self.local.tid = [], threading.get_native_id()
            return self.local.stack, self.local.tid

    def open(self, name: str, counts: dict):
        """The span, recorded in the session's list and pushed on this
        thread's stack; None past the bound."""
        stack, tid = self.thread()
        with self.lock:
            if self.over:
                self.spans, self.dropped, self.over = [], 0, False
            spans = self.spans
            if len(spans) >= self.limit:
                self.dropped += 1
                return None
            parent = stack[-1] if stack and stack[-1][0] is spans else None
            sp = Span(name, 0, None, -1 if parent is None else parent[1],
                      tid, next(self.traces) if parent is None
                      else spans[parent[1]].trace, counts)
            spans.append(sp)
            at = len(spans) - 1
        stack.append((spans, at))
        sp.start_ns = time.time_ns()
        return sp

    def close(self, sp: Span) -> None:
        end = time.time_ns()
        self.thread()[0].pop()
        if _autograd_profiler._is_profiler_enabled:
            sp.end_ns = end
        else:
            self.over = True

    def read(self) -> list[Span]:
        if not _autograd_profiler._is_profiler_enabled:
            self.over = True
        return list(self.spans)


_RECORDER = _Recorder()


class _Recording:
    """A span being recorded (see the module note)."""

    __slots__ = ("name", "counts", "span")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts, self.span = name, counts, None

    def __enter__(self):
        self.span = _RECORDER.open(self.name, self.counts)
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            _RECORDER.close(self.span)
        return False

    def count(self, **counts):
        self.counts.update(counts)


def span(name: str, **counts):
    """A context manager marking the block as the span `name` with the host
    integers `counts`; records only while a torch.profiler session
    does."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recording(name, counts)


def spans() -> list[Span]:
    """The spans of the latest profiler session, in the order they
    opened."""
    return _RECORDER.read()


def dropped() -> int:
    """The spans of the latest session refused past ``MAX_SPANS``."""
    return _RECORDER.dropped


def _chrome_events(recorded: list[Span], base_ns: int, pid: int) -> list:
    """The closed spans as Chrome-trace complete events on each thread's
    host track, in us from `base_ns` (the trace's
    ``baseTimeNanoseconds``)."""
    out = []
    for i, sp in enumerate(recorded):
        if sp.end_ns is None:
            continue
        out.append({"ph": "X", "cat": "program_span", "name": sp.name,
                    "pid": pid, "tid": sp.thread,
                    "ts": (sp.start_ns - base_ns) / 1e3,
                    "dur": (sp.end_ns - sp.start_ns) / 1e3,
                    "args": {"index": i, "parent": sp.parent,
                             "trace": sp.trace, **sp.counts}})
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (host operators, and the card's
    kernels when it has one) with the spans recorded in it, written to
    ``log_dir/trace.json`` in the Chrome trace format (chrome://tracing,
    Perfetto): the spans lie over the kernels on the file's own clock.
    Yields the profiler, whose ``key_averages()`` sums the time by
    operator."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    _RECORDER.over = True  # this block's spans start a new list
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += _chrome_events(
        spans(), int(doc.get("baseTimeNanoseconds", 0)), os.getpid())
    with open(path, "w") as f:
        json.dump(doc, f)
