"""The harness's shared machinery: the cell's files, the card, the measured
window, the trace and its reduction, and the result line.

A cell of BENCHMARK.json names a configuration (its file under
portbench/configs/) and a traffic mix (portbench/traffic/<name>.json); the
mix's "job" names the module under portbench/jobs/ that drives it, and each
per-layer metric is a reader of its own (portbench/metrics/<name>.py). The
harness finds every one of them by name: a later cell adds files and
entries, and edits none.
"""

from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names no process of the benchmark may hold: the JAX
# stack and the JAX package the port was made from (compared whole, so
# sdflabel_tpu_torch is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "sdflabel_tpu")


class NoCard(RuntimeError):
    """The run needs more CUDA cards than this machine shows."""


def forbidden_modules(modules=None) -> list[str]:
    """The FORBIDDEN top-level names that `modules` (default sys.modules)
    holds."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def cache_env(root: str = ROOT) -> None:
    """Fixed cache directories inside the checkout for what the program or
    torch may compile (the port's own kernels build into
    sdflabel_tpu_torch/csrc/build/, also inside it)."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT):
    """(benchmark, cell, configuration, traffic) of the named workload."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic",
                                     cell["traffic"] + ".json"))
    return bench, cell, config, traffic


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metric entries this cell reports: its end-to-end ones, or with
    `trace` its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def load_job(name: str):
    """portbench/jobs/<name>.py."""
    return importlib.import_module(f"portbench.jobs.{name}")


def load_reader(name: str) -> Callable:
    """portbench/metrics/<name>.py's `read(ctx)`; the file is named after
    the metric, dots and all, so it is loaded by its path."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def require_cards(n: int):
    """The torch module, once `n` CUDA cards are there; NoCard otherwise.
    Nothing falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < n:
        raise NoCard(f"the cell needs {n} cards, torch sees "
                     f"{torch.cuda.device_count()}")
    return torch


def card_lines() -> list[str]:
    """The card's name, count and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = [f"nvidia-smi failed: {e}"]
    return out


class Stopwatch:
    """Named laps of a job's set-up, each ended synchronised with the
    card; `laps` [(name, seconds)] go to the run's log."""

    def __init__(self, sync: Callable[[], None]):
        self.sync, self.laps, self.t0 = sync, [], time.perf_counter()

    def lap(self, name: str) -> None:
        self.sync()
        now = time.perf_counter()
        self.laps.append((name, now - self.t0))
        self.t0 = now


# the seconds each unit of the last window took (for the run's log)
UNIT_SECONDS: list[float] = []


def closed_loop(unit: Callable[[], None], seconds: float,
                sync: Callable[[], None], max_units: int | None = None,
                whole: int = 1) -> tuple[int, float]:
    """Run `unit` one after another until `seconds` have passed and the
    units run are a multiple of `whole` (a job whose units cycle through a
    pool of unequal work ends on a whole pass, so every run does the same
    work), or until `max_units` have run; each unit ends synchronised with
    the card. Returns (units run, window seconds), the window ending when
    the last unit has."""
    n = 0
    t0 = last = time.perf_counter()
    UNIT_SECONDS.clear()
    while True:
        unit()
        sync()
        n += 1
        now = time.perf_counter()
        UNIT_SECONDS.append(now - last)
        last = now
        if (now - t0 >= seconds and n % whole == 0) or n == max_units:
            break
    return n, time.perf_counter() - t0


# ------------------------------------------------------------------ trace

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync", "cuMemcpyAsync", "cuMemsetD8Async",
                "cuMemsetD32Async", "cuMemcpyHtoDAsync_v2",
                "cuMemcpyDtoHAsync_v2", "cuMemcpyDtoDAsync_v2")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """The device side of a profiled window: device operations (kernels,
    copies, fills) as (name, start us, duration us), host launch calls, and
    the host's operators, all on one clock."""

    def __init__(self, events: list[dict]):
        self.device = []
        self.launches = []
        self.host = []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            item = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
            if cat in DEVICE_CATS:
                self.device.append(item)
            elif cat in ("cuda_runtime", "cuda_driver"):
                if item[0] in LAUNCH_CALLS:
                    self.launches.append(item)
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                self.host.append(item)
        self.device.sort(key=lambda x: x[1])
        self.host.sort(key=lambda x: x[1])

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in us."""
        out: list[list[float]] = []
        for _, ts, dur in self.device:
            end = ts + dur
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([ts, end])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_time_s(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose name `match`es."""
        return sum(d for n, _, d in self.device if match(n)) / 1e6

    def top_ops(self, k: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for n, _, d in self.device:
            key = n[:120]
            tot[key] = tot.get(key, 0.0) + d
        top = sorted(tot.items(), key=lambda x: -x[1])[:k]
        return [[n, v / 1e6] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The k longest idle gaps between device operations, each named by
        the innermost host operator running at the gap's start when the
        trace has host operators, else by the device operation the host
        launched to end it ("before <name>")."""
        busy = self.busy_intervals()
        gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])
                if b1[0] > b0[1]]
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        starts = [h[1] for h in self.host]
        dev_starts = [d[1] for d in self.device]
        out = []
        for a, b in gaps[:k]:
            label = None
            i = bisect.bisect_right(starts, a) - 1
            # the latest-starting operator that still covers the gap start
            for j in range(i, max(-1, i - 4000), -1):
                n, ts, dur = self.host[j]
                if ts + dur >= a:
                    label = n
                    break
            if label is None:
                nxt = bisect.bisect_left(dev_starts, b)
                label = "before " + (self.device[nxt][0]
                                     if nxt < len(self.device) else "end")
            out.append([label[:120], (b - a) / 1e6])
        return out


# the card's activity alone (kernels, copies, fills and the host's CUDA
# calls): recording every host operator as well slowed a refine frame
# 1.7x and read the device idle 79% where it is 65% (an H100, 3 frames)
TRACE_ACTIVITIES = ("cuda",)


def profile_window(run: Callable[[], tuple[int, float]]):
    """Run `run` (a closed loop returning (units, window seconds)) under
    torch.profiler with the host and the card traced; returns (units,
    window seconds, Trace). The trace goes through a file in the run's
    TMPDIR, deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if cuda else []) \
        + ([ProfilerActivity.CPU] if "cpu" in TRACE_ACTIVITIES or not cuda
           else [])
    with profile(activities=acts) as prof:
        units, window_s = run()
        if cuda:
            torch.cuda.synchronize()
    t0 = time.perf_counter()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    trace = Trace(events)
    print(f"portbench: trace of {len(events)} events read in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return units, window_s, trace


# ----------------------------------------------------------------- result

def metric_entry(value: float, unit: str) -> dict:
    return {"value": float(value), "unit": unit}


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, compared: dict, breakdown: dict | None = None) -> None:
    """Print the compared numbers on standard error (last lines there),
    then the result line, last on standard output; `compared` last in
    it."""
    for name, c in compared.items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'OVER'})", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["compared"] = {k: {"value": _finite(v["value"]),
                            "limit": v["limit"]}
                        for k, v in compared.items()}
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def _finite(v):
    """A number JSON can carry: None for NaN, infinity or nothing."""
    return v if v is not None and math.isfinite(v) else None


def idle_share(ctx: dict):
    """The device's idle share of the traced window, in %: 1 - the union of
    its operations' intervals over the window."""
    tr = ctx["trace"]
    if not tr.device or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / ctx["window_s"])


def kernel_share(ctx: dict, patterns: tuple, least_s: float):
    """`least_s` over the device time of the kernels whose names hold one
    of `patterns` (and not "binned"), in %; None when none ran or no work
    was counted."""
    t = ctx["trace"].device_time_s(
        lambda n: "binned" not in n and any(p in n for p in patterns))
    if t <= 0 or not least_s:
        return None
    return 100.0 * least_s / t


def judge(readings: dict[str, float], limits: dict[str, float]) -> dict:
    """Each reading beside its limit: ok when finite and at most the limit
    (a NaN or a missing reading fails)."""
    out = {}
    for name, limit in limits.items():
        v = readings.get(name, math.nan)
        ok = v is not None and math.isfinite(v) and v <= limit
        out[name] = {"value": None if v is None else float(v),
                     "limit": float(limit), "ok": bool(ok)}
    return out
