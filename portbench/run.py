"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights and inputs from the seed, on the card; every shape of the
cell warmed up), then a closed loop for `--seconds` (and on to the end of
a whole pass where the job cycles through a pool of unequal units), then
the check against the plain reference. With ``--trace 0`` the line carries the cell's
end-to-end metrics (a cell with one read from the card's trace runs its
window under torch.profiler); with ``--trace 1`` a shorter window runs
under torch.profiler and the line carries its per-layer metrics, the
device's busy time and a breakdown. The last line of standard output is one JSON
object; the numbers compared and their limits end standard error.
Without a CUDA card (or with fewer than the cell asks for) it prints no
result and exits 2; if the JAX stack or the JAX package is loaded once
the window has closed, it prints none and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import common  # noqa: E402



def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device: str = "cuda", cell_files=None) -> int:
    """One run. `cell_files` (bench, cell, config, traffic) and `device`
    replace the checkout's files and the card for the harness's own
    tests."""
    common.cache_env()
    bench, cell, config, traffic = (cell_files or common.load_cell(
        args.workload))
    if device == "cuda":
        try:
            torch = common.require_cards(cell["chips"])
        except common.NoCard as e:
            print(f"portbench: {e}; no result", file=sys.stderr)
            return 2
        for line in common.card_lines():
            print(f"card: {line}", file=sys.stderr)
        print(f"cards: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}", file=sys.stderr)
    job = common.load_job(traffic["job"]).Job(config, traffic, args.seed,
                                              device)
    try:
        return _measure(args, job, bench, cell, traffic, device)
    finally:
        job.close()


def _measure(args, job, bench, cell, traffic, device) -> int:
    import torch

    job.setup()
    job.sync()
    print(f"portbench: set-up done at {time.perf_counter() - T_START:.3f} s "
          f"({', '.join(f'{k} {v:.3f} s' for k, v in job.setup_times)})",
          file=sys.stderr)
    setup_s = time.perf_counter() - T_START
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()

    trace = None
    whole = getattr(job, "units_per_pass", 1)
    if args.trace:
        units, window_s, trace = common.profile_window(
            lambda: common.closed_loop(job.unit, args.seconds, job.sync,
                                       traffic["trace_units"]))
    elif any(m["source"] == "device_trace"
             for m in common.cell_metrics(bench, cell, trace=False)):
        # an end-to-end metric read from the card's trace: the whole
        # window runs under the profiler
        units, window_s, trace = common.profile_window(
            lambda: common.closed_loop(job.unit, args.seconds, job.sync,
                                       whole=whole))
    else:
        units, window_s = common.closed_loop(job.unit, args.seconds,
                                             job.sync, whole=whole)
    e2e = job.end_to_end(units, window_s)
    peak = (torch.cuda.max_memory_allocated() if device == "cuda" else 0)
    attempted, failed = job.attempted_failed()
    job.release()
    t_check = time.perf_counter()
    readings = job.check(sample_all=bool(args.trace))
    print(f"portbench: check {time.perf_counter() - t_check:.3f} s; worst "
          f"leaves {getattr(job, 'worst_leaves', {})}; leaves left out of "
          f"the change: {getattr(job, 'skipped_leaves', [])}",
          file=sys.stderr)
    compared = common.judge(readings, job.limits())
    correct = all(c["ok"] for c in compared.values()) and failed == 0

    metrics = {}
    ctx = {"trace": trace, "window_s": window_s, **job.layer_context()}
    values = {"setup_s": setup_s, **e2e}
    for m in common.cell_metrics(bench, cell, trace=bool(args.trace)):
        # per-layer metrics and end-to-end ones from the trace have a
        # reader of their own; one that finds nothing to read gives None
        if args.trace or m["source"] == "device_trace":
            value = common.load_reader(m["name"])(ctx)
        else:
            value = values[m["name"]]
        if value is not None:
            metrics[m["name"]] = common.metric_entry(value, m["unit"])
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0)
                            if device == "cuda" else device),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        device_info["busy_s"] = trace.busy_s()
        device_info["window_s"] = window_s
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps()}
    print("portbench: unit seconds "
          + " ".join(f"{u:.3f}" for u in common.UNIT_SECONDS), file=sys.stderr)
    if trace is not None:
        print(f"portbench: card busy {trace.busy_s():.6f} s of the window",
              file=sys.stderr)
    print(f"portbench: {units} units in {window_s:.3f} s, set-up "
          f"{setup_s:.3f} s, {attempted} attempted, {failed} failed",
          file=sys.stderr)
    found = common.forbidden_modules()
    if found:
        print(f"portbench: the process holds {found}; no result",
              file=sys.stderr)
        return 3
    common.emit(correct, attempted, failed, metrics, device_info, compared,
                breakdown)
    return 0


def main(argv=None) -> int:
    return run(parse(argv))


if __name__ == "__main__":
    sys.exit(main())
