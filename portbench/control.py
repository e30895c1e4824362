"""The readings a cell's limits are set from, on the card, at the cell's
own size: the program's over many seeds, and the control's (the reference
in the program's place, one precision below the configuration's) or a
planted fault's on the same runs. Not part of a benchmark run.

    python3 portbench/control.py --workload refine_b4 --seconds 4 \
        --seeds 11 12 13 --control fp8 [--out readings.jsonl]

One process sets up each seed in turn (the kernels build once), runs a
short window at the cell's load, and prints one JSON line a seed:
{"seed", "program": {number: reading}, "<control>": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from portbench import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    common.cache_env()
    bench, cell, config, traffic = common.load_cell(args.workload)
    torch = common.require_cards(cell["chips"])
    for line in common.card_lines():
        print(f"card: {line}", file=sys.stderr)
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            job = common.load_job(traffic["job"]).Job(config, traffic, seed,
                                                      "cuda")
            try:
                job.setup()
                units, window_s = common.closed_loop(job.unit, args.seconds,
                                                     job.sync)
                att, failed = job.attempted_failed()
                job.release()
                row = {"seed": seed, "units": units, "window_s": window_s,
                       "attempted": att, "failed": failed,
                       "program": job.check()}
                row["skipped_leaves"] = getattr(job, "skipped_leaves", [])
                row["worst_leaves"] = getattr(job, "worst_leaves", {})
                for kind in args.control:
                    row[kind] = job.check(control=kind)
            finally:
                job.close()
            row["seconds"] = time.perf_counter() - t0
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del job
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
