"""Where the batched refine and a crop refined alone part, on the card.

    python3 scripts/batched_vs_alone.py [--stage2] [--out FILE]

Phase 4d's four crops (chip_smoke.py::shifted_crops of the demo frame's
prepared crop) under phase 4's runtime: the stock config_refine.ini with
the seeded 8x512 decoder, at `precision` float16 (the stock bf16 decode)
and float32. For each crop it compares two refines of the crop alone
(run_refine: run to run), a third from a start moved by 1e-6 (how far the
refine carries an ulp-sized change), and the batched refine
(refine_crops_batched's inputs) against the first of them, and against
the same crop alone through the batched loop (B = 1, the same bucket):
the first iteration whose parameters differ by more than 1e-6, and the
largest parameter gap at iterations 10, 30 and 60. ``--stage2`` runs
phase 4f's settings: ``stage2_pallas = True``, the stage-2 decode and its
backward through kernels 4a and 4b. Prints the card's name and power
limit first; a JSON line of every number last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sdflabel_tpu_torch.parallel import batched_refine  # noqa: E402
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402


def gaps(a, b) -> torch.Tensor:
    """(iters,) largest |a - b| over the parameters used at each
    iteration (yaw, trans, scale, latent)."""
    return torch.stack([(x - y).abs().amax(-1) for x, y in zip(a, b)]
                       ).amax(0)


def summary(g: torch.Tensor) -> dict:
    off = (g > 1e-6).nonzero()
    return {"first_iteration_over_1e-6": int(off[0]) if len(off) else None,
            **{f"gap_at_{i}": float(g[i - 1]) for i in (10, 30, len(g))}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--stage2", action="store_true",
                    help="stage2_pallas = True (kernels 4a and 4b)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("batched_vs_alone: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(chip_smoke.gpu_line())
    rt_demo, sample, prep, _ = chip_smoke.demo_phase(dev)
    crops = chip_smoke.shifted_crops(prep)
    cfg512, params512 = chip_smoke.decoder_8x512(dev)
    stock = pipe.cfg_mod.RefineCfg.from_ini(pipe.cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_refine.ini")))
    result = {"card": chip_smoke.gpu_line()}
    for precision in ("float16", "float32"):
        rt = pipe.RefineRuntime(dataclasses.replace(
            stock, precision=precision, stage2_pallas=args.stage2),
            rt_demo.css, cfg512, params512, device=dev)
        kw = dict(select_decoder=rt.select_decoder, stage2_fn=rt.stage2_fn,
                  device=dev)
        # each crop alone twice, then from a start moved by 1e-6 (its
        # translation): how far an ulp-sized change carries in 60 steps
        alone = [[rt.run_refine(c)[1].params for _ in range(2)]
                 + [rt.run_refine(dict(c, params0=c["params0"]._replace(
                     trans=c["params0"].trans + 1e-6)))[1].params]
                 for c in crops]
        bucket, inputs = pipe.batch_inputs(rt, crops)
        _, hist = batched_refine.make_batched_refine(
            rt.decoder, rt.refine_config(), rt.grid_points, bucket,
            **kw)(*inputs)
        key = precision + ("_stage2" if args.stage2 else "")
        result[key] = []
        for i, (a, b, moved) in enumerate(alone):
            # crop i alone through the batched loop (B = 1), in the
            # same bucket
            lane = [type(x)(*(t[i:i + 1] for t in x))
                    if isinstance(x, tuple) else x[i:i + 1]
                    for x in inputs]
            _, one = batched_refine.make_batched_refine(
                rt.decoder, rt.refine_config(), rt.grid_points, bucket,
                **kw)(*lane)
            row = {"run_to_run": summary(gaps(a, b)),
                   "start_moved_1e-6": summary(gaps(a, moved)),
                   "batched": summary(gaps(a, [t[i] for t in
                                               hist.params])),
                   "batched_vs_b1": summary(gaps(
                       [t[0] for t in one.params],
                       [t[i] for t in hist.params]))}
            result[key].append(row)
            print(f"{key}, crop {i}: {json.dumps(row)}", flush=True)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
