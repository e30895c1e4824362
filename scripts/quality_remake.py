"""Remake the quality suite's nets through the port's tool, then label the
v1 suite with the committed nets and with the remade ones.

    python3 scripts/quality_remake.py [--out DIR] [--device cpu] [--small]

DIR (default data/quality_remake, listed in .gitignore) receives the
suites, the nets and result.json.

1. ``python -m sdflabel_tpu_torch.tools.quality_suite`` with the JAX
   script's defaults, each step timed: ``--profile v1`` (3500 fit steps,
   60 frames from the fitted decoder, 4000 CSS steps at width 16), then
   ``--profile v2 --weak-steps 800`` (its own fit, 72 frames, 6000 CSS
   steps at width 24 and the weak net), the nets into DIR/nets_v1 and
   DIR/nets_v2, never into data/quality_nets.
2. The fitted decoders' L1 on a fixed point set
   (tools/quality_suite.py::fit_eval_l1) beside the committed
   deepsdf_quality.pt's.
3. The port's KITTI driver (batched, chip_smoke.py::quality_cfgp's
   settings: 60 iterations, float16, the stock warm band) and
   evaluate_dump over two v1 suites of 60 frames: the one step 1 built
   from the fitted decoder, and the one the committed decoder gives
   (``--skip-fit``). Each is labelled with the committed decoder and
   css_quality.msgpack and with the remade v1 nets: KITTI 3D, BEV and AOS
   AP per difficulty and the cars labelled.

Prints the card's name and power limit first, and a JSON line of every
number last (also DIR/result.json). ``--small`` cuts every count to a
rehearsal's (2 fit steps, 1 frame, 1 CSS step at width 8, 2 iterations).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sdflabel_tpu_torch.models import deepsdf  # noqa: E402
from sdflabel_tpu_torch.pipelines import evaluate_dump  # noqa: E402
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402
from sdflabel_tpu_torch.tools import quality_suite as qs  # noqa: E402


def label(suite: str, dsdf: str, css: str, work: str, iters: int,
          device) -> dict:
    """The port's driver over `suite` with the decoder `dsdf` and the
    width-16 CSS net `css`, then the evaluation."""
    labels = os.path.join(work, "labels")
    shutil.rmtree(labels, ignore_errors=True)
    cfgp = chip_smoke.quality_cfgp(suite, labels, iters)
    cfgp["input"].update({"css_path": css, "css_width": "16",
                          "deepsdf_path": dsdf})
    t0 = time.perf_counter()
    annos, ests = pipe.refine_css(cfgp, device=device)
    wall = time.perf_counter() - t0
    results = evaluate_dump.evaluate(cfgp, (0, 1, 2), device=device)
    names = ("easy", "moderate", "hard")

    def per_diff(arr):
        a = np.asarray(arr)
        return {names[d]: [float(v) for v in a[0, d]] for d in range(3)}

    return {"cars": sum(len(a["location"]) for a in annos.values()),
            "labelled": sum(len(e["location"]) for e in ests.values()),
            "driver_s": wall,
            "kitti_3d_ap": per_diff(results[0]["Box3DAP"]),
            "bev_ap": per_diff(results[0]["BevAP"]),
            "aos_ap": per_diff(results[0]["AosAP_iou"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("data",
                                                  "quality_remake"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"card: {chip_smoke.gpu_line()}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    small = ["--fit-steps", "2", "--frames", "1", "--css-steps", "1",
             "--css-width", "8"] if args.small else []
    iters = 2 if args.small else 60
    out = {"card": chip_smoke.gpu_line() if dev.type == "cuda" else None}

    # 1. the remake, as the JAX script's defaults run it
    runs = {"v1": ["--profile", "v1"],
            "v2": ["--profile", "v2", "--weak-steps",
                   "1" if args.small else "800"]}
    for name, flags in runs.items():
        meta, seconds = qs.main(flags + small + [
            "--out", os.path.join(args.out, f"suite_{name}"),
            "--nets-out", os.path.join(args.out, f"nets_{name}"),
            "--device", args.device])
        out[f"remake_{name}"] = {"seconds": seconds, "frames": meta["frames"],
                                 "cars": meta["objects"],
                                 "tiers": meta["difficulty_tiers"]}
        print(f"remake {name}: {json.dumps(out[f'remake_{name}'])}",
              flush=True)

    # 2. the decoders on the fixed point set
    l1 = {}
    for name, path in (("committed", os.path.join(qs.NETS,
                                                  "deepsdf_quality.pt")),
                       ("remade_v1", os.path.join(args.out, "nets_v1",
                                                  "deepsdf_quality.pt")),
                       ("remade_v2", os.path.join(args.out, "nets_v2",
                                                  "deepsdf_quality.pt"))):
        cfg, params = deepsdf.load_torch_checkpoint(path, device=dev)
        l1[name] = qs.fit_eval_l1(cfg, params)
    out["fit_eval_l1"] = l1
    print(f"fixed-set L1: {json.dumps(l1)}; remade / committed "
          f"{l1['remade_v1'] / l1['committed']:.4f}", flush=True)

    # 3. the v1 suites labelled by each set of nets
    committed_suite = os.path.join(args.out, "suite_v1_committed")
    qs.build_suite(committed_suite, 1 if args.small else None, "v1",
                   device=dev)
    suites = {"remade_frames": os.path.join(args.out, "suite_v1"),
              "committed_frames": committed_suite}
    nets = {"committed_nets": (os.path.join(qs.NETS, "deepsdf_quality.pt"),
                               os.path.join(qs.NETS, "css_quality.msgpack")),
            "remade_nets": (os.path.join(args.out, "nets_v1",
                                         "deepsdf_quality.pt"),
                            os.path.join(args.out, "nets_v1",
                                         "css_quality.msgpack"))}
    if args.small:  # the rehearsal's nets are width 8
        nets.pop("remade_nets")
    out["labels"] = {}
    for sname, suite in suites.items():
        for nname, (dsdf, css) in nets.items():
            key = f"{sname}/{nname}"
            out["labels"][key] = label(suite, dsdf, css,
                                       os.path.join(args.out, "work"),
                                       iters, dev)
            print(f"{key}: {json.dumps(out['labels'][key])}", flush=True)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
