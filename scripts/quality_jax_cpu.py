"""The JAX driver's label quality on the v2 quality suite, on the CPU, with
the settings of the port's quality phase (chip_smoke.py::quality_cfgp).

    python scripts/quality_jax_cpu.py --suite DIR [--frames 24,72]
        [--out QUALITY_jax_cpu_v2.json]

DIR is a v2 suite tree (``scripts/make_quality_suite.py --profile v2
--skip-fit --skip-css`` or ``python -m sdflabel_tpu_torch.tools.quality_suite
--frames 72 --out DIR``: the same 148 cars). For each frame count the JAX
driver (``sdflabel_tpu.pipelines.refine_css.refine_css``, sequential) labels
the first N frames, and the JAX evaluator gives KITTI 3D / BEV / AOS and
nuScenes AP per difficulty (scripts/run_quality_benchmark.py's
``structured_map``), with the per-object errors of ``per_object_diagnostics``
and every label, so that a port's labels can be matched object by object.

Settings: 60 iterations, kabsch, float16 (the bf16 decode), warm band 8192
refreshed every 10 iterations, the committed quality nets, CSS width 24,
difficulties 0-2. ``select_pallas`` and ``stage2_pallas`` are asked for, as
the port's phase asks, but the JAX runtime takes its Pallas kernels only on
a TPU backend: on the CPU the selection decode, the stage-2 decode, the
nearest neighbour and the splat all run their plain XLA routes. Each frame
count writes its row when it ends and keeps the file's other rows, so
the counts may run as separate processes.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from run_quality_benchmark import (  # noqa: E402
    backfill, build_cfgp, per_object_diagnostics, structured_map)

SETTINGS = {"warm_band": "8192", "warm_refresh": "10",
            "select_pallas": "True", "stage2_pallas": "True"}
CSS_WIDTH = 24


def labels_of(estims) -> dict:
    """Every frame's labels: location, dimensions (h, w, l), rotation_y."""
    out = {}
    for frame, est in estims.items():
        out[f"{int(frame):06d}"] = {
            k: np.asarray(est.get(k, np.zeros((0,))), np.float64)
            .round(6).tolist()
            for k in ("location", "dimensions", "rotation_y")}
    return out


def run(suite: str, nets: str, frames: int, conditions: dict) -> dict:
    from sdflabel_tpu.pipelines import refine_css as pipeline

    tmp = tempfile.mkdtemp(prefix="quality_jax_cpu_")
    try:
        cfgp = build_cfgp(suite, nets, os.path.join(tmp, "labels"), SETTINGS,
                          CSS_WIDTH, "css_quality_v2.msgpack", "hard", False)
        t0 = time.perf_counter()
        annos, estims = pipeline.refine_css(cfgp, batched=False,
                                            subset_frames=range(frames))
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gt_list = list(annos.values())
    est_list = [backfill(e) for e in estims.values()]
    return {"frames": len(gt_list),
            "gt_boxes": sum(len(a.get("location", [])) for a in gt_list),
            "est_boxes": sum(len(e.get("location", [])) for e in est_list),
            "cpu_wall_s": round(wall, 1),
            **structured_map(gt_list, est_list, (0, 1, 2)),
            "objects": per_object_diagnostics(annos, estims, conditions),
            "labels": labels_of(estims)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", required=True)
    ap.add_argument("--nets", default=os.path.join(REPO, "data",
                                                   "quality_nets"))
    ap.add_argument("--frames", default="24,72")
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "QUALITY_jax_cpu_v2.json"))
    args = ap.parse_args()
    if jax.default_backend() != "cpu":
        print("quality_jax_cpu: JAX is not on the CPU", file=sys.stderr)
        return 2
    meta = json.load(open(os.path.join(args.suite, "suite_meta.json")))
    result = {"suite": {k: v for k, v in meta.items() if k != "conditions"},
              "backend": "cpu", "driver": "sdflabel_tpu refine_css, "
              "sequential", "settings": {**SETTINGS, "iters": "60",
                                         "precision": "float16",
                                         "pose_estimator": "kabsch",
                                         "css_width": str(CSS_WIDTH)},
              "plain_routes": "select_pallas, stage2_pallas, the nearest "
              "neighbour and the splat take their XLA routes off a TPU",
              "difficulties": [0, 1, 2], "rows": {}}
    for frames in (int(f) for f in args.frames.split(",")):
        print(f"=== {frames} frames ===", flush=True)
        row = run(args.suite, args.nets, frames, meta.get("conditions", {}))
        print(json.dumps({k: v for k, v in row.items() if k != "labels"}),
              flush=True)
        # rows of other frame counts, written by another run, stay
        if os.path.exists(args.out):
            result["rows"] = json.load(open(args.out)).get("rows", {})
        result["rows"][str(frames)] = row
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print("wrote", args.out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
