"""Do the batched refine's lanes leave each crop refined alone in JAX too?

    python3 scripts/batched_lanes_jax.py [--precision float16] [--iters 60]
        [--out FILE]

Runs on the CPU (JAX and the port both). The four crops of chip_smoke.py's
phase 4d (``shifted_crops`` of the port's ``prepare_crop`` of the demo
frame), the seeded 8x512 DeepSDF of ``chip_smoke.decoder_8x512`` (carried
into JAX as numpy arrays of the same tree), the stock
configs/config_refine.ini (warm band 8192 refreshed every 10) at
`--precision` (float16 decodes in bf16, float32 in fp32), refined through

  (1) JAX's ``parallel/batched_refine.py::make_batched_refine`` (vmap),
  (2) JAX's ``engine/refine.py::make_refine_fn``, one crop at a time,
  (3) the port's ``refine_crops_batched`` refine (``make_batched_refine``
      on ``batch_inputs``),
  (4) the port's ``run_refine``, one crop at a time,
  (5) JAX's ``make_refine_fn`` from a start whose translation is moved by
      1e-6: how far JAX's own refine carries an ulp-sized change.

Every route ranks the band with the decoder itself (the selection route
JAX takes on the CPU; the port's selection kernel is not asked for). For
the pairs (1)-(2), (3)-(1), (4)-(2), (3)-(4) and (5)-(2) it prints each
crop's label gap after the last iteration (location in m, rotation_y in
rad; every label is built by the port's label code from that route's
final parameters) and the first iteration whose parameters differ by more
than 1e-6. A JSON line of every number last.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sdflabel_tpu.engine import refine as jref  # noqa: E402
from sdflabel_tpu.models import deepsdf as jds  # noqa: E402
from sdflabel_tpu.ops import grid as jgrid  # noqa: E402
from sdflabel_tpu.parallel import batched_refine as jbr  # noqa: E402
from sdflabel_tpu_torch.engine import labels as labels_mod  # noqa: E402
from sdflabel_tpu_torch.models import deepsdf as tds  # noqa: E402
from sdflabel_tpu_torch.parallel import batched_refine as tbr  # noqa: E402
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402


def jax_decoder(cfg512, params512, precision: str):
    """The JAX runtime's decoder (refine_css.py:109-130) on the port's
    seeded weights."""
    jcfg = jds.DeepSDFConfig(**dataclasses.asdict(cfg512))
    # the inverse of the port's params_from_jax: the same tree, numpy
    # leaves
    tree = tds._map_tree(lambda t: jnp.asarray(t.float().cpu().numpy()),
                         params512)
    if precision == "float32":
        return jds.sdf_fn(jcfg, tree)
    tree = jax.tree.map(lambda x: x.astype(jnp.bfloat16), tree)
    base = jds.sdf_fn(jcfg, tree)
    return lambda lat, p: base(lat.astype(jnp.bfloat16),
                               p.astype(jnp.bfloat16)).astype(jnp.float32)


def letterbox(crop: dict, bucket: int):
    """run_refine's inputs for one crop: (bh, bw), the NOCS target and
    the pixel mask letterboxed into it."""
    h, w = crop["crop_hw"]
    bh, bw = -(-h // bucket) * bucket, -(-w // bucket) * bucket
    nocs = np.zeros((3, bh, bw), np.float32)
    nocs[:, :h, :w] = crop["nocs_target"]
    pmask = np.zeros((bh, bw), bool)
    pmask[:h, :w] = True
    return (bh, bw), nocs, pmask


def host(params) -> list[np.ndarray]:
    return [np.asarray(t.detach().cpu() if torch.is_tensor(t) else t,
                       np.float64) for t in params]


def first_over(a: list, b: list, tol: float = 1e-6):
    """(first iteration whose used parameters differ by more than tol,
    largest gap over all iterations); a, b: (iters, .) per field."""
    g = np.max([np.abs(x - y).max(-1) for x, y in zip(a, b)], axis=0)
    off = np.nonzero(g > tol)[0]
    return (int(off[0]) if len(off) else None), float(g.max())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--precision", default="float16",
                    choices=("float16", "float32"))
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    t_start = time.perf_counter()
    dev = torch.device("cpu")
    demo = pipe.cfg_mod.RefineCfg.from_ini(pipe.cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_demo.ini")))
    rt_demo = pipe.setup_runtime(dataclasses.replace(demo, viz_type="none"),
                                 device=dev)
    sample = pipe.load_demo_sample(os.path.join(ROOT, "data",
                                                "optimization"))
    anno = pipe.kitti_mod.get_annos(demo.diff_annos, sample)[0]
    prep = pipe.prepare_crop(rt_demo, sample, anno)
    crops = chip_smoke.shifted_crops(prep)
    cfg512, params512 = chip_smoke.decoder_8x512(dev)
    stock = pipe.cfg_mod.RefineCfg.from_ini(pipe.cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_refine.ini")))
    stock = dataclasses.replace(stock, precision=args.precision,
                                iters=args.iters)
    rt = pipe.RefineRuntime(stock, rt_demo.css, cfg512, params512,
                            device=dev)
    rt.select_decoder = None  # rank with the decoder, as JAX on the CPU
    rcfg = rt.refine_config()
    jcfg = jref.RefineConfig(
        iters=rcfg.iters, weight_2d=rcfg.weight_2d, weight_3d=rcfg.weight_3d,
        surface_capacity=rcfg.surface_capacity, warm_band=rcfg.warm_band,
        warm_refresh=rcfg.warm_refresh)
    jdec = jax_decoder(cfg512, params512, args.precision)
    jgrid_pts = jgrid.generate_point_grid(stock.grid_density)
    bucket_px = stock.render_bucket or 1
    seconds, params_hist, finals = {}, {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        print(f"{name}: {seconds[name]:.1f} s", flush=True)
        return out

    # (1) JAX, all four crops in one vmapped program
    bucket, inputs = pipe.batch_inputs(rt, crops)
    p0, K, nocs, frustum, fmask, pmask = inputs
    jp0 = jref.RefineParams(*(jnp.asarray(t.numpy()) for t in p0))
    jfinal, jhist = timed("1 jax batched", lambda: jax.block_until_ready(
        jbr.make_batched_refine(jdec, jcfg, jgrid_pts, bucket)(
            jp0, *(jnp.asarray(t.numpy()) for t in
                   (K, nocs, frustum, fmask, pmask)))))
    n = len(crops)
    params_hist["1"] = [[np.asarray(f, np.float64)[i]
                         for f in jhist.params] for i in range(n)]
    finals["1"] = [[np.asarray(f, np.float64)[i] for f in jfinal]
                   for i in range(n)]

    # (2) JAX, one crop at a time; (5) the same from a start moved by 1e-6.
    # One program per bucket, the intrinsics an argument (as the JAX
    # runtime's refine_fn)
    programs = {}

    def jax_alone(crop, dtrans=0.0):
        hw, nocs_i, pmask_i = letterbox(crop, bucket_px)
        if hw not in programs:
            programs[hw] = jax.jit(
                lambda p, k, *a, hw=hw: jref.make_refine_fn(
                    jdec, jcfg, jgrid_pts, k, hw)(p, *a))
        q = crop["params0"]
        start = jref.RefineParams(
            jnp.asarray(q.yaw.numpy()), jnp.asarray(q.trans.numpy() + dtrans),
            jnp.asarray(q.scale.numpy()), jnp.asarray(q.latent.numpy()))
        final, hist = jax.block_until_ready(programs[hw](
            start, jnp.asarray(crop["intrinsics"]), jnp.asarray(nocs_i), jnp.asarray(crop["frustum"]),
            jnp.asarray(crop["fmask"]), jnp.asarray(pmask_i)))
        return host(final), host(hist.params)

    for key, dtrans in (("2", 0.0), ("5", 1e-6)):
        out = timed(f"{key} jax alone" + (" moved" if dtrans else ""),
                    lambda: [jax_alone(c, dtrans) for c in crops])
        finals[key] = [o[0] for o in out]
        params_hist[key] = [o[1] for o in out]

    # (3) the port, all four crops at once
    tfinal, thist = timed("3 port batched", lambda: tbr.make_batched_refine(
        rt.decoder, rcfg, rt.grid_points, bucket, device=dev)(*inputs))
    params_hist["3"] = [[np.asarray(f[i], np.float64) for f in thist.params]
                        for i in range(n)]
    finals["3"] = [[np.asarray(f[i], np.float64) for f in tfinal]
                   for i in range(n)]

    # (4) the port, one crop at a time
    out = timed("4 port alone", lambda: [rt.run_refine(c)[:2] for c in crops])
    finals["4"] = [host(o[0]) for o in out]
    params_hist["4"] = [host(o[1].params) for o in out]

    def label(final, crop):
        lat = torch.as_tensor(final[3], dtype=torch.float32)
        ext = labels_mod.surface_extents(
            rt.decoder, rt.grid_points, lat, capacity=rt.surface_capacity,
            threshold=rcfg.surface_threshold)
        return pipe.finish_label(pipe.refine_mod.RefineParams(*final), ext,
                                 sample, crop["anno"])

    labels = {k: [label(f, c) for f, c in zip(v, crops)]
              for k, v in finals.items()}

    def label_gap(a, b):
        dyaw = abs(float(a["rotation_y"]) - float(b["rotation_y"]))
        return (float(np.abs(np.asarray(a["location"], float)
                             - np.asarray(b["location"], float)).max()),
                float(min(dyaw, 2 * np.pi - dyaw)))

    result = {"precision": args.precision, "iters": args.iters,
              "seconds": seconds, "pairs": {}}
    names = {"1": "jax batched", "2": "jax alone", "3": "port batched",
             "4": "port alone", "5": "jax alone, start moved by 1e-6"}
    for a, b in (("1", "2"), ("3", "1"), ("4", "2"), ("3", "4"),
                 ("5", "2")):
        rows = []
        for i in range(n):
            loc, yaw = label_gap(labels[a][i], labels[b][i])
            it, worst = first_over(params_hist[a][i], params_hist[b][i])
            rows.append({"location_m": loc, "rotation_y_rad": yaw,
                         "first_iteration_over_1e-6": it,
                         "max_param_gap": worst})
            print(f"({a}) {names[a]} against ({b}) {names[b]}, crop {i}: "
                  f"|d location| {loc:.3g} m, |d rotation_y| {yaw:.3g} rad; "
                  f"parameters part by > 1e-6 first at iteration {it}, "
                  f"at most {worst:.3g}", flush=True)
        result["pairs"][f"{a}-{b}"] = rows
    result["wall_s"] = time.perf_counter() - t_start
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
