"""Which operators of the batched refine give a crop another result than
the same loop with that crop alone (B = 1), on the card.

    python3 scripts/batched_lane_ops.py [--stage2] [--iters N]
        [--crops I ...] [--same | --stages] [--show K]

Phase 4d's four crops (chip_smoke.py::shifted_crops) under phase 4's
runtime (``--stage2``: phase 4f's, stage2_pallas = True), refined for N
iterations (default 12) by the batched loop (make_batched_refine) once
with all four crops and once with each crop alone in the same bucket
(``--same``: with that crop in all four lanes, so that both runs take
the same operators at the same shapes and a difference can only come
from another crop's data). ``--stages`` compares, in place of the
operators, the stages of each iteration: the stage-2 surface, the render,
the 3D and 2D losses and the gradients, and prints the first iteration
and stage where the crop's values part.
Every operator both runs dispatch is recorded in order with its outputs;
for each crop the two sequences are aligned on the operators' names and
calling lines (the crop-axis run loops over crops where the lone run
does not) and walked side by side, and the first ones
whose output for that crop differs from the lone run's are printed with
the largest difference and the line of the port that called them. The
hand-written kernels are no torch operators; their outputs show as the
inputs of the next one. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import difflib
import os
import sys
import traceback

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sdflabel_tpu_torch.engine import refine as refine_mod  # noqa: E402
from sdflabel_tpu_torch.parallel import batched_refine  # noqa: E402
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402


class Record(TorchDispatchMode):
    """Every operator's name, its tensor outputs (copies) and the port's
    innermost calling line."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        where = ""
        for frame in reversed(traceback.extract_stack(limit=40)):
            if "sdflabel_tpu_torch" in frame.filename:
                where = (f"{os.path.relpath(frame.filename, ROOT)}:"
                         f"{frame.lineno}")
                break
        self.ops.append((str(func), where, [
            t.detach().clone() for t in pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor)]))
        return out


def differ(a: torch.Tensor, b: torch.Tensor) -> float | None:
    """Largest |a - b| (inf where only one is NaN), None when equal."""
    if a.dtype == torch.bool or not a.is_floating_point():
        return None if torch.equal(a, b) else float("inf")
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return None
    d = (a.double() - b.double()).abs()
    return float(torch.where(same, torch.zeros_like(d), d).nan_to_num(
        float("inf")).max())


STAGES = (("surface", refine_mod.grid_ops, "surface_from_candidates"),
          ("render", refine_mod.rast_mod, "render"),
          ("loss_3d", refine_mod.losses, "loss_3d"),
          ("loss_2d", refine_mod.losses, "loss_2d"))


class StageRecord:
    """Inside `with`: every call of the loop's stages (STAGES) and every
    batch_step's gradients, in order, as (stage, tensors)."""

    def __init__(self):
        self.calls = []
        self.saved = []

    def _wrap(self, name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            self.calls.append((name, [t.detach().clone() for t in
                                      pytree.tree_leaves(out)
                                      if isinstance(t, torch.Tensor)]))
            return out
        return wrapped

    def __enter__(self):
        for name, mod, attr in STAGES + (
                ("grads", refine_mod, "batch_step"),):
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            if attr == "batch_step":
                def step(cfg, params, grads, ok, state, fn=fn):
                    self.calls.append(("grads", [g.detach().clone()
                                                 for g in grads]))
                    return fn(cfg, params, grads, ok, state)
                setattr(mod, attr, step)
            else:
                setattr(mod, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stage2", action="store_true")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--crops", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--show", type=int, default=8,
                    help="differing operators printed per crop")
    ap.add_argument("--stages", action="store_true",
                    help="compare the loop's stages, not its operators")
    ap.add_argument("--same", action="store_true",
                    help="the lone run repeats the crop in every lane")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("batched_lane_ops: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(chip_smoke.gpu_line())
    rt_demo, sample, prep, _ = chip_smoke.demo_phase(dev)
    cfg512, params512 = chip_smoke.decoder_8x512(dev)
    stock = pipe.cfg_mod.RefineCfg.from_ini(pipe.cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_refine.ini")))
    rt = pipe.RefineRuntime(dataclasses.replace(
        stock, iters=args.iters, stage2_pallas=args.stage2), rt_demo.css,
        cfg512, params512, device=dev)
    crops = chip_smoke.shifted_crops(prep)
    bucket, inputs = pipe.batch_inputs(rt, crops)

    def run(lane_inputs):
        fn = batched_refine.make_batched_refine(
            rt.decoder, rt.refine_config(), rt.grid_points, bucket,
            select_decoder=rt.select_decoder, stage2_fn=rt.stage2_fn,
            device=dev)
        rec = StageRecord() if args.stages else Record()
        with rec:
            _, hist = fn(*lane_inputs)
        torch.cuda.synchronize()
        if args.stages:
            return [(name, "", ts) for name, ts in rec.calls], hist
        return rec.ops, hist

    ops4, hist4 = run(inputs)
    b = hist4.loss.shape[0]
    for i in args.crops:
        rows = [i] * b if args.same else [i]
        lane = [type(x)(*(t[rows] for t in x)) if isinstance(x, tuple)
                else x[rows] for x in inputs]
        ops1, hist1 = run(lane)
        nb1 = len(rows)
        gap = torch.stack([(x[i] - y[0]).abs().amax(-1) for x, y in zip(
            hist4.params, hist1.params)]).amax(0)
        print(f"crop {i}{' (in every lane)' if args.same else ''}: "
              f"{len(ops4)} and {len(ops1)} operators; parameter "
              f"gap by iteration {[f'{g:.2g}' for g in gap.tolist()]}")
        shown = 0
        # the runs' operators side by side: where the crop-axis run loops
        # over crops (and the lone run once), the sequences are aligned on
        # the operators' names and calling lines
        keys4 = [(f, w) for f, w, _ in ops4]
        keys1 = [(f, w) for f, w, _ in ops1]
        pairs = [(ops4[a + t], ops1[c + t]) for a, c, n in
                 difflib.SequenceMatcher(None, keys4, keys1,
                                         autojunk=False)
                 .get_matching_blocks() for t in range(n)]
        for k, ((f4, w4, o4), (f1, w1, o1)) in enumerate(pairs):
            if args.stages:
                w4 = f"iteration {k // (len(STAGES) + 1)}"
            for j, (t4, t1) in enumerate(zip(o4, o1)):
                # crop i's rows of a (B * n, ...) output against (n, ...),
                # an output without a crop axis against itself
                if args.same and t4.shape == t1.shape and \
                        t4.dtype == t1.dtype and differ(t4, t1) is None:
                    continue
                if t4.dim() and t1.dim() and t4.shape[1:] == t1.shape[1:] \
                        and t4.shape[0] * nb1 == b * t1.shape[0] and (
                            t4.shape[0] % b == 0):
                    n1 = t4.shape[0] // b
                    d = differ(t4[i * n1:(i + 1) * n1], t1[:n1])
                elif t4.shape == t1.shape and t4.dtype == t1.dtype:
                    d = differ(t4, t1)
                else:
                    continue
                if d is not None:
                    print(f"  op {k} {f4} at {w4}, output {j} "
                          f"{tuple(t4.shape)}: max |diff| {d:.3g}")
                    shown += 1
                    break
            if shown >= args.show:
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
