"""The program's spans (utils/profiling.py) on the CPU: the batched refine's
frame of two crops of unequal size (3 iterations, a warm refresh every 2)
and its single-crop loop, and two CSS steps at width 8 in a training
thread of their own, each run with recording on (under a profiler) and
off. Recording changes no output: labels, history and parameters are
compared bit for bit. The span tree, the counts, the trace file's clock,
the sessions and the bound are checked exactly."""

import json
import math
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sdflabel_tpu_torch import config as cfg_mod
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import grid as grid_ops
from sdflabel_tpu_torch.pipelines import make_crops as tmc
from sdflabel_tpu_torch.pipelines import refine_css
from sdflabel_tpu_torch.pipelines import train_css
from sdflabel_tpu_torch.utils import profiling

ITERS, REFRESH, BUCKET = 3, 2, 8
CROPS_HW = ((20, 12), (14, 18))  # letterboxed into 24 x 24, 2 lanes
SAMPLE = {"world_to_cam": np.eye(4)}


def _runtime():
    cfg = cfg_mod.RefineCfg(grid_density=12, iters=ITERS, warm_band=512,
                            warm_refresh=REFRESH, precision="float32",
                            select_pallas=False, render_bucket=BUCKET)
    dcfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(32, 32, 32),
                                 latent_in=(2,))
    params = deepsdf.init_params(dcfg, torch.Generator().manual_seed(0))
    # move the field's zero set into the grid: a surface to label
    sdf = deepsdf.sdf_fn(dcfg, params)(torch.tensor([0.6, 0.0, 0.8]),
                                       grid_ops.generate_point_grid(12))
    params["lin3"]["b"] -= sdf.median()
    return refine_css.RefineRuntime(cfg, torch.nn.Module(), dcfg, params,
                                    surface_capacity=256, device="cpu")


def _preps():
    rng = np.random.RandomState(3)
    out = []
    for i, (h, w) in enumerate(CROPS_HW):
        K = np.array([[30.0, 0, w / 2], [0, 30.0, h / 2], [0, 0, 1]],
                     np.float32)
        out.append({
            "params0": refine_mod.init_refine_params(
                0.1 * i, [0.0, 0.0, 4.0], 1.0, [0.6, 0.0, 0.8]),
            "intrinsics": K, "crop_hw": (h, w),
            "nocs_target": rng.uniform(0, 1, (3, h, w)).astype(np.float32),
            "frustum": rng.normal([0, 0, 4], 0.5, (64, 3)).astype(
                np.float32),
            "fmask": np.ones(64, bool), "anno": {"bbox": [0, 0, w, h]}})
    return out


def _by_name(recorded):
    out = {}
    for i, sp in enumerate(recorded):
        out.setdefault(sp.name, []).append(i)
    return out


@pytest.fixture(scope="module")
def refine_runs(tmp_path_factory):
    """(labels off, labels on, histories off/on, the frame's spans, the
    single-crop loop's spans, the trace file's events, the spans seen
    after a run with recording off)."""
    rt, preps = _runtime(), _preps()
    kept = []
    make = refine_css.batched_refine.make_batched_refine

    def keep(*args, **kw):
        fn = make(*args, **kw)

        def run(*a):
            kept.append(fn(*a))
            return kept[-1]
        return run

    refine_css.batched_refine.make_batched_refine = keep
    profiling.spans()  # read between sessions: the next one starts anew
    try:
        # a session holding one marker, then a frame with recording off
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span("marker"):
                pass
        off = refine_css.refine_crops_batched(rt, SAMPLE, preps)
        after_off = profiling.spans()
        log = tmp_path_factory.mktemp("refine_trace")
        with profiling.trace(str(log)):
            on = refine_css.refine_crops_batched(rt, SAMPLE, preps)
        frame_spans = profiling.spans()
    finally:
        refine_css.batched_refine.make_batched_refine = make
    with profile(activities=[ProfilerActivity.CPU]):
        rt.run_refine(preps[0])
    single = profiling.spans()
    with open(log / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return dict(off=off, on=on, hist=kept, frame=frame_spans,
                single=single, events=events, after_off=after_off)


def test_nothing_is_recorded_without_a_profiler(refine_runs):
    assert [sp.name for sp in refine_runs["after_off"]] == ["marker"]
    assert profiling.span("x") is profiling.span("y")  # the idle span


def _history_leaves(out):
    final, hist, ext = out
    return [*final, *hist[:4], *hist.params, *ext]


def _css_leaves(state):
    return [p.detach() for p in state.opt.params]


@pytest.mark.parametrize("part", ["refine", "css"])
def test_outputs_bit_equal_with_recording_on_and_off(part, refine_runs,
                                                     css_runs):
    if part == "refine":
        assert len(refine_runs["off"]) == len(CROPS_HW)
        for a, b in zip(refine_runs["off"], refine_runs["on"]):
            assert a.keys() == b.keys()
            assert all(np.array_equal(a[k], b[k]) for k in a)
        off, on = (_history_leaves(o) for o in refine_runs["hist"])
    else:
        off, on = (_css_leaves(s) for s in (css_runs["off"],
                                            css_runs["on"]))
    assert len(off) == len(on) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_refine_span_tree(refine_runs):
    spans = refine_runs["frame"]
    names = _by_name(spans)
    (frame,) = names["refine.frame"]
    assert spans[frame].parent == -1
    want_parent = {"refine.batch_inputs": "refine.frame",
                   "refine.loop": "refine.frame",
                   "refine.read": "refine.frame",
                   "refine.labels": "refine.frame",
                   "refine.iteration": "refine.loop",
                   "refine.extents": "refine.loop",
                   "refine.refresh": "refine.iteration",
                   "refine.forward": "refine.iteration",
                   "refine.backward": "refine.iteration",
                   "refine.step": "refine.iteration"}
    assert set(names) == {"refine.frame", *want_parent}
    for name, parent in want_parent.items():
        for i in names[name]:
            assert spans[spans[i].parent].name == parent, name
    assert all(sp.trace == spans[frame].trace for sp in spans)
    assert all(sp.end_ns is not None and sp.end_ns >= sp.start_ns
               for sp in spans)
    counts = {n: len(v) for n, v in names.items()}
    assert counts["refine.iteration"] == counts["refine.forward"] == \
        counts["refine.backward"] == counts["refine.step"] == ITERS
    assert counts["refine.refresh"] == math.ceil(ITERS / REFRESH)
    assert counts["refine.extents"] == counts["refine.read"] == 1
    # the single-crop loop: its iterations are roots of their own traces
    single = refine_runs["single"]
    its = [sp for sp in single if sp.name == "refine.iteration"]
    assert len(its) == ITERS and all(sp.parent == -1 for sp in its)
    assert len({sp.trace for sp in its}) == ITERS
    assert sum(sp.name == "refine.refresh" for sp in single) == \
        math.ceil(ITERS / REFRESH)


def test_frame_pixel_counts(refine_runs):
    (frame,) = [sp for sp in refine_runs["frame"]
                if sp.name == "refine.frame"]
    # 20 x 12 + 14 x 18 real pixels; two lanes of 24 x 24 (20 and 18
    # rounded up to the bucket of 8)
    assert frame.counts == {"pixels": 20 * 12 + 14 * 18,
                            "lane_pixels": 2 * 24 * 24}


def test_trace_file_holds_the_spans(refine_runs):
    events = refine_runs["events"]
    mine = [e for e in events if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in mine) == sorted(
        sp.name for sp in refine_runs["frame"])
    (frame,) = [e for e in mine if e["name"] == "refine.frame"]
    assert frame["args"]["pixels"] == 492 and frame["args"]["parent"] == -1
    # every host operator of the frame's thread lies inside the frame on
    # the file's clock
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == frame["tid"] and e.get("ph") == "X"]
    assert ops
    lo, hi = frame["ts"], frame["ts"] + frame["dur"]
    inside = [e for e in ops if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
    assert len(inside) >= 0.99 * len(ops)


def test_span_encloses_a_marker_on_the_file_clock(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("outer", n=7):
            with torch.autograd.profiler.record_function("marker"):
                torch.ones(8) + 1
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    (outer,) = [e for e in events if e.get("cat") == "program_span"]
    (marker,) = [e for e in events if e.get("name") == "marker"
                 and e.get("cat") == "user_annotation"]
    assert outer["args"] == {"index": 0, "parent": -1,
                             "trace": outer["args"]["trace"], "n": 7}
    assert outer["tid"] == marker["tid"]
    assert outer["ts"] <= marker["ts"]
    assert marker["ts"] + marker["dur"] <= outer["ts"] + outer["dur"]


def test_sessions_do_not_mix_and_late_spans_stay_open():
    profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("first"):
            pass
    assert [sp.name for sp in profiling.spans()] == ["first"]
    with profile(activities=[ProfilerActivity.CPU]):
        late = profiling.span("late")
        late.__enter__()
        with profiling.span("second") as sp:
            sp.count(k=1)
    late.__exit__(None, None, None)  # closes after its session stopped
    got = profiling.spans()
    assert [(s.name, s.parent) for s in got] == [("late", -1),
                                                  ("second", 0)]
    assert got[0].end_ns is None and got[1].end_ns is not None
    assert got[1].counts == {"k": 1} and got[1].trace == got[0].trace


def test_bound_and_dropped_count(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "limit", 5)
    profiling.spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(8):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 5 and profiling.dropped() == 3
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("t"):
            pass
    assert len(profiling.spans()) == 1 and profiling.dropped() == 0


# ------------------------------------------------------------------ CSS

def _sphere(latent, points):
    return torch.linalg.norm(points, dim=-1) - (0.75 + 0.1 * latent[0])


def _train_in_thread(crops_dir, log_dir):
    """train_css for one epoch of 2 steps in a thread of its own (as a
    caller that watches it does); returns (state, the thread's native
    id)."""
    out = {}

    def run():
        out["tid"] = threading.get_native_id()
        out["state"] = train_css.train_css(
            train_css.make_config(crops_dir, log_dir, batch_size=3,
                                  plot=False),
            max_epochs=1, device="cpu", width=8)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and "state" in out
    return out["state"], out["tid"]


@pytest.fixture(scope="module")
def css_runs(tmp_path_factory):
    crops = str(tmp_path_factory.mktemp("span_crops"))
    tmc.make_crops(crops, _sphere,
                   tmc.sample_unit_latents(3, 3, np.random.RandomState(1)),
                   n_crops=6, crop_px=64, grid_density=20, capacity=512,
                   seed=2, device="cpu")
    off, _ = _train_in_thread(crops, str(tmp_path_factory.mktemp("off")))
    with profile(activities=[ProfilerActivity.CPU]):
        on, tid = _train_in_thread(crops,
                                   str(tmp_path_factory.mktemp("on")))
    return dict(off=off, on=on, tid=tid, spans=profiling.spans())


def test_css_span_tree(css_runs):
    spans = css_runs["spans"]
    names = _by_name(spans)
    assert all(sp.thread == css_runs["tid"] for sp in spans)
    steps = [spans[i] for i in names["css.step"]]
    assert [(s.counts["epoch"], s.counts["batch"], s.counts["images"])
            for s in steps] == [(0, 0, 3), (0, 1, 3)]
    assert all(s.parent == -1 for s in steps)
    assert len({s.trace for s in steps}) == 2
    for name in ("css.records", "css.to_device", "css.train", "css.log"):
        kids = [spans[i] for i in names[name]]
        assert [spans[k.parent].name for k in kids] == ["css.step"] * 2
        assert [k.trace for k in kids] == [s.trace for s in steps]
    assert set(names) == {"css.step", "css.records", "css.to_device",
                          "css.train", "css.log"}
