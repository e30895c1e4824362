"""The readers of the program's spans (portbench/spans.py and the metrics
that use it), on stand-in spans with values worked out by hand, on the
refine cell's design, and with no spans to read."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

from portbench import common, spans
from portbench.jobs import refine as refine_job
from sdflabel_tpu_torch.utils import profiling

MS = 1_000_000  # ns


def frame_spans(t0: int, pixels: int, lanes: int, closed: bool = True):
    """One refine frame of 10 ms (or still open): batch inputs 1 ms, a loop
    of two iterations (refresh 1 + forward 2 + backward 1 + step 0.5 ms
    each, the refresh in the first) and extents 0.5 ms, a read of 1.5 ms
    and labels 0.5 ms; as (name, start, end, parent offset) from t0."""
    rows = [("refine.frame", 0, 10, -1), ("refine.batch_inputs", 0, 1, 0),
            ("refine.loop", 1, 7.5, 0),
            ("refine.iteration", 1, 5, 2), ("refine.refresh", 1, 2, 3),
            ("refine.forward", 2, 4, 3), ("refine.backward", 4, 5, 3),
            ("refine.step", 5, 5.5, 3),
            ("refine.iteration", 5.5, 7, 2), ("refine.forward", 5.5, 6.5, 8),
            ("refine.backward", 6.5, 6.8, 8), ("refine.step", 6.8, 7, 8),
            ("refine.extents", 7, 7.5, 2), ("refine.read", 7.5, 9, 0),
            ("refine.labels", 9, 10, 0)]
    return rows, {"pixels": pixels, "lane_pixels": lanes}, closed


def build(frames) -> list:
    """Stand-in profiling.Span objects of the frames, one after another."""
    out = []
    for k, (rows, counts, closed) in enumerate(frames):
        base = len(out)
        t0 = k * 20 * MS
        for i, (name, a, z, parent) in enumerate(rows):
            end = t0 + int(z * MS)
            out.append(profiling.Span(
                name, t0 + int(a * MS),
                None if (i == 0 and not closed) else end,
                -1 if parent < 0 else base + parent, 1, k,
                dict(counts) if i == 0 else {}))
    return out


def css_spans(steps: int) -> list:
    """CSS steps of 20 ms: records 8, to_device 2, train 7, log 3 ms."""
    out = []
    for k in range(steps):
        t0, base = k * 20 * MS, len(out)
        out.append(profiling.Span("css.step", t0, t0 + 20 * MS, -1, 1, k,
                                  {"images": 13}))
        at = 0
        for name, d in (("css.records", 8), ("css.to_device", 2),
                        ("css.train", 7), ("css.log", 3)):
            out.append(profiling.Span(name, t0 + at * MS,
                                      t0 + (at + d) * MS, base, 1, k, {}))
            at += d
    return out


def read(name, monkeypatch, recorded):
    monkeypatch.setattr(profiling, "spans", lambda: recorded)
    return common.load_reader(name)({"trace": None, "window_s": 1.0})


# two closed frames and a third still open when the window closed
FRAMES = [frame_spans(0, 600, 1024), frame_spans(0, 400, 1024),
          frame_spans(0, 999, 1024, closed=False)]
# per iteration over the two closed frames' four iterations: forward
# (2 + 1) x 2 / 4, backward (1 + 0.3) x 2 / 4, step (0.5 + 0.2) x 2 / 4;
# per frame: read 1.5, driver 10 - 6.5 - 1.5
WANT = {"refine.forward_ms_per_iter": 1.5,
        "refine.backward_ms_per_iter": 0.65,
        "refine.step_ms_per_iter": 0.35,
        "refine.read_wait_ms_per_frame": 1.5,
        "refine.driver_ms_per_frame": 2.0,
        "refine.pixel_fill": 100.0 * 1000 / 2048}
CSS_WANT = {"css.records_ms_per_step": 8.0, "css.train_ms_per_step": 7.0,
            "css.loss_read_ms_per_step": 3.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_refine_reader_by_hand(name, monkeypatch):
    got = read(name, monkeypatch, build(FRAMES))
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(CSS_WANT))
def test_css_reader_by_hand(name, monkeypatch):
    assert read(name, monkeypatch, css_spans(3)) == \
        pytest.approx(CSS_WANT[name], rel=1e-12)


def test_only_spans_whose_root_closed_count(monkeypatch):
    recorded = build(FRAMES)
    monkeypatch.setattr(profiling, "spans", lambda: recorded)
    kept = spans.window()
    assert len(kept) == 2 * 15
    assert sum(sp.name == "refine.iteration" for sp in kept) == 4


@pytest.mark.parametrize("name", sorted(WANT) + sorted(CSS_WANT))
def test_reader_without_spans_is_none(name, monkeypatch):
    assert read(name, monkeypatch, []) is None
    # a program whose profiling module has no spans at all
    monkeypatch.delattr(profiling, "spans")
    assert common.load_reader(name)({"trace": None, "window_s": 1.0}) \
        is None


class _StubRuntime:
    """What batch_inputs reads of the runtime."""

    def __init__(self, bucket):
        self.cfg = type("Cfg", (), {"render_bucket": bucket})()
        self.mesh = None
        self.device = torch.device("cpu")


def test_pixel_fill_on_the_refine_cells_design(monkeypatch):
    from sdflabel_tpu_torch.engine import refine as refine_mod
    from sdflabel_tpu_torch.pipelines import refine_css

    bench, cell, config, traffic = common.load_cell("refine_b4")
    bucket = config["refine"]["render_bucket"]
    assert bucket == 8
    slots = refine_job.design(traffic)
    per = traffic["cars_per_frame"]
    frames = [slots[i:i + per] for i in range(0, len(slots), per)]
    counted = []
    for fr in frames:
        pixels = sum(h * w for h, w in (s["crop_hw"] for s in fr))
        bh = math.ceil(max(s["crop_hw"][0] for s in fr) / bucket) * bucket
        bw = math.ceil(max(s["crop_hw"][1] for s in fr) / bucket) * bucket
        lanes = 1 << (len(fr) - 1).bit_length()
        # the program's own letterboxing of these crops agrees
        preps = [{"params0": refine_mod.init_refine_params(
                      0.0, [0, 0, 1], 1.0, [1, 0, 0]),
                  "crop_hw": s["crop_hw"], "intrinsics": s["K_crop"],
                  "nocs_target": np.zeros((3, *s["crop_hw"]), np.float32),
                  "frustum": np.zeros((2, 3), np.float32),
                  "fmask": np.ones(2, bool)} for s in fr]
        (gh, gw), args = refine_css.batch_inputs(_StubRuntime(bucket),
                                                 preps)
        assert (gh, gw, len(args[1])) == (bh, bw, lanes)
        counted.append((pixels, lanes * bh * bw))
    # every crop fits the 32^2 area budget, so a frame fills at most 100%
    assert all(0 < p <= q for p, q in counted)
    recorded = build([frame_spans(0, p, q) for p, q in counted])
    want = 100.0 * sum(p for p, _ in counted) / sum(q for _, q in counted)
    assert read("refine.pixel_fill", monkeypatch, recorded) == \
        pytest.approx(want, rel=1e-12)


def _traced(capsys, files, workload, seconds=0.5):
    from portbench import run
    from portbench.tests.conftest import Args

    rc = run.run(Args(workload, 2 ** 35 + 5, seconds, 1), device="cpu",
                 cell_files=files)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_traced_refine_run_reports_the_span_metrics(capsys, refine_files):
    line = _traced(capsys, refine_files, "refine_b4")
    assert line["correct"]
    assert set(WANT) <= set(line["metrics"])
    assert line["metrics"]["refine.pixel_fill"]["unit"] == "%"
    kept = spans.window()
    frames = sum(sp.name == "refine.frame" for sp in kept)
    rc = refine_files[2]["refine"]
    assert frames == line["attempted"] // refine_files[3]["cars_per_frame"]
    assert sum(sp.name == "refine.iteration" for sp in kept) == \
        frames * rc["iters"]
    assert sum(sp.name == "refine.refresh" for sp in kept) == \
        frames * math.ceil(rc["iters"] / rc["warm_refresh"])


def test_traced_css_run_reports_the_span_metrics(capsys, css_files):
    bench, cell, config, traffic = css_files
    # a traced window of four steps
    line = _traced(capsys, (bench, cell, config,
                            dict(traffic, trace_units=4)),
                   "css_train_b13", seconds=600.0)
    assert line["correct"] and line["attempted"] == 4
    assert set(CSS_WANT) <= set(line["metrics"])
    steps = [sp for sp in spans.window() if sp.name == "css.step"]
    # the window's first step may open before the profiler starts, and its
    # last close after it stops: neither counts
    assert line["attempted"] - 2 <= len(steps) <= line["attempted"]
    assert all(sp.counts["images"] == 13 for sp in steps)
