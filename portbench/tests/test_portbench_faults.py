"""A whole run of each cell at a CPU size, with the harness's look for a
card skipped: sound, it comes out correct; with the timed path broken
underneath (each fault the cell can have), `correct` comes out false; the
control (the reference one precision below the configuration's in the
program's place) fails one of the cell's numbers."""

from __future__ import annotations

import json
import os

import pytest
import torch

from portbench import common, run

from portbench.tests.conftest import Args, small_dsdf


def result(capsys, files, workload, seed=2 ** 35 + 3, trace=0):
    rc = run.run(Args(workload, seed, 0.5, trace), device="cpu",
                 cell_files=files)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# ------------------------------------------------------------------ refine

def test_refine_sound(capsys, refine_files):
    line = result(capsys, refine_files, "refine_b4")
    assert line["correct"] and line["failed"] == 0
    # the CPU's trace has no card activity: crops_per_card_s finds
    # nothing to read there and is left out
    assert set(line["metrics"]) == {"setup_s"}
    assert list(line)[-1] == "compared"


class _FakeCardTrace:
    """profile_window's stand-in: the loop runs as it would, and the trace
    holds two overlapping card operations and one apart (1.5 s busy)."""

    def __init__(self):
        self.loops = 0

    def __call__(self, loop):
        self.loops += 1
        units, window_s = loop()
        events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0,
                   "dur": 1e6},
                  {"ph": "X", "cat": "gpu_memcpy", "name": "c",
                   "ts": 0.5e6, "dur": 0.75e6},
                  {"ph": "X", "cat": "kernel", "name": "k", "ts": 3e6,
                   "dur": 0.25e6}]
        return units, window_s, common.Trace(events)


def test_refine_rate_is_read_from_the_windows_card_trace(
        capsys, monkeypatch, refine_files):
    """The trace-0 window of a cell whose end-to-end metric comes from the
    card's trace runs under the profiler, and the rate is the window's
    crops over the card's busy seconds (the union of its operations)."""
    fake = _FakeCardTrace()
    monkeypatch.setattr(common, "profile_window", fake)
    line = result(capsys, refine_files, "refine_b4")
    assert fake.loops == 1 and line["correct"]
    assert set(line["metrics"]) == {"crops_per_card_s", "setup_s"}
    rate = line["metrics"]["crops_per_card_s"]
    assert rate["unit"] == "crops/s"
    assert rate["value"] == pytest.approx(line["attempted"] / 1.5)
    # whole passes over the pool of 2 frames of 4 crops
    assert line["attempted"] % 8 == 0


def test_closed_loop_ends_on_a_whole_pass():
    import time

    ran = []
    n, _ = common.closed_loop(lambda: ran.append(time.sleep(0.01)), 0.0,
                              lambda: None, whole=3)
    assert n == len(ran) == 3
    n, window_s = common.closed_loop(lambda: time.sleep(0.01), 0.05,
                                     lambda: None, whole=4)
    assert n % 4 == 0 and window_s >= 0.05
    assert common.closed_loop(lambda: None, 60.0, lambda: None,
                              max_units=5, whole=4)[0] == 5


def test_refine_traced_runs_the_same_check(capsys, refine_files):
    line = result(capsys, refine_files, "refine_b4", trace=1)
    assert line["correct"]
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert "mfu.refine" in line["metrics"]
    assert line["metrics"]["refine.crops_per_wall_s"]["value"] == \
        pytest.approx(line["attempted"] / line["device"]["window_s"])


def _refine_fault(monkeypatch, name):
    from sdflabel_tpu_torch.engine import refine as refine_mod
    from sdflabel_tpu_torch.pipelines import refine_css

    if name == "state_unchanged":
        monkeypatch.setattr(refine_mod, "batch_step",
                            lambda cfg, params, grads, ok, state:
                            (params, state))
    elif name == "half_batch":
        step = refine_mod.batch_step

        def half(cfg, params, grads, ok, state):
            ok = ok.clone()
            ok[ok.shape[0] // 2:] = False
            return step(cfg, params, grads, ok, state)
        monkeypatch.setattr(refine_mod, "batch_step", half)
    elif name == "answer_altered":
        finish = refine_css.finish_label

        def moved(*a, **kw):
            label = finish(*a, **kw)
            label["location"] = label["location"] + 0.1
            return label
        monkeypatch.setattr(refine_css, "finish_label", moved)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_refine_fault_is_not_correct(capsys, monkeypatch, refine_files,
                                     fault):
    _refine_fault(monkeypatch, fault)
    line = result(capsys, refine_files, "refine_b4")
    assert not line["correct"]


def test_refine_control_fails_a_number(refine_files):
    bench, cell, config, traffic = refine_files
    job = common.load_job("refine").Job(config, traffic, 5, "cpu")
    job.setup()
    common.closed_loop(job.unit, 0.5, job.sync)
    job.release()
    got = common.judge(job.check(control="fp8"), job.limits())
    assert not all(c["ok"] for c in got.values())


def test_refine_check_needs_every_frames_outputs(capsys, refine_files):
    """A frame whose outputs the check could not keep fails it, with a
    message, and does not drop out of the label loop."""
    bench, cell, config, traffic = refine_files
    job = common.load_job("refine").Job(config, traffic, 7, "cpu")
    job.setup()
    common.closed_loop(job.unit, 0.5, job.sync)
    job.release()
    job.captured.pop()
    got = common.judge(job.check(), job.limits())
    assert not any(c["ok"] for c in got.values())
    assert "no frame is judged" in capsys.readouterr().err


# -------------------------------------------------------------------- dsdf

def test_dsdf_sound(capsys, dsdf_files):
    line = result(capsys, dsdf_files, "dsdf_train_b64")
    assert line["correct"]
    assert set(line["metrics"]) == {"sdf_rows_per_s", "setup_s"}


def _dsdf_fault(monkeypatch, name):
    from sdflabel_tpu_torch.engine import deepsdf_train as dt

    step = dt.step_on_samples
    if name == "state_unchanged":
        def same(cfg, tcfg, spe, state, *a, **kw):
            new, m = step(cfg, tcfg, spe, state, *a, **kw)
            return dt.DeepSDFTrainState(state.params, state.codes, new.opt,
                                        new.step), m
        monkeypatch.setattr(dt, "step_on_samples", same)
    elif name == "half_batch":
        train = dt.train_step

        def half(cfg, tcfg, spe, state, tensors, scene_idx, gen, mesh=None):
            return train(cfg, tcfg, spe, state, tensors,
                         scene_idx[:scene_idx.shape[0] // 2], gen, mesh)
        monkeypatch.setattr(dt, "train_step", half)
    elif name == "answer_altered":
        def moved(*a, **kw):
            new, m = step(*a, **kw)
            new.params["lin8"]["w"] = new.params["lin8"]["w"] * 1.01
            return new, m
        monkeypatch.setattr(dt, "step_on_samples", moved)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_dsdf_fault_is_not_correct(capsys, monkeypatch, dsdf_files, fault):
    _dsdf_fault(monkeypatch, fault)
    line = result(capsys, dsdf_files, "dsdf_train_b64")
    assert not line["correct"]


@pytest.mark.cuda
def test_dsdf_tf32_control_fails_a_number():
    """TF32 exists only on the card: the control runs there."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs an NVIDIA card")
    bench, cell, config, traffic = small_dsdf()
    config["NetworkSpecs"]["dims"] = [512] * 8
    job = common.load_job("dsdf_train").Job(config, traffic, 5, "cuda")
    job.setup()
    job.release()
    got = common.judge(job.check(control="tf32"), job.limits())
    assert not all(c["ok"] for c in got.values())


def test_run_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "refine_b4", "--seed", "1", "--seconds",
                   "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


# --------------------------------------------------------------------- css

def test_css_sound(capsys, css_files):
    line = result(capsys, css_files, "css_train_b13")
    assert line["correct"]
    assert set(line["metrics"]) == {"css_images_per_s", "setup_s"}


def _css_fault(monkeypatch, name):
    from sdflabel_tpu_torch.data import crops as crops_data
    from sdflabel_tpu_torch.engine import css_train

    if name == "state_unchanged":
        monkeypatch.setattr(css_train.Adam, "step", lambda self: None)
    elif name == "half_batch":
        to_device = crops_data.Crops.to_device

        def half(self, batch, device):
            out = to_device(self, batch, device)
            return {k: v[:v.shape[0] // 2] for k, v in out.items()}
        monkeypatch.setattr(crops_data.Crops, "to_device", half)
    elif name == "answer_altered":
        step = css_train.Adam.step

        def moved(self):
            step(self)
            with torch.no_grad():
                self.params[0].mul_(1.01)
        monkeypatch.setattr(css_train.Adam, "step", moved)
    elif name == "input_altered":  # the hue left out of the colour jitter
        jitter = crops_data.color_jitter

        def no_hue(img, ops, factors, valid, pil):
            return jitter(img, torch.where(ops == 3, -1, ops), factors,
                          valid, pil)
        monkeypatch.setattr(crops_data, "color_jitter", no_hue)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered", "input_altered"])
def test_css_fault_is_not_correct(capsys, monkeypatch, css_files, fault):
    _css_fault(monkeypatch, fault)
    line = result(capsys, css_files, "css_train_b13")
    assert not line["correct"]


def test_css_database_is_deleted(css_files):
    bench, cell, config, traffic = css_files
    job = common.load_job("css_train").Job(config, traffic, 3, "cpu")
    job.setup()
    path = job.path
    assert os.path.exists(os.path.join(path, "crops", "crops.json"))
    job.release()
    job.close()
    assert not os.path.exists(path)


@pytest.mark.cuda
def test_css_tf32_control_fails_a_number():
    """TF32 exists only on the card: the control runs there."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 needs an NVIDIA card")
    from portbench.tests.conftest import small_css

    bench, cell, config, traffic = small_css()
    config = dict(config, width=64)
    job = common.load_job("css_train").Job(config, traffic, 5, "cuda")
    try:
        job.setup()
        job.release()
        got = common.judge(job.check(control="tf32"), job.limits())
    finally:
        job.close()
    assert not all(c["ok"] for c in got.values())
