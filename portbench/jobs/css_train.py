"""Job "css_train": train the CSS network the stock way, by running
``pipelines/train_css.py::train_css`` itself under the stock
configs/config_train.ini: the crops database decoded once, then per step
the host's draws and collation (data/crops.py, the PIL chain of
``fast_input = False``), the device chain (``Crops.to_device``),
``engine/css_train.py``'s step and its loss print, and at each epoch's end
the network, checkpoint and PNGs written under the run's TMPDIR.

The generator reads a traffic file (portbench/traffic/*.json with "job":
"css_train") and writes, in set-up, a crops database in the layout
pipelines/make_crops.py writes (``{idx:05d}_rgb.png``, ``_uvw.png``,
crops.json) under the run's TMPDIR, deleted when the run ends: per crop a
car-proportioned ellipsoid at a seeded pose and distance, ray-cast on the
card at 128 px into its NOCS image (uvw) and a shaded, noisy RGB image
over a noisy background; the latent a seeded unit vector.

Set-up makes the weights on the card from the seed and hands them to
train_css as the checkpoint it starts from. train_css runs in a thread of
its own; its ``step_wrapper`` hook lets each step go only when the
harness's closed loop asks for one and reports back when the step is
done, so set-up (the first `check_steps` steps) and the window are steps
of one training run, the same state throughout. The check runs Pillow's
chain (reference/crops_ref.py) and the reference's steps
(reference/css_ref.py) from the same weights on the same database and
draws, and holds the program's first device batches to Pillow's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import struct
import tempfile
import threading
import zlib

import torch

from portbench import common, counts
from portbench.reference import crops_ref
from portbench.reference import css_ref
from portbench.reference.dsdf_ref import norm_gaps

# limits of the compared numbers, set on the card from the program's
# readings over a dozen seeds and more and the control's (the reference
# with TF32 on); PERF.md gives both. input_gap counts the values of the
# first device batches that differ from Pillow's: an exact comparison.
LIMITS = {"input_gap": 0.0, "loss_gap": 2e-4, "grad_gap": 1e-4,
          "change_gap": 1e-2}
# the stock config_train.ini keys the configuration file states
TRAIN_KEYS = ("batch_size", "lr", "precision", "fused_ce", "direct_ce",
              "fast_input", "seed", "cpu_threads", "queue_size",
              "analyse_epoch", "plot", "log_every")
NOUGHT_GRAD = 1e-3


# ------------------------------------------------------------- generator

def _png(img) -> bytes:
    """An 8-bit RGB PNG of (H, W, 3) uint8, rows unfiltered."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def make_database(traffic: dict, seed: int, device, path: str) -> None:
    """Write the crops database (see the module note) into `path`."""
    n, s = traffic["crops"], traffic["crop_px"]
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63 - 1))

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen,
                                           device=device)

    axes = torch.tensor(traffic["semi_axes"], device=device) * u(
        n, 3, lo=0.85, hi=1.15)
    yaw = u(n, lo=-math.pi, hi=math.pi)
    pitch = u(n, lo=-0.15, hi=0.15)
    cy, sy, cp, sp = yaw.cos(), yaw.sin(), pitch.cos(), pitch.sin()
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(n, 3, 3)
    rx = torch.stack([o, z, z, z, cp, -sp, z, sp, cp], -1).reshape(n, 3, 3)
    rot = rx @ ry
    f = traffic["focal_px"]
    d_lo, d_hi = traffic["distance"]
    t = torch.stack([u(n, lo=-0.3, hi=0.3), u(n, lo=-0.2, hi=0.2),
                     u(n, lo=d_lo, hi=d_hi)], -1)
    K = torch.tensor([[f, 0, s / 2], [0, f, s / 2], [0, 0, 1.0]],
                     device=device)
    ys, xs = torch.meshgrid(torch.arange(s, device=device).float(),
                            torch.arange(s, device=device).float(),
                            indexing="ij")
    rays = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3) \
        @ torch.linalg.inv(K).T
    # object frame: x = R^T (c - t)
    ro = -(rot.transpose(1, 2) @ t[:, :, None])[:, None, :, 0] \
        .expand(n, s * s, 3)
    rd = rays[None] @ rot
    a = axes[:, None, :]
    oa, da = ro / a, rd / a
    qa = (da * da).sum(-1)
    qb = 2 * (oa * da).sum(-1)
    qc = (oa * oa).sum(-1) - 1
    disc = qb * qb - 4 * qa * qc
    hit = disc > 0
    root = (-qb - torch.sqrt(disc.clamp(min=0))) / (2 * qa)
    hit = hit & (root > 0)
    p = ro + root[..., None] * rd
    nocs = (p * torch.tensor([-1.0, 1, 1], device=device) + 1) / 2
    uvw = torch.where(hit[..., None], (nocs * 255).round().clamp(1, 255),
                      torch.zeros_like(nocs))
    nrm = p / (a * a)
    nrm = nrm / torch.linalg.norm(nrm, dim=-1, keepdim=True).clamp(min=1e-9)
    dirn = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    shade = 0.25 + 0.75 * (-(nrm * dirn).sum(-1)).clamp(min=0)
    base = u(n, 1, 3, lo=0.1, hi=0.9)
    bg = u(n, 1, 3, lo=0.2, hi=0.8)
    noise = torch.randn(n, s * s, 3, generator=gen, device=device) * 0.04
    rgb = torch.where(hit[..., None], base * shade[..., None], bg) + noise
    rgb = (rgb.clamp(0, 1) * 255).round()
    latent = torch.randn(n, 3, generator=gen, device=device)
    latent = latent / torch.linalg.norm(latent, dim=-1, keepdim=True)
    pose = torch.eye(4, device=device).repeat(n, 1, 1)
    pose[:, :3, :3], pose[:, :3, 3] = rot, t
    rgb = rgb.to(torch.uint8).reshape(n, s, s, 3).cpu().numpy()
    uvw = uvw.to(torch.uint8).reshape(n, s, s, 3).cpu().numpy()
    latent, pose, K = latent.cpu().tolist(), pose.cpu().tolist(), \
        K.cpu().flatten().tolist()
    os.makedirs(path, exist_ok=True)
    db = {}
    for i in range(n):
        for kind, img in (("rgb", rgb[i]), ("uvw", uvw[i])):
            with open(os.path.join(path, f"{i:05d}_{kind}.png"), "wb") as fh:
                fh.write(_png(img))
        db[str(i)] = [{"latent": latent[i],
                       "extrinsics": [v for row in pose[i] for v in row],
                       "intrinsics": K}]
    with open(os.path.join(path, "crops.json"), "w") as fh:
        json.dump(db, fh)


def init_weights(model, seed: int, device) -> dict:
    """flax's initial weights in a few draws on the card: conv kernels
    lecun_normal (N(0, 1/fan_in), cut at two deviations), biases 0,
    BatchNorm scale 1, bias 0, statistics 0 and 1. Returns the state
    dict."""
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63 - 1))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    kernels = [k for k, v in state.items()
               if k.endswith("weight") and v.dim() == 4]
    z = torch.randn(sum(state[k].numel() for k in kernels), generator=gen,
                    device=device).clamp(-2.0, 2.0)
    at = 0
    for k, v in state.items():
        if k in kernels:
            std = (1.0 / v[0].numel()) ** 0.5 / 0.87962566103423978
            state[k] = (z[at:at + v.numel()].reshape(v.shape) * std)
            at += v.numel()
        elif k.endswith(".scale") or k.endswith(".var"):
            state[k] = torch.ones_like(v)
        else:
            state[k] = torch.zeros_like(v)
    return state


# -------------------------------------------------------------------- job

class _Stop(Exception):
    """Ends the training thread once the window has closed."""


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.path = None
        self.steps_run = 0
        self.thread = None
        self.stop = False
        self.error = None
        self.go = threading.Semaphore(0)
        self.done = threading.Semaphore(0)
        self.first_batches, self.first_losses = [], []

    def setup(self):
        clock = common.Stopwatch(self.sync)
        from sdflabel_tpu_torch import config as cfg_mod
        from sdflabel_tpu_torch.models import css as css_mod
        from sdflabel_tpu_torch.pipelines import train_css
        from sdflabel_tpu_torch.utils import flax_msgpack

        cfg, dev = self.config, self.device
        self.path = tempfile.mkdtemp(prefix="portbench_css_")
        data = os.path.join(self.path, "crops")
        make_database(self.traffic, self.seed, dev, data)
        clock.lap("database")
        model = css_mod.CSSNet(width=cfg["width"],
                               latent_size=cfg["latent_size"]).to(dev)
        self.state0 = init_weights(model, self.seed + 1, dev)
        model.load_state_dict(self.state0)
        start = os.path.join(self.path, "start.msgpack")
        flax_msgpack.save(start, css_mod.state_to_flax(model))
        del model
        tcfg = dataclasses.replace(
            cfg_mod.TrainCfg.from_ini(train_css.make_config(
                data, os.path.join(self.path, "log"))),
            css_path=start, **{k: cfg[k] for k in TRAIN_KEYS})
        clock.lap("weights")
        self.thread = threading.Thread(
            target=self._train, args=(train_css.train_css, tcfg),
            name="css_train", daemon=True)
        self.thread.start()
        for _ in range(self.traffic["check_steps"]):
            self.unit()
        self.first_losses = [float(x) for x in self.first_losses]
        clock.lap("first steps")
        self.setup_times = clock.laps
        self.steps_run = 0

    def _train(self, train_fn, tcfg):
        """The training thread: train_css, each step let through by
        unit()."""
        try:
            train_fn(tcfg, device=self.device, width=self.config["width"],
                     step_wrapper=self._wrap)
            self.error = RuntimeError("train_css ended before the window")
        except _Stop:
            pass
        except BaseException as e:  # handed to the harness's thread
            self.error = e
        finally:
            self.stop = True
            self.done.release()

    def _wrap(self, step):
        def run(state, batch):
            self.go.acquire()
            if self.stop:
                raise _Stop
            first = len(self.first_batches) < self.traffic["check_steps"]
            if first:
                self.first_batches.append({k: v.clone()
                                           for k, v in batch.items()})
            m = step(state, batch)
            if first:
                self._first_step(state, m)
            self.done.release()
            return m
        return run

    def _first_step(self, state, m):
        """What the check compares, from the first steps: each loss, the
        first gradient as Adam holds it (mu / 0.1 after one step) and the
        parameters after the last."""
        self.first_losses.append(m["loss"].detach().clone())
        if len(self.first_batches) == 1:
            self.first_grads = [mu / 0.1 for mu in state.opt.mu]
            self.names = list(state.opt.names)
        if len(self.first_batches) == self.traffic["check_steps"]:
            self.after = [p.detach().clone() for p in state.opt.params]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self):
        """One step of the training thread, waited for."""
        if self.stop:
            raise RuntimeError("the training thread has ended") \
                from self.error
        self.go.release()
        self.done.acquire()
        if self.error is not None:
            raise RuntimeError("train_css failed") from self.error
        self.steps_run += 1

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"css_images_per_s":
                units * self.config["batch_size"] / window_s}

    def attempted_failed(self) -> tuple[int, int]:
        return self.steps_run, 0

    def limits(self) -> dict:
        return dict(LIMITS)

    def release(self):
        """End the training thread, and with it the program's state."""
        if self.thread is not None:
            self.stop = True
            self.go.release()
            self.thread.join()
            self.thread = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def close(self):
        """End the training thread; delete the database and the logs."""
        self.release()
        if self.path is not None:
            shutil.rmtree(self.path, ignore_errors=True)
            self.path = None

    def _reference(self, tf32: bool = False, half_batch: bool = False):
        """Pillow's first batches, and the reference's steps on them."""
        cfg = self.config
        data = os.path.join(self.path, "crops")
        gt = crops_ref.load_gt(data)
        idx = crops_ref.epoch_batches(len(gt), cfg["batch_size"], 0)
        batches = []
        for sel in idx[:self.traffic["check_steps"]]:
            if half_batch:
                sel = sel[:len(sel) // 2]
            batches.append({k: torch.as_tensor(v).to(self.device)
                            for k, v in crops_ref.batch(
                                data, gt, sel, cfg["seed"], 0).items()})
        model = css_ref.CSS(cfg["width"], cfg["latent_size"]).to(self.device)
        model.load_state_dict(self.state0)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            losses, first, after = css_ref.train_steps(model, batches,
                                                       cfg["lr"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        names = [n for n, _ in model.named_parameters()
                 if css_ref.trainable(n)]
        if names != self.names:
            raise AssertionError("the reference's parameters are not the "
                                 "program's")
        return batches, (losses, first, after)

    def check(self, sample_all: bool = False, control: str | None = None
              ) -> dict:
        """input_gap: the values of the first device batches that differ
        from Pillow's; loss_gap, grad_gap and change_gap of the first steps
        (see jobs/dsdf_train.py). `control` "tf32" or "half_batch" in the
        program's place."""
        pil, want = self._reference()
        if control is None:
            prog, batches = (self.first_losses, self.first_grads,
                             self.after), self.first_batches
        elif control in ("tf32", "half_batch"):
            batches, prog = self._reference(
                tf32=control == "tf32", half_batch=control == "half_batch")
        else:
            raise ValueError(f"unknown control {control!r}")
        input_gap = 0
        for got, ref_b in zip(batches, pil):
            for k in ("rgb", "uvw", "mask", "latent"):
                a, b = got[k], ref_b[k]
                input_gap += (b.numel() if a.shape != b.shape
                              else int((a.to(b.dtype) != b).sum()))
        lp, gp, ap = prog
        lr_, gr, ar = want
        loss_gap = max(abs(a - b) / max(abs(b), 1e-12)
                       for a, b in zip(lp, lr_))
        grad_gap, g_at = norm_gaps(gp, gr)
        norms = [float(torch.linalg.norm(g)) for g in gr]
        med = sorted(norms)[len(norms) // 2]
        skip = {i for i, v in enumerate(norms) if v < NOUGHT_GRAD * med}
        start = [self.state0[n] for n in self.names]
        change_gap, c_at = norm_gaps([a - s for a, s in zip(ap, start)],
                                     [b - s for b, s in zip(ar, start)], skip)
        self.skipped_leaves = [self.names[i] for i in sorted(skip)]
        self.worst_leaves = {"grad_gap": self.names[g_at],
                             "change_gap": self.names[c_at]}
        return {"input_gap": float(input_gap), "loss_gap": loss_gap,
                "grad_gap": grad_gap, "change_gap": change_gap}

    def layer_context(self) -> dict:
        cfg = self.config
        return {"train_flops": counts.css_train_flops(
            cfg["width"], cfg["input_px"], cfg["latent_size"])
            * cfg["batch_size"] * self.steps_run,
            "train_peak": counts.FP32_FLOPS}
