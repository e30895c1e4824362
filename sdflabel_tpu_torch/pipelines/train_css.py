"""CSS network training pipeline.

Counterpart of sdflabel_tpu/pipelines/train_css.py (reference
pipelines/train_css.py:12-116): Adam over the crops database, CE/MSE
losses, per-epoch network export, resumable checkpoints and PNG dumps.

Each epoch's batches are read on the host (PNG decode, augmentation
draws; data/crops.py) and augmented on the card; the train step
(engine/css_train.py) runs there too. The network lands as
``log_dir/net/css.msgpack`` in the JAX package's flax layout, which
models/css.py::load_css and the JAX package's ``load_checkpoint`` both
read; the full train state goes to ``log_dir/ckpt/step_<epoch>.pt``, from
which a restarted run resumes.
"""

from __future__ import annotations

import configparser
import os

import numpy as np
import torch

from sdflabel_tpu_torch import config as cfg_mod
from sdflabel_tpu_torch.data.crops import (Crops, normalize_rgb,
                                          prefetch_iterator)
from sdflabel_tpu_torch.engine import css_train
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.models import css as css_mod
from sdflabel_tpu_torch.utils import checkpoint as ckpt_mod
from sdflabel_tpu_torch.utils import flax_msgpack, png


def setup_css(model_path: str | None = None, rng_seed: int = 0,
              width: int = 64, latent_size: int = 3,
              device="cuda") -> css_mod.CSSNet:
    """A CSS network from a flax-msgpack checkpoint when `model_path`
    exists, else with flax's initial weights drawn from `rng_seed`."""
    if model_path and os.path.exists(model_path):
        model = css_mod.load_css(model_path, width, latent_size, device)
        print("CSS net restored.")
        return model
    model = css_mod.CSSNet(width=width, latent_size=latent_size)
    css_mod.init_params(model, torch.Generator().manual_seed(rng_seed))
    return model.to(device)


def _save_png(path: str, chw_array, normalize: bool = True) -> None:
    """(C, H, W) or (B, C, H, W) (side by side) -> an 8-bit RGB PNG,
    min-max scaled when `normalize`."""
    arr = np.asarray(chw_array, np.float32)
    if arr.ndim == 4:
        arr = np.concatenate(list(arr), axis=-1)
    img = np.transpose(arr, (1, 2, 0))
    if normalize:
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-8)
    png.write(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))


def _dump_pngs(state, batch: dict, vis_dir: str, epoch: int) -> None:
    """The reference's per-epoch images: the eval-mode prediction on the
    epoch's last batch, its UVW labels and its RGB."""
    model = state.model
    model.eval()
    with torch.no_grad():
        rgb = batch["rgb"]
        pred = model(normalize_rgb(rgb) if rgb.dtype == torch.uint8
                     else rgb)
    model.train()
    os.makedirs(vis_dir, exist_ok=True)
    _save_png(os.path.join(vis_dir, f"uvw_predsm_{epoch}.png"),
              pred["uvw_sm_masked"].cpu().numpy())
    _save_png(os.path.join(vis_dir, f"uvw_gt{epoch}.png"),
              batch["uvw"].cpu().numpy().astype(np.float32) / 255.0)
    _save_png(os.path.join(vis_dir, f"uvw_gt_rgb{epoch}.png"),
              batch["rgb"].cpu().numpy())


def train_css(cfgp, max_epochs: int | None = None, device="cuda",
              width: int = 64, step_wrapper=None):
    """Train the CSS network (train_css.py:12 entry point) on `device`.

    `cfgp`: a ConfigParser of configs/config_train.ini or a TrainCfg.
    `width` is the network width (64: the reference). `step_wrapper`, if
    given, wraps the train step (e.g. to time or watch it). Returns the
    engine/css_train.py::TrainState."""
    cfg = (cfgp if isinstance(cfgp, cfg_mod.TrainCfg)
           else cfg_mod.TrainCfg.from_ini(cfgp))
    # refuse before touching data or checkpoints: a typo must not train fp32
    if cfg.precision not in ("float32", "bfloat16", "float16"):
        raise ValueError(f"[train] precision must be float32|bfloat16|"
                         f"float16, got {cfg.precision!r}")
    if cfg.precision != "float32":
        raise NotImplementedError(
            f"[train] precision = {cfg.precision}: mixed-precision training "
            "is not ported yet; use float32")
    dev = refine_mod._device(device)
    # fp32 convolutions and matmuls stay fp32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(cfg.log_dir, exist_ok=True)

    trainset = Crops(cfg.data_path, seed=None if cfg.seed < 0 else cfg.seed,
                     stage="uint8")
    trainset.preload(num_threads=max(cfg.cpu_threads, 4))
    # latent head sized from the database's supervision
    latent_size = len(trainset.gt["0"][0]["latent"])
    model = setup_css(cfg.css_path, width=width, latent_size=latent_size,
                      device=dev)
    state = css_train.init_train_state(model, cfg.lr)

    ckpt_dir = os.path.join(cfg.log_dir, "ckpt")
    start_epoch = 0
    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    if latest is not None:
        ckpt_mod.restore_train_state(latest, state)
        start_epoch = ckpt_mod.checkpoint_step(latest)
        print(f"Resumed training from {latest} (epoch {start_epoch}).")

    step_fn = css_train.make_train_step(fused_ce=cfg.fused_ce,
                                        direct_ce=cfg.direct_ce)
    if step_wrapper is not None:
        step_fn = step_wrapper(step_fn)

    epochs = max_epochs if max_epochs is not None else cfg.epochs
    last_batch = None
    for epoch in range(start_epoch, epochs):
        trainset.set_epoch(epoch)
        for batch_idx, batch_np in enumerate(prefetch_iterator(
                trainset, cfg.batch_size, num_threads=cfg.cpu_threads,
                queue_size=cfg.queue_size, shuffle=True, seed=epoch)):
            batch = trainset.to_device(batch_np, dev)
            metrics = step_fn(state, batch)
            # float() syncs with the card; log_every keeps steps in flight
            if (batch_idx + 1) % max(cfg.log_every, 1) == 0:
                print("Train Epoch: {} [{}/{}]\tLosses: global - {:.6f}, "
                      "uvw - {:.6f}, mask - {:.6f}, latent - {:.6f}".format(
                          epoch, batch_idx * len(batch_np["rgb"]),
                          len(trainset), float(metrics["loss"]),
                          float(metrics["loss_uvw"]),
                          float(metrics["loss_mask"]),
                          float(metrics["loss_latent"])))
            last_batch = batch

        if (epoch + 1) % cfg.analyse_epoch == 0:
            net_dir = os.path.join(cfg.log_dir, "net")
            os.makedirs(net_dir, exist_ok=True)
            flax_msgpack.save(os.path.join(net_dir, "css.msgpack"),
                              css_mod.state_to_flax(state.model))
            ckpt_mod.save_train_state(ckpt_dir, state, step=epoch + 1)
            if cfg.plot and last_batch is not None:
                _dump_pngs(state, last_batch,
                           os.path.join(cfg.log_dir, "vis"), epoch)
    return state


def make_config(data_path: str, log_dir: str, **train) -> \
        configparser.ConfigParser:
    """configs/config_train.ini with its data and log directories (and any
    [train] keys) replaced, and no CSS checkpoint to start from."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cfgp = cfg_mod.load_ini(os.path.join(root, "configs",
                                         "config_train.ini"))
    cfgp.set("input", "data_path", data_path)
    cfgp.set("input", "css_path", "")
    cfgp.set("log", "dir", log_dir)
    for k, v in train.items():
        section = "log" if k == "plot" else "train"
        cfgp.set(section, k, str(v))
    return cfgp
