"""Typed INI configs for refinement and CSS training.

Counterpart of sdflabel_tpu/config.py (RefineCfg, TrainCfg and the
read_cfg_* helpers), kept key for key so that the same INI files drive
both packages. ``precision`` maps to torch dtypes: 'float16' becomes bfloat16,
as the JAX package maps it for the TPU.
"""

from __future__ import annotations

import configparser
import dataclasses

import torch


def read_cfg_string(cfgp, section, key, default):
    if cfgp.has_option(section, key):
        return cfgp.get(section, key)
    return default


def read_cfg_int(cfgp, section, key, default):
    if cfgp.has_option(section, key):
        return cfgp.getint(section, key)
    return default


def read_cfg_float(cfgp, section, key, default):
    if cfgp.has_option(section, key):
        return cfgp.getfloat(section, key)
    return default


def read_cfg_bool(cfgp, section, key, default):
    if cfgp.has_option(section, key):
        return cfgp.get(section, key) in ["True", "true"]
    return default


PRECISIONS = {"float16": torch.bfloat16, "bfloat16": torch.bfloat16,
              "float32": torch.float32}


def precision_dtype(name: str) -> torch.dtype:
    """Decoder compute dtype for [optimization] precision; unknown names
    fall back to float32, as in the JAX runtime."""
    return PRECISIONS.get(name, torch.float32)


def read_cfg_precision(cfgp, section, key, default):
    if cfgp.has_option(section, key):
        s = cfgp.get(section, key)
        if s in PRECISIONS:
            return PRECISIONS[s]
    return default


@dataclasses.dataclass
class RefineCfg:
    """configs/config_refine.ini, all keys (see sdflabel_tpu.config)."""

    kitti_path: str = "data/db/kitti/"
    css_path: str = "data/nets/css.pt"
    css_width: int = 64
    deepsdf_path: str = "data/nets/deepsdf.pt"
    label_type: str = "maskrcnn"  # gt | rcnn | maskrcnn
    maskrcnn_labels_path: str = ""
    diff_annos: str = "easy"
    grid_density: int = 40
    rendering_area: int = 32
    iters: int = 60
    coarse_cells: int = 0
    pose_estimator: str = "kabsch"
    precision: str = "float16"
    select_bf16: bool = False
    select_pallas: bool = True
    stage2_pallas: bool = False
    warm_band: int = 8192
    warm_refresh: int = 10
    warm_refresh_cells: int = 0
    render_bucket: int = 8
    stress_init_yaw_deg: float = 0.0
    stress_init_trans_m: float = 0.0
    stress_init_scale: float = 0.0
    stress_init_latent: float = 0.0
    viz_type: str = "none"
    viz_live: bool = False
    weight_2d: float = 0.3
    weight_3d: float = 0.5
    labels_out: str = "test_labels"
    eval_filter: str = "kitti"

    @classmethod
    def from_ini(cls, cfgp: configparser.ConfigParser) -> "RefineCfg":
        s, i, f, b = (read_cfg_string, read_cfg_int, read_cfg_float,
                      read_cfg_bool)
        return cls(
            kitti_path=s(cfgp, "input", "kitti_path", cls.kitti_path),
            css_path=s(cfgp, "input", "css_path", cls.css_path),
            css_width=i(cfgp, "input", "css_width", cls.css_width),
            deepsdf_path=s(cfgp, "input", "deepsdf_path", cls.deepsdf_path),
            label_type=s(cfgp, "input", "label_type", cls.label_type),
            maskrcnn_labels_path=s(cfgp, "input", "maskrcnn_labels_path",
                                   cls.maskrcnn_labels_path),
            diff_annos=s(cfgp, "input", "diff_annos", cls.diff_annos),
            grid_density=i(cfgp, "input", "grid_density", cls.grid_density),
            rendering_area=i(cfgp, "input", "rendering_area",
                             cls.rendering_area),
            iters=i(cfgp, "optimization", "iters", cls.iters),
            coarse_cells=i(cfgp, "optimization", "coarse_cells",
                           cls.coarse_cells),
            pose_estimator=s(cfgp, "optimization", "pose_estimator",
                             cls.pose_estimator),
            precision=s(cfgp, "optimization", "precision", cls.precision),
            select_bf16=b(cfgp, "optimization", "select_bf16",
                          cls.select_bf16),
            select_pallas=b(cfgp, "optimization", "select_pallas",
                            cls.select_pallas),
            stage2_pallas=b(cfgp, "optimization", "stage2_pallas",
                            cls.stage2_pallas),
            warm_band=i(cfgp, "optimization", "warm_band", cls.warm_band),
            warm_refresh=i(cfgp, "optimization", "warm_refresh",
                           cls.warm_refresh),
            warm_refresh_cells=i(cfgp, "optimization", "warm_refresh_cells",
                                 cls.warm_refresh_cells),
            render_bucket=i(cfgp, "optimization", "render_bucket",
                            cls.render_bucket),
            stress_init_yaw_deg=f(cfgp, "stress", "init_yaw_deg",
                                  cls.stress_init_yaw_deg),
            stress_init_trans_m=f(cfgp, "stress", "init_trans_m",
                                  cls.stress_init_trans_m),
            stress_init_scale=f(cfgp, "stress", "init_scale_frac",
                                cls.stress_init_scale),
            stress_init_latent=f(cfgp, "stress", "init_latent_sigma",
                                 cls.stress_init_latent),
            viz_type=s(cfgp, "visualization", "viz_type", cls.viz_type),
            viz_live=b(cfgp, "visualization", "live", cls.viz_live),
            weight_2d=f(cfgp, "losses", "2d_weight", cls.weight_2d),
            weight_3d=f(cfgp, "losses", "3d_weight", cls.weight_3d),
            labels_out=s(cfgp, "output", "labels", cls.labels_out),
            eval_filter=s(cfgp, "evaluation", "filter", cls.eval_filter),
        )


@dataclasses.dataclass
class TrainCfg:
    """configs/config_train.ini, all keys (see sdflabel_tpu.config).

    The port trains in float32 only (other precisions are refused by
    pipelines/train_css.py) and has one input chain, the device-side form
    of the JAX package's fast path (data/crops.py), so ``fast_input`` is
    read and changes nothing. ``fused_ce`` routes the CE towers through
    kernel 5 on the card; ``direct_ce`` feeds them the raw head logits.
    """

    data_path: str = "data/db/crops/"
    css_path: str = "data/nets/css.pt"
    seed: int = 1  # augmentation / shuffle seed; -1 = unseeded
    batch_size: int = 13
    precision: str = "float32"
    fused_ce: bool = False
    direct_ce: bool = True
    fast_input: bool = False
    epochs: int = 5000000
    lr: float = 0.001
    queue_size: int = 10
    cpu_threads: int = 0
    analyse_epoch: int = 1
    plot: bool = True
    log_dir: str = "log/demo/"
    log_every: int = 1

    @classmethod
    def from_ini(cls, cfgp: configparser.ConfigParser) -> "TrainCfg":
        s, i, f, b = (read_cfg_string, read_cfg_int, read_cfg_float,
                      read_cfg_bool)
        return cls(
            data_path=s(cfgp, "input", "data_path", cls.data_path),
            css_path=s(cfgp, "input", "css_path", cls.css_path),
            seed=i(cfgp, "train", "seed", cls.seed),
            batch_size=i(cfgp, "train", "batch_size", cls.batch_size),
            precision=s(cfgp, "train", "precision", cls.precision),
            fused_ce=b(cfgp, "train", "fused_ce", cls.fused_ce),
            direct_ce=b(cfgp, "train", "direct_ce", cls.direct_ce),
            fast_input=b(cfgp, "train", "fast_input", cls.fast_input),
            epochs=i(cfgp, "train", "epochs", cls.epochs),
            lr=f(cfgp, "train", "lr", cls.lr),
            queue_size=i(cfgp, "optimization", "queue_size", cls.queue_size),
            cpu_threads=i(cfgp, "optimization", "cpu_threads",
                          cls.cpu_threads),
            analyse_epoch=i(cfgp, "log", "analyse_epoch", cls.analyse_epoch),
            log_every=i(cfgp, "log", "log_every", cls.log_every),
            plot=b(cfgp, "log", "plot", cls.plot),
            log_dir=s(cfgp, "log", "dir", cls.log_dir),
        )


def load_ini(path: str) -> configparser.ConfigParser:
    cfgp = configparser.ConfigParser()
    if not cfgp.read(path):
        raise FileNotFoundError(f"could not read config file {path!r}")
    return cfgp
