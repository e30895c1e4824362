"""Pose/shape refinement (autolabeling): the KITTI driver and the demo.

Counterpart of sdflabel_tpu/pipelines/refine_css.py (reference
refine_css.py:26-263 and refine_css_demo.py:23-204). Per annotation: crop
+ intrinsics (the MaskRCNN instance mask multiplies the crop), CSS
forward, DeepSDF surface decode, NOCS reprojection, RANSAC pose init,
azimuth constraint + height re-estimation, the refine loop, and the KITTI
label. ``refine_css`` runs that over the frames of a KITTI tree, dumps one
``<frame>.pkl`` per frame and evaluates the labels (KITTI and nuScenes
AP). By default, as in JAX, it refines all of a frame's prepared crops at
once (``refine_crops_batched``: letterboxed into one render bucket, one
refine loop with a crop axis, one host read at the end); ``batched=False``
refines one crop after another, as the reference's loop does. Everything
from the CSS forward to the label extents runs on `device` (the card by
default); the reference's host-side numpy steps (reprojection, label
math) stay numpy.

With ``[visualization] viz_type`` 2d or 3d, each refined crop's
trajectory is re-rendered afterwards and written as PNG and HTML
(``render_trajectory``), and the demo adds its final scene and BEV views.
The options of ``[optimization]`` are JAX's: coarse-to-fine cells
(``coarse_cells``, ``warm_refresh_cells``), ``select_bf16`` and
``pose_estimator = pnp`` (ops/pnp.py).
"""

from __future__ import annotations

import json
import math
import os
import pickle
import shutil
from collections import OrderedDict, defaultdict

import numpy as np
import torch

from sdflabel_tpu_torch import config as cfg_mod
from sdflabel_tpu_torch.data import crops as crops_data
from sdflabel_tpu_torch.data import kitti as kitti_mod
from sdflabel_tpu_torch.engine import labels as labels_mod
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.models import css as css_mod
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import geometry, grid as grid_ops, knn, mlp2_cuda
from sdflabel_tpu_torch.ops import mlp_cuda, pnp, ransac
from sdflabel_tpu_torch.parallel import batched_refine
from sdflabel_tpu_torch.renderer import rasterer as rast_mod
from sdflabel_tpu_torch.utils import viz, viz3d
from sdflabel_tpu_torch.utils.profiling import span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def transform_bgr_crop(crop_bgr: np.ndarray, device="cpu"):
    """BGR float crop -> (normalized, plain) (3, 128, 128) float32 tensors
    (refinement.py:60-84): PIL's ``Image.resize((128, 128), BILINEAR)`` of
    the uint8 RGB crop, rebuilt bit for bit on `device` from Pillow's
    integer tables (data/crops.py::pil_bilinear_table, ::pil_resample:
    the width pass, then the height pass, each rounded to uint8)."""
    rgb8 = (np.clip(crop_bgr[..., ::-1], 0, 1) * 255).astype(np.uint8)
    h, w = rgb8.shape[:2]
    tabs = [crops_data.pil_bilinear_table(n, crops_data.SIZE)
            for n in (w, h)]
    k = max(idx.shape[1] for idx, _ in tabs)

    def stacked(i):
        return torch.as_tensor(np.stack(
            [np.pad(t[i], ((0, 0), (0, k - t[i].shape[1]))) for t in tabs]
        )[None], device=device)

    img = torch.as_tensor(np.ascontiguousarray(rgb8), device=device)
    img = img.permute(2, 0, 1)[None]
    arr = crops_data.pil_resample(img, stacked(0), stacked(1))[0].float() \
        / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=arr.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, device=arr.device)[:, None, None]
    return (arr - mean) / std, arr


def nearest_resize_chw(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """F.interpolate(mode='nearest') for (C, H, W) numpy arrays."""
    _, h, w = img.shape
    th, tw = hw
    ys = (np.arange(th) * h // th).clip(max=h - 1)
    xs = (np.arange(tw) * w // tw).clip(max=w - 1)
    return img[:, ys[:, None], xs[None, :]]


class RefineRuntime:
    """The models, the selection kernel and the RNGs of one refinement
    configuration, on `device`."""

    def __init__(self, cfg: cfg_mod.RefineCfg, css_model: css_mod.CSSNet,
                 dsdf_cfg: deepsdf.DeepSDFConfig, dsdf_params: dict,
                 rng_seed: int = 1, surface_capacity: int | None = None,
                 frustum_capacity: int = 8192,
                 ransac_model_capacity: int = 2048,
                 ransac_scene_capacity: int = 2048,
                 ransac_cfg: ransac.RansacConfig | None = None,
                 device="cuda"):
        self.device = refine_mod._device(device)
        # fp32 matmuls and convolutions stay fp32 on the card (QUIRKS #16)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        self.dsdf_cfg = dsdf_cfg
        # [optimization] precision: float16 maps to bf16 (QUIRKS #16); the
        # decoder computes in that dtype, the sdf comes back as fp32 for
        # the isosurface, top-k and everything downstream
        self.compute_dtype = cfg_mod.precision_dtype(cfg.precision)
        dsdf_params = deepsdf.cast_params(
            deepsdf._map_tree(lambda t: t.to(self.device), dsdf_params),
            self.compute_dtype)
        self.dsdf_params = dsdf_params
        base = deepsdf.sdf_fn(dsdf_cfg, dsdf_params)
        cdt = self.compute_dtype

        def decoder(latent, points):
            return base(latent.to(cdt), points.to(cdt)).float()

        self.decoder = decoder
        # the selection decoder: the selection kernel, packed after the
        # precision cast as the JAX runtime packs it, wins where it
        # applies (None outside its contract, e.g. widths that are not
        # multiples of 128); else [optimization] select_bf16, a bf16 twin
        # of the decoder, and only over an fp32 decoder (under float16 the
        # selection already runs in bf16), as in JAX
        self.select_decoder = (mlp_cuda.select_fn(dsdf_cfg, dsdf_params)
                               if cfg.select_pallas else None)
        if (self.select_decoder is None and cfg.select_bf16
                and self.compute_dtype == torch.float32):
            self.select_decoder = deepsdf.select_sdf_fn(dsdf_cfg,
                                                        dsdf_params)
        # the fused stage-2 decode (kernels 4a, 4b), packed the same way;
        # outside the packer's contract stage 2 stays plain, as in JAX
        self.stage2_fn = (mlp2_cuda.stage2_fn(dsdf_cfg, dsdf_params)
                          if cfg.stage2_pallas else None)
        self.stage2_route = "plain" if self.stage2_fn is None else "kernel"
        self.grid_points = grid_ops.generate_point_grid(cfg.grid_density,
                                                        device=self.device)
        self.surface_capacity = (surface_capacity if surface_capacity
                                 is not None
                                 else min(8192, cfg.grid_density ** 3))
        self.frustum_capacity = frustum_capacity
        # [optimization] coarse_cells (0 = off): coarse-to-fine selection
        # each iteration; an explicit setting turns the warm band off
        self.coarse_cells = cfg.coarse_cells or None
        wb = 0 if self.coarse_cells else (cfg.warm_band or 0)
        self.warm_band = min(wb, cfg.grid_density ** 3) if wb else 0
        # [optimization] warm_refresh_cells: the warm refresh through the
        # cell pass. Only on the warm path and with an even density (the
        # cells of coarse_factor 2 partition the grid), clamped to the
        # cell count, and off when the warm pool exceeds the cells' points
        # (small grids): then the refresh ranks the full grid
        wrc = cfg.warm_refresh_cells or 0
        if not self.warm_band or cfg.grid_density % 2:
            wrc = 0
        if wrc:
            wrc = min(wrc, (cfg.grid_density // 2) ** 3)
            if self.warm_band > wrc * 8:
                wrc = 0
        self.warm_refresh_cells = wrc or None
        self.ransac_model_capacity = min(ransac_model_capacity,
                                         self.surface_capacity)
        self.ransac_scene_capacity = ransac_scene_capacity
        self.ransac_cfg = ransac_cfg or ransac.RansacConfig()
        self.css = css_model.to(self.device).eval()
        # parallel/mesh.py::Mesh whose data axis shards the batched refine
        self.mesh = None
        self.reset_rng(rng_seed)

    def reset_rng(self, rng_seed: int = 1):
        # host RNG for scene / frustum subsampling, owned by the runtime
        self.np_rng = np.random.RandomState(rng_seed)
        self.ransac_generator = torch.Generator(
            device=self.device).manual_seed(rng_seed)

    def ransac_ranks(self, num_valid: int) -> torch.Tensor:
        """(H, S) hypothesis ranks for one RANSAC call."""
        return ransac.draw_ranks(num_valid, self.ransac_cfg,
                                 self.ransac_generator)

    @torch.no_grad()
    def css_and_surface(self, crop_rgb: torch.Tensor):
        """(uvw_sm_masked (3,128,128), latent (L,), SurfacePoints)."""
        out = self.css(crop_rgb[None].to(self.device))
        latent = out["latent"][0]
        surf, _ = grid_ops.surface_from_decoder(
            self.decoder, latent, self.grid_points,
            capacity=self.surface_capacity)
        return out["uvw_sm_masked"][0], latent, surf

    @torch.no_grad()
    def surface(self, latent: torch.Tensor) -> grid_ops.SurfacePoints:
        """The two-stage surface of the full grid at `latent`, ranked by the
        selection decoder (kernel 3 where the runtime has it)."""
        surf, _ = grid_ops.surface_from_decoder(
            self.decoder, latent.to(self.device), self.grid_points,
            capacity=self.surface_capacity,
            select_decoder_fn=self.select_decoder)
        return grid_ops.SurfacePoints(*(t.detach() for t in surf))

    def refine_config(self) -> refine_mod.RefineConfig:
        return refine_mod.RefineConfig(
            iters=self.cfg.iters, weight_2d=self.cfg.weight_2d,
            weight_3d=self.cfg.weight_3d,
            surface_capacity=self.surface_capacity,
            coarse_cells=self.coarse_cells, warm_band=self.warm_band,
            warm_refresh=self.cfg.warm_refresh,
            warm_refresh_cells=self.warm_refresh_cells)

    def run_refine(self, prep: dict, bucket: int | None = None):
        """Refine one prepared crop, letterboxed into (h, w) rounded up to
        `bucket` ([optimization] render_bucket) with a pixel mask, as the
        JAX runtime does; padded pixels carry no loss. Returns (final
        RefineParams, history, SurfaceExtents of the final latent)."""
        if bucket is None:
            bucket = self.cfg.render_bucket or 1
        h, w = prep["crop_hw"]
        bh = -(-h // bucket) * bucket
        bw = -(-w // bucket) * bucket
        nocs = np.zeros((3, bh, bw), np.float32)
        nocs[:, :h, :w] = prep["nocs_target"]
        pmask = np.zeros((bh, bw), bool)
        pmask[:h, :w] = True
        rcfg = self.refine_config()
        fn = refine_mod.make_refine_fn(
            self.decoder, rcfg, self.grid_points,
            torch.as_tensor(prep["intrinsics"]), (bh, bw),
            select_decoder=self.select_decoder, stage2_fn=self.stage2_fn,
            device=self.device)
        dev = self.device
        final, hist = fn(prep["params0"], torch.as_tensor(nocs).to(dev),
                         torch.as_tensor(prep["frustum"]).to(dev),
                         torch.as_tensor(prep["fmask"]).to(dev),
                         torch.as_tensor(pmask).to(dev))
        ext = labels_mod.surface_extents(
            self.decoder, self.grid_points, final.latent,
            capacity=self.surface_capacity,
            threshold=rcfg.surface_threshold)
        return final, hist, ext

    def estimate_pose(self, pcd_dsdf, nocs_dsdf, model_mask,
                      scene_pts: np.ndarray, scene_cls: np.ndarray,
                      off_intrinsics=None, nocs_pred_resized=None):
        """Pose init (pose.py:8-38): {'scale', 'rot', 'tra'}, or None when
        no pose is found. kabsch / procrustes: RANSAC on fixed-capacity
        subsamples of the model and scene clouds; pnp: PnP of the NOCS
        image's pixels against its coordinates (ops/pnp.py, on the
        runtime's device), which always gives a pose (identity with fewer
        than 4 pixels), as in JAX."""
        if self.cfg.pose_estimator == "pnp":
            pose = pnp.init_pose_2d(off_intrinsics, nocs_pred_resized,
                                    scale_model=2.0, device=self.device,
                                    generator=self.ransac_generator)
            return {"scale": float(pose["scale"]),
                    "rot": np.asarray(pose["rot"], np.float64),
                    "tra": np.asarray(pose["tra"], np.float64)}
        if scene_pts.shape[0] < 5:
            return None
        cap = self.ransac_scene_capacity
        n = min(scene_pts.shape[0], cap)
        sel = (self.np_rng.choice(scene_pts.shape[0], n, replace=False)
               if scene_pts.shape[0] > cap else np.arange(scene_pts.shape[0]))
        sp = np.zeros((cap, 3), np.float32)
        sc = np.zeros((cap, 3), np.float32)
        sm = np.zeros(cap, bool)
        sp[:n] = scene_pts[sel[:n]]
        sc[:n] = scene_cls[sel[:n]]
        sm[:n] = True
        mcap = self.ransac_model_capacity
        dev = self.device
        scale_model = 2.0 if self.cfg.pose_estimator == "kabsch" else 1.0
        pose = ransac.ransac_pose(
            pcd_dsdf[:mcap], nocs_dsdf[:mcap], model_mask[:mcap],
            torch.as_tensor(sp).to(dev), torch.as_tensor(sc).to(dev),
            torch.as_tensor(sm).to(dev), ranks=self.ransac_ranks(n),
            method=self.cfg.pose_estimator, scale_model=scale_model,
            cfg=self.ransac_cfg)
        if int(pose.num_inliers) < self.ransac_cfg.min_inliers:
            return None  # pose.py:135 "no pose found"
        return {"scale": float(pose.scale),
                "rot": pose.rot.double().cpu().numpy(),
                "tra": pose.tra.double().cpu().numpy()}


def setup_runtime(cfgp_or_cfg, rng_seed: int = 1, device="cuda",
                  mesh=None) -> RefineRuntime:
    """Load the DeepSDF (.pt + .json) and CSS (flax msgpack) weights the
    config names and build the runtime on `device`. `mesh`
    (parallel/mesh.py): the batched refine then shards each frame's crop
    batch over its data axis."""
    cfg = (cfgp_or_cfg if isinstance(cfgp_or_cfg, cfg_mod.RefineCfg)
           else cfg_mod.RefineCfg.from_ini(cfgp_or_cfg))
    device = refine_mod._device(device)
    dsdf_cfg, dsdf_params = deepsdf.load_torch_checkpoint(cfg.deepsdf_path,
                                                          device=device)
    css_model = css_mod.load_css(cfg.css_path, width=cfg.css_width,
                                 latent_size=dsdf_cfg.latent_size,
                                 device=device)
    rt = RefineRuntime(cfg, css_model, dsdf_cfg, dsdf_params, rng_seed,
                       device=device)
    rt.mesh = mesh
    return rt


def prepare_crop(rt: RefineRuntime, sample: dict, anno: dict, maskrcnn=None,
                 bbox_max_id=None):
    """Crop, CSS, surface, reprojection and pose init for one annotation
    (refine_css.py:94-196). With label_type maskrcnn, instance
    `bbox_max_id` of the `maskrcnn` labels masks the crop. Returns what the
    refine loop needs, or None on any of the reference's skip
    conditions."""
    cfg = rt.cfg
    max_crop_area = cfg.rendering_area ** 2
    l, t, r, b = [int(v) for v in anno["bbox"]]
    if r <= l + 2 or b <= t + 2:
        return None
    crop_bgr = sample["image"][t:b, l:r].copy()
    crop_dep = sample["depth"][t:b, l:r].copy()
    crop_size, intrinsics, off_intrinsics = geometry.adjust_intrinsics_crop(
        sample["orig_cam"], crop_bgr.shape[:2], anno["bbox"], max_crop_area)
    pcd_crop, _ = geometry.reproject_np(crop_bgr, crop_dep, off_intrinsics)
    if cfg.label_type == "maskrcnn" and maskrcnn is not None:
        mask = np.asarray(maskrcnn["masks"][bbox_max_id], np.float32)
        crop_bgr = crop_bgr * mask[..., None]

    crop_rgb, _ = transform_bgr_crop(crop_bgr, device=rt.device)
    nocs_dev, latent_dev, surf = rt.css_and_surface(crop_rgb)
    nocs_pred = nocs_dev.cpu().numpy() / 255.0
    latent_pred = latent_dev.cpu().numpy()
    surf_pts_np = surf.points.detach().cpu().numpy()
    surf_mask_np = surf.mask.cpu().numpy()

    nocs_pred_resized = nearest_resize_chw(nocs_pred, crop_dep.shape[:2])
    nocs_3d_pts, nocs_3d_cls = geometry.reproject_np(
        nocs_pred_resized, crop_dep[None], off_intrinsics, filter_nocs=True)

    init_pose = rt.estimate_pose(surf.points.detach(), surf.nocs.detach(),
                                 surf.mask, nocs_3d_pts, nocs_3d_cls,
                                 off_intrinsics=off_intrinsics,
                                 nocs_pred_resized=nocs_pred_resized)
    if init_pose is None:
        print("NO RANSAC POSE FOUND!!!")
        return None
    scale, rot, tra = init_pose["scale"], init_pose["rot"], init_pose["tra"]

    # azimuth-only constraint + yaw (refine_css.py:176-178)
    rot[:, 1] = [0, 1, 0]
    rot[1, :] = [0, 1, 0]
    yaw = geometry.roty_in_bev(
        np.pad(rot @ np.diag([-1.0, 1.0, 1.0]), ((0, 1), (0, 1)))
    ) + math.pi / 2

    # height re-estimation (refine_css.py:180-189)
    pcd_np = surf_pts_np[surf_mask_np]
    world_points = (rot @ (pcd_np * scale).T).T + tra
    proj_world = geometry.project_np(sample["orig_cam"], world_points)
    L, T = proj_world[:, 0].min(), proj_world[:, 1].min()
    R, B = proj_world[:, 0].max(), proj_world[:, 1].max()
    iou = geometry.compute_iou([l, t, r, b], [L, T, R, B])
    if iou < 0.7 and len(nocs_3d_pts):
        print("Restimating height")
        ymin, ymax = world_points[:, 1].min(), world_points[:, 1].max()
        tra[1] = nocs_3d_pts[:, 1].min() + (ymax - ymin) / 2

    # [stress] init perturbation: a seeded kick to the RANSAC init
    if (cfg.stress_init_yaw_deg or cfg.stress_init_trans_m
            or cfg.stress_init_scale or cfg.stress_init_latent):
        srng = rt.np_rng
        yaw = float(yaw) + math.radians(cfg.stress_init_yaw_deg) \
            * (1.0 if srng.rand() < 0.5 else -1.0)
        tra = np.asarray(tra, np.float64) \
            + srng.randn(3) * cfg.stress_init_trans_m
        scale = np.asarray(scale, np.float64) \
            * (1.0 + cfg.stress_init_scale
               * (1.0 if srng.rand() < 0.5 else -1.0))
        latent_pred = np.asarray(latent_pred) + (
            srng.randn(*np.shape(latent_pred))
            * cfg.stress_init_latent).astype(np.float32)

    params0 = refine_mod.init_refine_params(yaw, tra / scale, scale,
                                            latent_pred, device=rt.device)
    h, w = int(crop_size[0]), int(crop_size[1])
    cap = rt.frustum_capacity
    frustum = np.zeros((cap, 3), np.float32)
    fmask = np.zeros(cap, bool)
    n = min(len(pcd_crop), cap)
    if n > 0:
        sel = (rt.np_rng.choice(len(pcd_crop), n, replace=False)
               if len(pcd_crop) > cap else np.arange(len(pcd_crop)))
        frustum[:n] = pcd_crop[sel[:n]]
        fmask[:n] = True
    return {"params0": params0,
            "intrinsics": np.asarray(intrinsics, np.float32),
            "crop_hw": (h, w),
            "nocs_target": nearest_resize_chw(nocs_pred, (h, w)).astype(
                np.float32),
            "frustum": frustum, "fmask": fmask, "anno": anno}


def finish_label(final: refine_mod.RefineParams,
                 extents: labels_mod.SurfaceExtents, sample: dict,
                 anno: dict):
    """KITTI label from the final parameters (refine_css.py:228-236), or
    None when the final latent decodes to an empty band (QUIRKS #15).
    Takes tensors or host arrays."""
    if not bool(extents.valid):
        return None
    host = [np.asarray(t.detach().double().cpu() if torch.is_tensor(t)
                       else t, np.float64) for t in
            (final.yaw, final.scale, final.trans, extents.mn, extents.mx)]
    return labels_mod.kitti_label_from_extents(
        *host, sample["world_to_cam"], anno["bbox"])


def _viz_on(cfg: cfg_mod.RefineCfg) -> bool:
    return bool(cfg.viz_type) and cfg.viz_type != "none"


def _publish(path: str, live_dir: str | None) -> None:
    """Copy a written image to live_dir/latest_<kind>.png, atomically: a
    viewer that reloads it never sees a torn file."""
    if live_dir is None:
        return
    kind = path.rsplit("_", 1)[-1]  # patches.png / frame.png / corr.png
    tmp = os.path.join(live_dir, f".latest_{kind}.tmp")
    shutil.copyfile(path, tmp)
    os.replace(tmp, os.path.join(live_dir, f"latest_{kind}"))


def correspondences(xyz: np.ndarray, front: np.ndarray,
                    frustum: np.ndarray, fmask: np.ndarray, scale: float,
                    device) -> tuple:
    """Model -> scene nearest neighbours in the scale-normalized frame, the
    pairing of the 3D loss (optimizer.py:180-181): (scene (M, 3) float64,
    first-min indices (N,), distances (N,) float64, ok (N,)). The indices
    come from ops/knn.py (kernel 2 on the card), so that no (N, M) matrix
    is built; the distances of the chosen pairs are then taken in float64
    on the host, as JAX takes every one (refine_css.py:682-688); ok is
    front & finite (a crop without a valid scene point has none)."""
    scene = np.asarray(frustum, np.float64) / scale
    dist, idx = knn.nearest_neighbor(
        torch.as_tensor(xyz, dtype=torch.float32, device=device),
        torch.as_tensor(scene, dtype=torch.float32, device=device),
        torch.as_tensor(fmask, device=device))
    idx = idx.cpu().numpy()
    found = np.isfinite(dist.cpu().numpy())
    dmin = np.where(found, np.linalg.norm(xyz - scene[idx], axis=-1),
                    np.inf)
    return scene, idx, dmin, np.asarray(front, bool) & found


def render_trajectory(rt: RefineRuntime, prep: dict, sample: dict,
                      hist: refine_mod.RefineStepOut, out_dir: str,
                      tag: str = "", max_frames: int = 8,
                      live_dir: str | None = None) -> list:
    """The trajectory of one crop's refine, re-rendered afterwards
    (refine_css.py:595-714, the headless analogue of the reference's
    per-iteration views, optimizer.py:160-164): for `max_frames` evenly
    spaced iterations, the parameters that iteration used
    (``hist.params``, (iters, .) of one crop), the full-grid surface of
    its latent (``rt.surface``) rendered at the crop's own size, then

      {tag}iterNNNN_patches.png  rendered against CSS NOCS (visualizer.py
                                 :9-19)
      {tag}iterNNNN_frame.png    normals over the frame's box (:22-48)
      {tag}iterNNNN_corr.png     '3d' only: BEV correspondences (:51-88)
      {tag}scene3d.html          '3d' only: the last frame's scene

    in `out_dir`. With [visualization] live each image is also published
    to live_dir (default out_dir/live) as latest_<kind>.png. Returns the
    written paths."""
    viz_type = rt.cfg.viz_type
    if not _viz_on(rt.cfg):
        return []
    os.makedirs(out_dir, exist_ok=True)
    if live_dir is None and rt.cfg.viz_live:
        live_dir = os.path.join(out_dir, "live")
    if live_dir is not None:
        os.makedirs(live_dir, exist_ok=True)
    dev = rt.device
    used = [t.detach().cpu().numpy() for t in hist.params]  # one read
    iters = used[0].shape[0]
    sel = np.unique(np.linspace(0, iters - 1, max_frames).astype(int))
    h, w = prep["crop_hw"]
    K = torch.as_tensor(prep["intrinsics"], dtype=torch.float32).to(dev)
    written, last = [], None

    def save(plot, path, *args, **kw):
        plot(*args, path=path, **kw)
        written.append(path)
        _publish(path, live_dir)

    for it in sel:
        yaw, trans, scale, lat = (u[it] for u in used)
        # the refine iteration's latent normalization, in float64
        lat = np.asarray(lat, np.float64)
        latent = lat / np.sqrt(max(float(np.sum(lat * lat)), 1e-24))
        surf = rt.surface(torch.as_tensor(latent, dtype=torch.float32))
        pose = refine_mod.build_render_pose(
            torch.as_tensor(yaw, dtype=torch.float32, device=dev),
            torch.as_tensor(trans, dtype=torch.float32, device=dev))
        with torch.no_grad():
            rendering, points = rast_mod.render(
                K, (w, h), surf.points, surf.normals, surf.normals, pose,
                point_mask=surf.mask, rot="dcm", primitives="disc",
                output_nocs=True)
        base = os.path.join(out_dir, f"{tag}iter{it:04d}")
        save(viz.plot_patches, base + "_patches.png",
             rendering.color.cpu().numpy(), prep["nocs_target"])
        if "image" in sample:
            # the frame is BGR (data/kitti.py); the PNG is RGB
            save(viz.plot_full_frame, base + "_frame.png",
                 np.asarray(sample["image"])[..., ::-1],
                 rendering.normals.cpu().numpy(), prep["anno"]["bbox"])
        if viz_type == "3d":
            xyz = points.xyz.cpu().numpy().astype(np.float64)
            scene, idx, dmin, ok = correspondences(
                xyz, points.front_mask.cpu().numpy(), prep["frustum"],
                prep["fmask"], max(float(scale.reshape(-1)[0]), 1e-9), dev)
            smask = np.asarray(prep["fmask"], bool)
            save(viz.plot_correspondences_bev, base + "_corr.png", xyz,
                 scene, idx, np.where(ok, dmin, 0.0), mask_a=ok,
                 mask_b=smask)
            last = (xyz, scene, idx, dmin, ok, smask)
    if last is not None:
        # the orbitable analogue of the reference's Open3D correspondence
        # window, at the last re-rendered iteration
        xyz, scene, idx, dmin, ok, smask = last
        html = os.path.join(out_dir, f"{tag}scene3d.html")
        viz3d.export_scene_html(
            html, model_points=xyz[ok], scene_points=scene[smask],
            correspondences={"a": xyz[ok], "b": scene[idx[ok]],
                             "heat": dmin[ok]},
            title=f"correspondences {tag or 'crop'}")
        written.append(html)
    return written


def refine_annotation(rt: RefineRuntime, sample: dict, anno: dict,
                      maskrcnn=None, bbox_max_id=None, verbose: bool = True,
                      viz_dir: str | None = None, viz_tag: str = ""):
    """One annotation end to end: the label dict, or None (skip). With
    `viz_dir` the refine's trajectory is drawn there
    (:func:`render_trajectory`)."""
    prep = prepare_crop(rt, sample, anno, maskrcnn, bbox_max_id)
    if prep is None:
        return None
    final, hist, ext = rt.run_refine(prep)
    if viz_dir is not None:
        render_trajectory(rt, prep, sample, hist, viz_dir, tag=viz_tag)
    if verbose:
        losses = hist.loss.cpu().numpy()
        l2d, l3d = hist.loss_2d.cpu().numpy(), hist.loss_3d.cpu().numpy()
        applied = hist.applied.cpu().numpy()
        print("REFINE {} iters | loss {:.5f} -> {:.5f} "
              "(2D {:.5f} -> {:.5f}, 3D {:.5f} -> {:.5f}, applied {}/{})"
              .format(len(losses), losses[0], losses[-1], l2d[0], l2d[-1],
                      l3d[0], l3d[-1], int(applied.sum()), len(applied)))
    return finish_label(final, ext, sample, prep["anno"])


def batch_inputs(rt: RefineRuntime, preps: list):
    """The batched refine's inputs for a frame's prepared crops, as JAX's
    refine_crops_batched builds them (refine_css.py:762-802): each crop's
    NOCS target letterboxed with a pixel mask into one bucket, the largest
    h and w rounded up to ``render_bucket``, and the batch padded to the
    next power of two with copies of the last crop (the padded lanes cost
    time but change no real crop, and keep the set of shapes small); under
    the runtime's mesh, to at least the data axis's size and a multiple of
    it. Returns ((bh, bw), (params0, K, nocs, frustum, fmask, pixel_mask))
    on the runtime's device."""
    bucket = rt.cfg.render_bucket or 1
    bh = -(-max(p["crop_hw"][0] for p in preps) // bucket) * bucket
    bw = -(-max(p["crop_hw"][1] for p in preps) // bucket) * bucket
    nd = rt.mesh.shape["data"] if rt.mesh is not None else 1
    pb = 1
    while pb < max(len(preps), nd) or pb % nd:
        pb *= 2
    lanes = preps + [preps[-1]] * (pb - len(preps))
    nocs = np.zeros((pb, 3, bh, bw), np.float32)
    pmask = np.zeros((pb, bh, bw), bool)
    for i, p in enumerate(lanes):
        h, w = p["crop_hw"]
        nocs[i, :, :h, :w] = p["nocs_target"]
        pmask[i, :h, :w] = True
    dev = rt.device
    params0 = refine_mod.RefineParams(*(
        torch.stack([p["params0"][k] for p in lanes]).to(dev)
        for k in range(4)))
    host = [np.stack([p[k] for p in lanes])
            for k in ("intrinsics", "frustum", "fmask")]
    K, frustum, fmask = (torch.as_tensor(a).to(dev) for a in host)
    return (bh, bw), (params0, K, torch.as_tensor(nocs).to(dev), frustum,
                      fmask, torch.as_tensor(pmask).to(dev))


def refine_crops_batched(rt: RefineRuntime, sample: dict, preps: list,
                         viz_dir: str | None = None,
                         viz_tag: str = "") -> list:
    """Refine a frame's prepared crops at once (refine_css.py:741-848), on
    the inputs of :func:`batch_inputs`. One host read at the end fetches
    every crop's parameters and extents; the labels (None dropped) in the
    crops' order. With `viz_dir` (and a viz_type) each crop's trajectory
    is drawn from its slice of the history, at its own size, tagged
    ``{viz_tag}cNN_``. Under a profiler the frame is the span
    ``refine.frame`` (utils/profiling.py), counting the real crops'
    pixels and the rendered lanes' (``pixels``, ``lane_pixels``), over
    spans of its inputs, loop, read and labels."""
    if not preps:
        return []
    with span("refine.frame") as frame:
        with span("refine.batch_inputs"):
            bucket, args = batch_inputs(rt, preps)
        frame.count(pixels=sum(p["crop_hw"][0] * p["crop_hw"][1]
                               for p in preps),
                    lane_pixels=len(args[1]) * bucket[0] * bucket[1])
        fn = batched_refine.make_batched_refine(
            rt.decoder, rt.refine_config(), rt.grid_points, bucket,
            select_decoder=rt.select_decoder, stage2_fn=rt.stage2_fn,
            with_extents=True, mesh=rt.mesh, device=rt.device)
        with span("refine.loop"):
            final, hist, ext = fn(*args)
        # one read for every crop's label inputs: yaw, scale, trans,
        # latent, the extents and their validity
        parts = (final.yaw, final.scale, final.trans, final.latent, ext.mn,
                 ext.mx, ext.valid[:, None].float())
        with span("refine.read"):
            rows = torch.cat(parts, 1).cpu().numpy()
        cols = np.cumsum([0] + [t.shape[1] for t in parts])
        yaw, scale, trans, lat, mn, mx, valid = (
            rows[:, a:z] for a, z in zip(cols[:-1], cols[1:]))
        labels = []
        with span("refine.labels"):
            for i, p in enumerate(preps):
                if viz_dir is not None and _viz_on(rt.cfg):
                    hist_i = refine_mod.RefineStepOut(
                        *(t[i] for t in hist[:4]),
                        params=refine_mod.RefineParams(*(t[i] for t in
                                                         hist.params)))
                    render_trajectory(rt, p, sample, hist_i, viz_dir,
                                      tag=f"{viz_tag}c{i:02d}_")
                label = finish_label(
                    refine_mod.RefineParams(yaw[i], trans[i], scale[i],
                                            lat[i]),
                    labels_mod.SurfaceExtents(mn[i], mx[i],
                                              valid[i, 0] > 0.5),
                    sample, p["anno"])
                if label is not None:
                    labels.append(label)
    return labels


def _fuse_maskrcnn(anno, maskrcnn_labels, min_iou=0.5):
    """(box, index) of the MaskRCNN box of largest IoU with the annotation,
    or (None, None) below `min_iou` (refine_css.py:100-114)."""
    ious = [geometry.get_iou(np.asarray(bbox, np.float64), anno["bbox"])
            for bbox in np.asarray(maskrcnn_labels["bboxes"])]
    bbox_max_id = int(np.argmax(ious))
    if ious[bbox_max_id] < min_iou:
        return None, None
    bbox = np.asarray(maskrcnn_labels["bboxes"][bbox_max_id]).astype(int)
    return bbox, bbox_max_id


def _stack_frame(frame_annos, frame_estimations):
    for key in ("alpha", "bbox", "dimensions", "location", "rotation_y",
                "score"):
        frame_annos[key] = np.asarray(frame_annos[key])
        frame_estimations[key] = np.asarray(frame_estimations[key])


def refine_css(cfgp, subset_frames=None, batched=True, device="cuda",
               mesh=None):
    """The KITTI autolabeling driver (refine_css.py:26): every frame of
    ``[input] kitti_path`` with a car; one ``<frame>.pkl`` of [annotations,
    estimations] per frame in ``[output] labels`` (a frame whose dump
    exists is skipped), then the KITTI and nuScenes evaluation of this
    run's frames. `batched` (the default, as in JAX) refines all of a
    frame's prepared crops at once (``refine_crops_batched``); False
    refines one annotation after another. `mesh` (parallel/mesh.py): every
    rank of it calls refine_css together; each prepares every crop, the
    batched refine shards each frame's crops over the data axis, and
    every rank returns the same labels; only the first rank of the data
    axis writes the dumps and evaluates. Returns (annotations,
    estimations), each an OrderedDict by frame index."""
    np.random.seed(1)
    cfg = (cfgp if isinstance(cfgp, cfg_mod.RefineCfg)
           else cfg_mod.RefineCfg.from_ini(cfgp))
    rt = setup_runtime(cfg, device=device, mesh=mesh)
    writer = mesh is None or mesh.data_index == 0
    viz_dir = (os.path.join(cfg.labels_out, "viz")
               if _viz_on(cfg) and writer else None)
    kitti = kitti_mod.KITTI3D(path=cfg.kitti_path)
    total_annotations, total_estimations = OrderedDict(), OrderedDict()
    os.makedirs(cfg.labels_out, exist_ok=True)
    if subset_frames is None:
        subset_frames = range(len(kitti))

    def dump_path(idx):
        return os.path.join(cfg.labels_out, f"{idx}.pkl")

    for frame_idx, sample in kitti_mod.prefetch_frames(
            kitti, subset_frames,
            skip_fn=lambda i: os.path.exists(dump_path(i))):
        print("Frame", frame_idx)
        if sample is None or os.path.exists(dump_path(frame_idx)):
            print("file exists already!")
            continue
        if not [a for a in sample.get("gt", []) if a["name"] == "Car"]:
            continue
        maskrcnn_labels = None
        if cfg.label_type != "gt":
            mpath = os.path.join(cfg.maskrcnn_labels_path,
                                 f"{frame_idx}.lbl")
            if not os.path.exists(mpath):
                print("Skip frame")
                continue
            maskrcnn_labels = torch.load(mpath, map_location="cpu",
                                         weights_only=False)

        frame_annos, frame_estimations = defaultdict(list), defaultdict(list)
        preps, labels = [], []
        for anno_idx, anno in enumerate(kitti_mod.get_annos(cfg.diff_annos,
                                                            sample)):
            for key, value in anno.items():
                frame_annos[key].append(value)
            bbox_max_id = None
            if cfg.label_type != "gt":
                bbox, bbox_max_id = _fuse_maskrcnn(anno, maskrcnn_labels)
                if bbox is None:
                    print("Skip frame!")
                    continue
                anno = dict(anno, bbox=bbox)
            if batched:
                prep = prepare_crop(rt, sample, anno, maskrcnn_labels,
                                    bbox_max_id)
                if prep is not None:
                    preps.append(prep)
            else:
                labels.append(refine_annotation(
                    rt, sample, anno, maskrcnn_labels, bbox_max_id,
                    viz_dir=viz_dir,
                    viz_tag=f"f{frame_idx:06d}_a{anno_idx:02d}_"))
        if batched:
            labels = refine_crops_batched(rt, sample, preps, viz_dir=viz_dir,
                                          viz_tag=f"f{frame_idx:06d}_")
        # None: no pose, or an empty band (QUIRKS #15)
        for label in filter(None, labels):
            for key, value in label.items():
                frame_estimations[key].append(value)
        if not frame_annos:
            continue
        _stack_frame(frame_annos, frame_estimations)
        if writer:
            with open(dump_path(frame_idx), "wb") as f:
                pickle.dump([frame_annos, frame_estimations], f)
        total_annotations[frame_idx] = frame_annos
        total_estimations[frame_idx] = frame_estimations

    if not total_annotations:
        print("No frames processed (all outputs exist); skipping eval.")
        return total_annotations, total_estimations
    if not writer:
        return total_annotations, total_estimations
    # the in-process evaluation backfills empty predictions (the reference
    # does so only in evaluate_dump.py:37-44)
    from sdflabel_tpu_torch.pipelines import evaluate_dump

    evaluate_dump.evaluate_annotations(
        total_annotations.values(), total_estimations.values(),
        cfg.eval_filter, difficulties=(0,), device=rt.device)
    return total_annotations, total_estimations


def load_demo_sample(root: str = "data/optimization") -> dict:
    """The bundled demo frame, data/optimization/kitti_sample.npz."""
    data = np.load(os.path.join(root, "kitti_sample.npz"))
    sample = {k: data[k] for k in
              ("image", "depth", "orig_cam", "world_to_cam", "lidar")}
    meta = json.loads(str(data["annos_json"]))
    sample["annos"] = meta["annos"]
    sample["gt"] = meta.get("gt", [])
    return sample


def load_demo_maskrcnn(root: str = "data/optimization") -> dict:
    """The bundled demo MaskRCNN labels, data/optimization/maskrcnn.npz:
    `bboxes` (N, 4) and one crop-shaped mask `mask_i` per instance."""
    data = np.load(os.path.join(root, "maskrcnn.npz"))
    bboxes = data["bboxes"]
    return {"bboxes": bboxes,
            "masks": [data[f"mask_{i}"] for i in range(len(bboxes))]}


def refine_css_demo(cfgp, sample=None, device="cuda",
                    rt: RefineRuntime | None = None, maskrcnn=None):
    """Demo refinement of one stored frame (refine_css_demo.py:23): returns
    (frame annotations, frame estimations) as dicts of arrays. `rt` reuses
    a runtime built by setup_runtime. A label_type other than gt takes the
    MaskRCNN box of largest IoU for each annotation (no 0.5 threshold,
    unlike the driver), from `maskrcnn` or the bundled labels, and
    label_type maskrcnn also masks the crop with its instance mask."""
    np.random.seed(1)
    cfg = (cfgp if isinstance(cfgp, cfg_mod.RefineCfg)
           else cfg_mod.RefineCfg.from_ini(cfgp))
    if rt is None:
        rt = setup_runtime(cfg, device=device)
    if sample is None:
        sample = load_demo_sample()
    if cfg.label_type != "gt" and maskrcnn is None:
        maskrcnn = load_demo_maskrcnn()
    viz_dir = (os.path.join(cfg.labels_out, "viz") if _viz_on(cfg)
               else None)

    frame_annos, frame_estimations = defaultdict(list), defaultdict(list)
    est_anno_idx = []  # each estimation's annotation: skips shift them
    for anno_idx, anno in enumerate(kitti_mod.get_annos(cfg.diff_annos,
                                                        sample)):
        for key, value in anno.items():
            frame_annos[key].append(value)
        bbox_max_id = None
        if cfg.label_type != "gt":
            bbox, bbox_max_id = _fuse_maskrcnn(anno, maskrcnn, min_iou=0.0)
            anno = dict(anno, bbox=bbox)
        label = refine_annotation(rt, sample, anno, maskrcnn, bbox_max_id,
                                  viz_dir=viz_dir,
                                  viz_tag=f"demo_a{anno_idx:02d}_")
        if label is None:
            continue
        est_anno_idx.append(anno_idx)
        for key, value in label.items():
            frame_estimations[key].append(value)
    _stack_frame(frame_annos, frame_estimations)
    if viz_dir is not None:
        demo_views(cfg.labels_out, sample, frame_annos, frame_estimations,
                   est_anno_idx)
    return frame_annos, frame_estimations


def demo_views(out_dir: str, sample: dict, frame_annos: dict,
               frame_estimations: dict, est_anno_idx: list) -> list:
    """The headless stand-ins for the reference's final Open3D view
    (refine_css_demo.py:198, plot_3d_final; JAX refine_css.py:1119-1150):
    out_dir/demo_scene3d.html, the LIDAR with every estimated (red) and
    ground-truth (green) cuboid, and a BEV schematic demo_bev_{i}.png per
    estimation, each beside the annotation it came from. Returns the
    written paths."""
    os.makedirs(out_dir, exist_ok=True)
    lidar = sample.get("lidar", np.zeros((0, 3)))
    box_keys = ("dimensions", "location", "rotation_y")
    est = [{k: frame_estimations[k][i] for k in box_keys}
           for i in range(len(frame_estimations.get("location", [])))]
    gt = [{k: frame_annos[k][src] for k in box_keys} for src in est_anno_idx]
    written = [viz3d.export_scene_html(
        os.path.join(out_dir, "demo_scene3d.html"), lidar=lidar,
        est_boxes=est, gt_boxes=gt, title="autolabels vs GT")]
    for i, (e, g) in enumerate(zip(est, gt)):
        path = os.path.join(out_dir, f"demo_bev_{i}.png")
        viz.plot_bev(lidar, label=e, gt_anno=g, path=path)
        written.append(path)
    return written
