"""Build the demo's assets: the decoder, the scene and the CSS net.

The port of scripts/make_demo_assets.py, on the card by default. It
makes a self-consistent demo scene and the small nets that label it:

1. ``fit_deepsdf``: a 3x64 DeepSDF decoder (latent size 3) fitted to one
   car-proportioned rounded box (tools/quality_suite.py's fit with one
   shape: L1 on SDFs clipped to +-0.1, optax-order Adam at 1e-3), written
   as the reference's .pt + .json pair;
2. the scene: the decoded surface (grid 40, capacity 4096) rendered at the
   ground-truth pose as a disc NOCS image of the crop's size (the bins
   kernel and the row-binned splat forward on the card) gives the image's
   car, the LIDAR (visible surface points, ground and clutter, drawn from
   ``np.random.RandomState(SEED)`` in the script's order), the depth map
   (data/kitti.py::get_kitti_frame) and the KITTI label
   (engine/labels.py::get_kitti_label, the code the driver's labels come
   from, so that a perfect refinement reproduces it);
3. ``train_css``: a width-8 CSSNet overfitted on jittered demo crops (the
   background zeroed in half of them, as the MaskRCNN branch does), its
   four cross-entropy terms through kernel 5 on the card;
4. MaskRCNN-style labels: a jittered box and the true instance mask.

Writes ``deepsdf_demo.{pt,json}``, ``css_demo.msgpack``,
``kitti_sample.npz``, ``maskrcnn.npz`` and ``config_demo.ini`` (its nets'
paths pointing there) under ``--out`` only; the committed
``data/optimization/`` and ``configs/`` are refused and never written.

    python -m sdflabel_tpu_torch.tools.demo_assets [--out DIR] \\
        [--fit-steps 2500] [--css-steps 800] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from sdflabel_tpu_torch.data import kitti as kitti_mod
from sdflabel_tpu_torch.engine import labels as labels_mod
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.pipelines import refine_css as refine_pipe
from sdflabel_tpu_torch.tools import quality_suite as qs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
COMMITTED = (os.path.join(ROOT, "data", "optimization"),
             os.path.join(ROOT, "configs"),
             os.path.join("data", "optimization"), "configs")
OUT = os.path.join("data", "optimization_remade")
SEED = 0

# the scene (make_demo_assets.py:48-58)
YAW_GT = 0.4
SCALE_GT = 2.0
TRANS_CAM = np.array([0.5, 0.9, 10.0])  # camera frame, meters
HALF = np.array([0.40, 0.375, 0.975])  # model-frame half extents (w,h,l)/2/scale
IMG_H, IMG_W = 160, 416
FOCAL, CX, CY = 320.0, 208.0, 80.0
LATENT_GT = np.array([1.0, 0.0, 0.0], np.float32)
SHAPES = [(LATENT_GT, HALF)]  # the fit's one (latent, half) pair

FIT_STEPS = 2500
CSS_STEPS = 800
CSS_WIDTH = 8
CSS_BATCH = 4
CAPACITY = 4096
PAD = 6  # px around the projected surface
LIDAR_CAR = 4000  # visible surface points kept at most


def fit_config() -> deepsdf.DeepSDFConfig:
    return qs.fit_config((64, 64, 64))


def fit_deepsdf(steps: int = FIT_STEPS,
                generator: torch.Generator | None = None, device="cuda",
                log_every: int = 500):
    """The decoder fitted to the box of HALF at LATENT_GT
    (make_demo_assets.py:69-101): quality_suite.fit_deepsdf with the
    demo's config and one shape, its weights from SEED and its draws from
    SEED + 1. Returns (config, parameters, the L1 of every step)."""
    return qs.fit_deepsdf(steps, generator, device, log_every,
                          cfg=fit_config(), shapes=SHAPES, seed=SEED)


def render_gt(rend: qs.Renderer):
    """The surface at LATENT_GT rendered at the ground-truth pose
    (make_demo_assets.py:126-159). Returns the crop box (l, t, r, b) of
    the projected surface with PAD px around it, the NOCS image (3, ch,
    cw) in [0, 1], the mask (ch, cw) and the visible surface points in the
    camera frame (n_vis, 3), metric."""
    surf = rend.surface(LATENT_GT)
    pose = refine_mod.build_render_pose(
        torch.tensor([YAW_GT], dtype=torch.float32, device=rend.device),
        torch.as_tensor(TRANS_CAM / SCALE_GT, dtype=torch.float32,
                        device=rend.device))
    pose_np = pose.cpu().numpy()
    rot, t = pose_np[:3, :3], pose_np[:3, 3]
    cam_pts = (rot @ surf.points.cpu().numpy()[surf.mask.cpu().numpy()].T
               ).T + t
    u = cam_pts[:, 0] / cam_pts[:, 2] * FOCAL + CX
    v = cam_pts[:, 1] / cam_pts[:, 2] * FOCAL + CY
    l = max(int(u.min()) - PAD, 0)
    r = min(int(u.max()) + PAD, IMG_W - 1)
    t_ = max(int(v.min()) - PAD, 0)
    b = min(int(v.max()) + PAD, IMG_H - 1)
    ch, cw = b - t_, r - l
    K_crop = torch.tensor([[FOCAL, 0, CX - l], [0, FOCAL, CY - t_],
                           [0, 0, 1]], dtype=torch.float32,
                          device=rend.device)
    rendering, points = rend.render(K_crop, surf, pose, (cw, ch))
    nocs = rendering.color.cpu().numpy()
    mask = rendering.mask.cpu().numpy()[0] > 0.5
    vis_cam = points.xyz.cpu().numpy()[points.front_mask.cpu().numpy()] \
        * SCALE_GT
    return (l, t_, r, b), nocs, mask, vis_cam


def build_sample(crop_box, nocs, mask, vis_cam) -> dict:
    """The frame (make_demo_assets.py:162-198): a grey noise image with
    the NOCS render pasted as BGR, the LIDAR (up to LIDAR_CAR visible
    points with 8 mm noise, the ground plane, clutter), the camera and the
    depth map, every draw from np.random.RandomState(SEED) in the
    script's order."""
    rng = np.random.RandomState(SEED)
    l, t_, r, b = crop_box
    image = rng.uniform(0.25, 0.45, (IMG_H, IMG_W, 3)).astype(np.float32)
    rgb = np.transpose(nocs, (1, 2, 0))
    image[t_:b, l:r][mask] = rgb[..., ::-1][mask]  # stored BGR

    n_vis = len(vis_cam)
    keep = rng.permutation(n_vis)[: min(n_vis, LIDAR_CAR)]
    car_pts = vis_cam[keep] + rng.randn(len(keep), 3) * 0.008
    y_ground = TRANS_CAM[1] + HALF[1] * SCALE_GT
    ground = np.stack([
        rng.uniform(-8, 8, 6000),
        np.full(6000, y_ground) + rng.randn(6000) * 0.01,
        rng.uniform(4.0, 22.0, 6000),
    ], 1)
    clutter = np.stack([
        rng.uniform(-8, 8, 1500),
        rng.uniform(-1.0, y_ground, 1500),
        rng.uniform(16.0, 24.0, 1500),
    ], 1)
    lidar = np.concatenate([car_pts, ground, clutter]).astype(np.float32)

    K = np.array([[FOCAL, 0, CX], [0, FOCAL, CY], [0, 0, 1]])
    sample = {"image": image, "orig_cam": K, "world_to_cam": np.eye(4),
              "lidar": lidar}
    depth, _pcd = kitti_mod.get_kitti_frame(sample)
    sample["depth"] = depth.astype(np.float32)
    return sample


def gt_label(rend: qs.Renderer, crop_box, sample: dict) -> dict:
    """The ground-truth annotation through the driver's own label code
    (make_demo_assets.py:201-220), so that it is exactly reachable."""
    label, _scaled, _cam_t = labels_mod.get_kitti_label(
        rend.decoder, rend.grid, LATENT_GT, np.array([SCALE_GT]),
        TRANS_CAM / SCALE_GT, np.array([YAW_GT]), sample["world_to_cam"],
        np.asarray(crop_box), capacity=rend.capacity)
    return {
        "name": "Car",
        "bbox": [int(v) for v in crop_box],
        "location": [float(v) for v in label["location"]],
        "dimensions": [float(v) for v in label["dimensions"]],
        "rotation_y": float(label["rotation_y"]),
        "alpha": float(label["alpha"]),
        "score": 1,
        "truncated": 0.0,
        "occluded": 0,
        "ignore": False,
    }


def crop_sampler(sample: dict, anno: dict, nocs, mask, jitter: int = 3,
                 device="cpu"):
    """sample() -> (normalized crop (3, 128, 128) on `device`, NOCS bins
    (3, 128, 128) int32, mask (128, 128) int32, LATENT_GT): the
    annotation's box jittered (quality_suite.jitter_box), then with
    probability 1/2 the background zeroed (the MaskRCNN branch), the
    in-memory float image resized by the driver's crop transform, the
    targets by quality_suite.crop_targets; the draws from
    np.random.RandomState(SEED + 3) in the script's order
    (make_demo_assets.py:244-262)."""
    l, t_, r, b = anno["bbox"]
    full_nocs = np.zeros((3, IMG_H, IMG_W), np.float32)
    full_nocs[:, t_:b, l:r] = nocs
    full_mask = np.zeros((IMG_H, IMG_W), bool)
    full_mask[t_:b, l:r] = mask
    rng = np.random.RandomState(SEED + 3)

    def draw():
        jl, jt, jr, jb = qs.jitter_box(rng, anno["bbox"], jitter,
                                       (IMG_H, IMG_W))
        crop_bgr = sample["image"][jt:jb, jl:jr].copy()
        m = full_mask[jt:jb, jl:jr]
        if rng.rand() < 0.5:  # maskrcnn branch: background zeroed
            crop_bgr = crop_bgr * m[..., None]
        crop, _ = refine_pipe.transform_bgr_crop(crop_bgr, device=device)
        bins, mask128 = qs.crop_targets(full_nocs, full_mask,
                                        (jl, jt, jr, jb))
        return crop, bins, mask128, LATENT_GT

    return draw


def train_css(sample: dict, anno: dict, nocs, mask, width: int = CSS_WIDTH,
              steps: int = CSS_STEPS, batch: int = CSS_BATCH,
              init: dict | None = None, device="cuda",
              log_every: int = 100):
    """Overfit the CSSNet on the demo crop (make_demo_assets.py:223-300):
    quality_suite.train_css on :func:`crop_sampler`'s crops, the loss the
    three NOCS NLLs, the mask's and 10 x the latent MSE against LATENT_GT.
    `init` (flax variables) is the start, else a draw seeded with SEED.
    Returns the net (train mode) and the loss of every step."""
    device = refine_mod._device(device)
    return qs.train_css(crop_sampler(sample, anno, nocs, mask,
                                     device=device),
                        width, steps, batch, init, SEED, device, log_every,
                        what="css overfit")


def maskrcnn_labels(anno: dict, mask) -> dict:
    """MaskRCNN-style labels (make_demo_assets.py:333-346): the box with
    each side moved by a draw in [-2, 2] from
    np.random.RandomState(SEED + 7) and the true instance mask in it."""
    rng = np.random.RandomState(SEED + 7)
    l, t_, r, b = anno["bbox"]
    jl = max(l + int(rng.randint(-2, 3)), 0)
    jt = max(t_ + int(rng.randint(-2, 3)), 0)
    jr = min(r + int(rng.randint(-2, 3)), IMG_W - 1)
    jb = min(b + int(rng.randint(-2, 3)), IMG_H - 1)
    full_mask = np.zeros((IMG_H, IMG_W), np.float32)
    full_mask[t_:b, l:r] = mask
    return {"bboxes": np.asarray([[jl, jt, jr, jb]], np.float32),
            "mask_0": full_mask[jt:jb, jl:jr]}


CONFIG = """[input]
kitti_path = data/db/kitti/
css_path = {css}
css_width = {width}
deepsdf_path = {dsdf}
label_type = gt
diff_annos = easy
grid_density = 40
rendering_area = 32
[optimization]
iters = 60
pose_estimator = kabsch
precision = float32
[visualization]
viz_type = 3d
[losses]
2d_weight = 0.3
3d_weight = 0.5
[output]
labels = demo_out
"""


def write_assets(out: str, dcfg, dparams, css_model, sample: dict,
                 anno: dict, maskrcnn: dict,
                 width: int = CSS_WIDTH) -> None:
    """Every asset under `out` (make_demo_assets.py:303-372), in the
    formats the JAX package and the port read."""
    os.makedirs(out, exist_ok=True)
    dsdf = os.path.join(out, "deepsdf_demo.pt")
    css = os.path.join(out, "css_demo.msgpack")
    deepsdf.save_torch_checkpoint(dsdf, dcfg, dparams)
    qs.save_css(css, css_model)
    annos_json = json.dumps({
        "annos": {"easy": [anno], "medium": [], "hard": []},
        "gt": [anno],
    })
    np.savez_compressed(
        os.path.join(out, "kitti_sample.npz"),
        image=sample["image"], depth=sample["depth"],
        orig_cam=sample["orig_cam"], world_to_cam=sample["world_to_cam"],
        lidar=sample["lidar"], annos_json=np.asarray(annos_json))
    np.savez_compressed(os.path.join(out, "maskrcnn.npz"), **maskrcnn)
    with open(os.path.join(out, "config_demo.ini"), "w") as f:
        f.write(CONFIG.format(css=css, width=width, dsdf=dsdf))


def check_out(path: str) -> str:
    """`path`, refused where it resolves to or into the committed
    data/optimization/ or configs/."""
    return qs.refuse_committed(path, COMMITTED, "--out", "demo assets")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT,
                    help="where the assets are written; never "
                         "data/optimization or configs")
    ap.add_argument("--fit-steps", type=int, default=FIT_STEPS)
    ap.add_argument("--css-steps", type=int, default=CSS_STEPS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = check_out(args.out)
    device = refine_mod._device(args.device)
    seconds = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return res

    print("fitting the demo DeepSDF to the car box ...", flush=True)
    dcfg, dparams, _ = timed("fit", lambda: fit_deepsdf(args.fit_steps,
                                                        device=device))

    def scene():
        rend = qs.Renderer(deepsdf.sdf_fn(dcfg, dparams), device, CAPACITY)
        crop_box, nocs, mask, vis_cam = render_gt(rend)
        sample = build_sample(crop_box, nocs, mask, vis_cam)
        return crop_box, nocs, mask, sample, gt_label(rend, crop_box,
                                                      sample)

    print("rendering the ground-truth scene ...", flush=True)
    crop_box, nocs, mask, sample, anno = timed("scene", scene)
    print("  GT:", {k: anno[k] for k in
                    ("bbox", "location", "dimensions", "rotation_y")},
          flush=True)
    print("overfitting the CSS net on the demo crop ...", flush=True)
    model, _ = timed("css", lambda: train_css(
        sample, anno, nocs, mask, steps=args.css_steps, device=device))
    write_assets(out, dcfg, dparams, model, sample, anno,
                 maskrcnn_labels(anno, mask))
    print(f"assets written to {out}; seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
          flush=True)
    return anno, seconds


if __name__ == "__main__":
    main()
