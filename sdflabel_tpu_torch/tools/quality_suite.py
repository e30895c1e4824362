"""Build the autolabel-quality suite and its nets: synthetic KITTI frames.

The port of scripts/make_quality_suite.py, on the card by default:

1. ``fit_deepsdf``: one 3x96 DeepSDF decoder fitted to the four
   car-proportioned rounded boxes of ``SHAPES``, one per unit-sphere
   anchor latent (L1 on SDFs clipped to +-0.1, optax-order Adam at 1e-3);
2. the frames, from the same seeded draws as JAX's
   (``np.random.RandomState(SEED + 2)``, in the same order): profile v1,
   1-3 disjoint cars a frame on a ground plane, or profile v2, six
   conditions in turn (clean, occluded, truncated, distant, sparse LIDAR
   and a hard mix) with KITTI truncation and occlusion flags, so that
   difficulties 0-2 are all populated. Each car's appearance is its NOCS
   render on a 320 x 320 canvas (the bins kernel and the row-binned splat
   forward on the card); its ground-truth label is
   engine/labels.py::get_kitti_label, the code the driver's labels come
   from;
3. ``train_suite_css``: the suite's CSS network trained on jittered crops
   re-read from the written PNGs (the driver's own crop transform), its
   four cross-entropy terms through kernel 5 on the card; with
   ``--weak-steps`` also an undertrained "weak" net.

Writes ``training/{image_2,velodyne,calib,label_2}``, the
``mv3d_kitti_split/trainval.txt`` split and ``suite_meta.json``, which
data/kitti.py::KITTI3D reads, and the fitted and trained nets in the
formats the JAX package's loaders read, under ``--nets-out`` only: the
committed ``data/quality_nets/`` is read (``--skip-fit`` takes its
decoder) and never written. Without ``--skip-fit`` the frames come from
the fitted decoder, as in JAX.

    python -m sdflabel_tpu_torch.tools.quality_suite             # v1, all
    python -m sdflabel_tpu_torch.tools.quality_suite --profile v2 \\
        --weak-steps 800
    python -m sdflabel_tpu_torch.tools.quality_suite --profile v2 \\
        --frames 72 --skip-fit --skip-css --out data/quality_suite_v2
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from sdflabel_tpu_torch.data import kitti as kitti_mod
from sdflabel_tpu_torch.engine import css_train
from sdflabel_tpu_torch.engine import deepsdf_train
from sdflabel_tpu_torch.engine import labels as labels_mod
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.models import css as css_mod
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import ce_cuda
from sdflabel_tpu_torch.ops import grid as grid_ops
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.pipelines import refine_css as refine_pipe
from sdflabel_tpu_torch.renderer import rasterer
from sdflabel_tpu_torch.utils import flax_msgpack

SEED = 11
NETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "quality_nets")
NETS_OUT = os.path.join("data", "quality_nets_remade")
CSS_WIDTH = 24  # the v2 suite's CSS network, css_quality_v2.msgpack
# each profile's defaults (make_quality_suite.py:729-735)
PROFILES = {"v1": dict(frames=60, css_steps=4000, css_width=16,
                       out=os.path.join("data", "quality_suite"), suffix=""),
            "v2": dict(frames=72, css_steps=6000, css_width=CSS_WIDTH,
                       out=os.path.join("data", "quality_suite_v2"),
                       suffix="_v2")}
FIT_STEPS = 3500
FIT_POINTS = 4096  # uniform points a fit step, and as many near the box
LR = 1e-3
MAX_MISSES = 1000  # frame draws in a row that give no frame before giving up

IMG_H, IMG_W = 256, 832
FOCAL, CX, CY = 460.0, 416.0, 128.0
GROUND_Y = 1.65  # camera height above the road (camera y points down)
CAPACITY = 8192
CANVAS = 320  # render canvas; each crop is its top-left (ch, cw) window

# unit-sphere latent -> model-frame half extents (w, h, l) / 2 / scale
SHAPES = [
    (np.array([1.0, 0.0, 0.0], np.float32), np.array([0.40, 0.375, 0.975])),
    (np.array([0.0, 1.0, 0.0], np.float32), np.array([0.45, 0.330, 0.900])),
    (np.array([0.0, 0.0, 1.0], np.float32), np.array([0.36, 0.420, 0.950])),
    (np.array([1.0, 1.0, 1.0], np.float32) / np.sqrt(3.0),
     np.array([0.42, 0.360, 1.040])),
]
# KITTI's velodyne -> camera axis permutation; scans are stored in the
# velodyne frame so that the loader's Tr transform is exercised
VELO_TO_CAM = np.array([[0.0, -1.0, 0.0, 0.0],
                        [0.0, 0.0, -1.0, 0.0],
                        [1.0, 0.0, 0.0, 0.0]])
CONDITIONS = ("clean", "occluded", "truncated", "distant", "sparse",
              "hard_mix")


def _no_tf32() -> None:
    # fp32 matmuls and convolutions stay fp32 on the card, as JAX's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- the fit

def box_sdf(pts: torch.Tensor, half: torch.Tensor,
            radius: float = 0.06) -> torch.Tensor:
    """Signed distance of (..., 3) points to the box of half extents
    `half` with its edges rounded by `radius` (make_quality_suite.py:83)."""
    q = pts.abs() - (half - radius)
    outside = torch.linalg.norm(q.clamp(min=0.0), dim=-1)
    inside = q.max(-1).values.clamp(max=0.0)
    return outside + inside - radius


def fit_config(dims: tuple = (96, 96, 96)) -> deepsdf.DeepSDFConfig:
    """The fitted decoder: latent size 3, fp32 hidden layers `dims`."""
    return deepsdf.DeepSDFConfig(latent_size=3, dims=tuple(dims))


@dataclasses.dataclass
class FitState:
    """The decoder's parameters, their Adam state and the steps taken."""

    params: dict
    opt: deepsdf_train.AdamState
    step: int = 0


def fit_state(params: dict) -> FitState:
    """`params` with a fresh Adam state."""
    zeros = deepsdf_train._zeros_like
    count = torch.zeros((), dtype=torch.int32,
                        device=deepsdf_train._leaves(params)[0].device)
    return FitState(params, deepsdf_train.AdamState(count, zeros(params),
                                                    zeros(params)))


def init_fit(device="cpu", cfg: deepsdf.DeepSDFConfig | None = None,
             seed: int = SEED) -> FitState:
    """The decoder's initial weights from a torch.Generator seeded with
    `seed` (JAX's come from PRNGKey(seed): other numbers, the same law)."""
    return fit_state(deepsdf.init_params(
        cfg or fit_config(), torch.Generator().manual_seed(seed),
        device=device))


def fit_draw(generator: torch.Generator, device="cpu",
             n_shapes: int = len(SHAPES)):
    """One step's draws, on `device` from `generator`: the shape index
    (0-dim, below `n_shapes`), FIT_POINTS points uniform in +-1.05 and
    their N(0, 1) noise (jax.random's rows cannot be drawn by torch: the
    port draws its own)."""
    shape_idx = torch.randint(0, n_shapes, (), generator=generator,
                              device=device)
    pu = torch.rand(FIT_POINTS, 3, generator=generator, device=device) \
        * 2.1 - 1.05
    noise = torch.randn(FIT_POINTS, 3, generator=generator, device=device)
    return shape_idx, pu, noise


def fit_step(state: FitState, shape_idx: torch.Tensor, pu: torch.Tensor,
             noise: torch.Tensor, cfg: deepsdf.DeepSDFConfig | None = None,
             shapes=SHAPES) -> tuple[FitState, torch.Tensor]:
    """One Adam step on given draws (make_quality_suite.py:100-116) of the
    decoder `cfg` (by default :func:`fit_config`) on the (latent, half)
    pairs `shapes`: the uniform points and the same points scaled to the
    shape's box plus 0.05 noise, the target clip(box_sdf, +-0.1), L1 on
    the clipped prediction. Returns the new state and the L1 (0-dim, not
    read back)."""
    dev = pu.device
    lats = torch.as_tensor(np.stack([s[0] for s in shapes]),
                           dtype=torch.float32, device=dev)
    halves = torch.as_tensor(np.stack([s[1] for s in shapes]),
                             dtype=torch.float32, device=dev)
    lat, half = lats[shape_idx], halves[shape_idx]
    ps = pu * (half / half.max())  # densify near the box surface
    pts = torch.cat([pu, ps + 0.05 * noise])
    target = box_sdf(pts, half).clamp(-0.1, 0.1)
    leaves = [x.detach().requires_grad_(True)
              for x in deepsdf_train._leaves(state.params)]
    params = deepsdf_train._rebuild(state.params, iter(leaves))
    pred = deepsdf.sdf_fn(cfg or fit_config(), params)(lat, pts).clamp(
        -0.1, 0.1)
    loss = (pred - target).abs().mean()
    # the scale head takes no gradient: zeros, as in JAX
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)]
    updates, opt = deepsdf_train.adam_update(state.opt, grads, LR)
    new = deepsdf_train._rebuild(state.params, iter(
        [p.detach() + u for p, u in zip(leaves, updates)]))
    return FitState(new, opt, state.step + 1), loss.detach()


def fit_deepsdf(steps: int = FIT_STEPS,
                generator: torch.Generator | None = None, device="cuda",
                log_every: int = 500,
                cfg: deepsdf.DeepSDFConfig | None = None, shapes=SHAPES,
                seed: int = SEED):
    """Fit one decoder `cfg` (by default :func:`fit_config`) to every
    (latent, half) pair of `shapes` (make_quality_suite.py:90-126):
    `steps` of :func:`fit_draw` then :func:`fit_step` from
    :func:`init_fit`'s weights drawn with `seed`, the draws from
    `generator` (by default one on `device` seeded with seed + 1).
    Returns (config, parameters, the L1 of every step as a (steps,)
    tensor)."""
    device = refine_mod._device(device)
    _no_tf32()
    cfg = cfg or fit_config()
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed + 1)
    state = init_fit(device, cfg, seed)
    losses = []
    for i in range(steps):
        state, loss = fit_step(state, *fit_draw(generator, device,
                                                len(shapes)), cfg, shapes)
        losses.append(loss)
        if i % log_every == 0:
            print(f"  deepsdf fit step {i}: L1 {float(loss):.5f}",
                  flush=True)
    losses = torch.stack(losses) if losses else torch.zeros(0)
    if steps:
        print(f"  deepsdf fit final: L1 {float(losses[-1]):.5f}",
              flush=True)
    return cfg, state.params, losses


def fit_eval_points(n: int = 16384, seed: int = SEED + 7):
    """A fixed evaluation set for any fitted decoder: per shape `n`
    points drawn as a fit step draws them (numpy, `seed`): (4, 2n, 3)
    points and their clipped box SDFs (4, 2n)."""
    rng = np.random.RandomState(seed)
    pts, tgt = [], []
    for _lat, half in SHAPES:
        pu = rng.uniform(-1.05, 1.05, (n, 3))
        ps = pu * (half / half.max()) + 0.05 * rng.randn(n, 3)
        p = torch.as_tensor(np.concatenate([pu, ps]), dtype=torch.float32)
        pts.append(p)
        tgt.append(box_sdf(p, torch.as_tensor(half, dtype=torch.float32))
                   .clamp(-0.1, 0.1))
    return torch.stack(pts), torch.stack(tgt)


def fit_eval_l1(cfg: deepsdf.DeepSDFConfig, params: dict) -> float:
    """The decoder's L1 on :func:`fit_eval_points`, every shape with its
    anchor latent, the prediction clipped as in the fit."""
    pts, tgt = fit_eval_points()
    dev = deepsdf_train._leaves(params)[0].device
    fn = deepsdf.sdf_fn(cfg, params)
    total = 0.0
    with torch.no_grad():
        for (lat, _half), p, t in zip(SHAPES, pts, tgt):
            pred = fn(torch.as_tensor(lat, dtype=torch.float32, device=dev),
                      p.to(dev)).clamp(-0.1, 0.1)
            total += float((pred.cpu() - t).abs().mean())
    return total / len(SHAPES)


class Renderer:
    """The decoder's surface on the grid-40 lattice at `capacity` points
    and its NOCS render, on `device`."""

    def __init__(self, decoder, device, capacity: int = CAPACITY):
        self.decoder = decoder
        self.device = torch.device(device)
        self.capacity = capacity
        self.grid = grid_ops.generate_point_grid(40, device=self.device)

    def surface(self, latent):
        with torch.no_grad():
            surf, _ = grid_ops.surface_from_decoder(
                self.decoder, torch.as_tensor(latent, dtype=torch.float32,
                                              device=self.device),
                self.grid, capacity=self.capacity)
        return surf

    def render(self, K, surf, pose, resolution=(CANVAS, CANVAS)):
        """The disc NOCS render at `resolution` (w, h), by default the
        canvas (the bins kernel and 1c on the card from 4096 px up)."""
        with torch.no_grad():
            return rasterer.render(
                K, tuple(resolution), surf.points, surf.normals,
                surf.normals, pose, point_mask=surf.mask, rot="dcm",
                primitives="disc", output_nocs=True,
                bin_px=splat_cuda.BIN_AUTO_PX)


def render_car(rend: Renderer, latent, yaw, scale, trans_cam, pad=6):
    """One car's crop box, NOCS image, mask, camera-frame visible surface
    points, metric depth of the crop and unclamped projected extents
    (make_quality_suite.py:154-194), or None when the crop does not fit."""
    surf = rend.surface(latent)
    dev = rend.device
    pose = refine_mod.build_render_pose(
        torch.tensor([yaw], dtype=torch.float32, device=dev),
        torch.as_tensor(np.asarray(trans_cam) / scale, dtype=torch.float32,
                        device=dev))
    pose_np = pose.cpu().numpy()
    rot, t = pose_np[:3, :3], pose_np[:3, 3]
    model_pts = surf.points.cpu().numpy()[surf.mask.cpu().numpy()]
    cam_pts = (rot @ model_pts.T).T + t
    u = cam_pts[:, 0] / cam_pts[:, 2] * FOCAL + CX
    v = cam_pts[:, 1] / cam_pts[:, 2] * FOCAL + CY
    full_uv = (float(u.min()), float(v.min()), float(u.max()),
               float(v.max()))
    l = max(int(u.min()) - pad, 0)
    r = min(int(u.max()) + pad, IMG_W - 1)
    t_ = max(int(v.min()) - pad, 0)
    b = min(int(v.max()) + pad, IMG_H - 1)
    ch, cw = b - t_, r - l
    if ch < 8 or cw < 8 or ch > CANVAS or cw > CANVAS:
        return None
    K_crop = torch.tensor([[FOCAL, 0, CX - l], [0, FOCAL, CY - t_],
                           [0, 0, 1]], dtype=torch.float32, device=dev)
    rendering, points = rend.render(K_crop, surf, pose)
    nocs = rendering.color.cpu().numpy()[:, :ch, :cw]
    mask = rendering.mask.cpu().numpy()[0, :ch, :cw] > 0.5
    depth = rendering.depth.cpu().numpy()[0, :ch, :cw] * scale  # metric
    vis_cam = points.xyz.cpu().numpy()[points.front_mask.cpu().numpy()] \
        * scale
    return (l, t_, r, b), nocs, mask, vis_cam, depth, full_uv


def sample_objects(rng, n_obj):
    """Cars with disjoint conservative projected boxes
    (make_quality_suite.py:197-229)."""
    objs, boxes = [], []
    tries = 0
    while len(objs) < n_obj and tries < 200:
        tries += 1
        shape_idx = rng.randint(len(SHAPES))
        latent, half = SHAPES[shape_idx]
        scale = rng.uniform(1.9, 2.1)
        yaw = rng.uniform(-np.pi, np.pi)
        z = rng.uniform(8.0, 13.5)
        x = rng.uniform(-0.55, 0.55) * z
        obj = {"shape_idx": shape_idx, "latent": latent, "half": half,
               "scale": scale, "yaw": yaw,
               # bottom on the ground plane
               "trans": np.array([x, GROUND_Y - half[1] * scale, z])}
        box = _proj_box(obj)
        if _in_image(box) and _disjoint(box, boxes):
            boxes.append(box)
            objs.append(obj)
    return objs


def _paste(frame, crop_box, nocs, mask):
    """Paste one car's render into the frame's BGR image and its
    full-frame NOCS and mask (for the CSS training)."""
    image, full_nocs, full_mask = frame
    l, t_, rr, b = crop_box
    rgb = np.transpose(nocs, (1, 2, 0))
    image[t_:b, l:rr][mask] = rgb[..., ::-1][mask]  # stored BGR
    full_nocs[:, t_:b, l:rr][:, mask] = np.transpose(rgb[mask], (1, 0))
    full_mask[t_:b, l:rr] |= mask


def _new_frame(rng):
    return (rng.uniform(0.25, 0.45, (IMG_H, IMG_W, 3)).astype(np.float32),
            np.zeros((3, IMG_H, IMG_W), np.float32),
            np.zeros((IMG_H, IMG_W), bool))


def build_frame(rend: Renderer, rng):
    """One v1 scene (make_quality_suite.py:232-295): 1-3 disjoint cars
    rendered and pasted far to near, each car's padded render box as its
    2D box. Returns (BGR image, camera-frame LIDAR, annotations,
    full-frame NOCS (3, H, W), mask (H, W)) or None."""
    objs = sample_objects(rng, rng.randint(1, 4))
    if not objs:
        return None
    frame = _new_frame(rng)
    lidar_parts, annos = [], []
    for obj in sorted(objs, key=lambda o: -o["trans"][2]):
        r = render_car(rend, obj["latent"], obj["yaw"], obj["scale"],
                       obj["trans"])
        if r is None:
            continue
        crop_box, nocs, mask, vis_cam, _depth, _uv = r
        _paste(frame, crop_box, nocs, mask)
        n_vis = len(vis_cam)
        keep = rng.permutation(n_vis)[: min(n_vis, 3500)]
        lidar_parts.append(vis_cam[keep] + rng.randn(len(keep), 3) * 0.008)
        label, _, _ = labels_mod.get_kitti_label(
            rend.decoder, rend.grid, obj["latent"], np.array([obj["scale"]]),
            obj["trans"] / obj["scale"], np.array([obj["yaw"]]), np.eye(4),
            np.asarray(crop_box), capacity=CAPACITY)
        if label is None:
            continue
        annos.append({
            "bbox": crop_box,
            "location": [float(x) for x in label["location"]],
            "dimensions": [float(x) for x in label["dimensions"]],
            "rotation_y": float(label["rotation_y"]),
            "alpha": float(label["alpha"]),
            "latent": obj["latent"],
        })
    if not annos:
        return None
    ground = np.stack([rng.uniform(-12, 12, 8000),
                       np.full(8000, GROUND_Y) + rng.randn(8000) * 0.01,
                       rng.uniform(4.0, 24.0, 8000)], 1)
    clutter = np.stack([rng.uniform(-12, 12, 2000),
                        rng.uniform(-1.2, GROUND_Y, 2000),
                        rng.uniform(18.0, 26.0, 2000)], 1)
    lidar_cam = np.concatenate(lidar_parts + [ground, clutter])
    return (frame[0], lidar_cam.astype(np.float32), annos, frame[1],
            frame[2])


def _car(rng, z_lo, z_hi, x_frac=0.55):
    shape_idx = rng.randint(len(SHAPES))
    latent, half = SHAPES[shape_idx]
    scale = rng.uniform(1.9, 2.1)
    z = rng.uniform(z_lo, z_hi)
    x = rng.uniform(-x_frac, x_frac) * z
    return {"shape_idx": shape_idx, "latent": latent, "half": half,
            "scale": scale, "yaw": rng.uniform(-np.pi, np.pi),
            "trans": np.array([x, GROUND_Y - half[1] * scale, z])}


def _proj_box(obj):
    """Conservative projected box from the bounding sphere."""
    half, scale = obj["half"], obj["scale"]
    x, _, z = obj["trans"]
    rad = float(np.linalg.norm(half)) * scale
    u0 = FOCAL * x / z + CX
    v0 = FOCAL * (obj["trans"][1]) / z + CY
    du = FOCAL * rad / z
    return (u0 - du, v0 - du, u0 + du, v0 + du)


def _in_image(box, margin=4):
    return (box[0] >= margin and box[2] <= IMG_W - margin
            and box[1] >= margin and box[3] <= IMG_H - margin)


def _disjoint(box, boxes, gap=8):
    return all(box[2] + gap < b[0] or b[2] + gap < box[0]
               or box[3] + gap < b[1] or b[3] + gap < box[1]
               for b in boxes)


def _occluded_pair(rng, z_lo, z_hi):
    """A front car and a rear car whose projected boxes overlap by a drawn
    fraction (make_quality_suite.py:346-372)."""
    for _ in range(60):
        front = _car(rng, z_lo, z_hi, x_frac=0.4)
        fb = _proj_box(front)
        if not _in_image(fb):
            continue
        rear = _car(rng, front["trans"][2] + 2.6, front["trans"][2] + 4.5,
                    x_frac=0.4)
        rb0 = _proj_box(rear)
        f = rng.uniform(0.15, 0.55)
        du_f = (fb[2] - fb[0]) / 2
        du_r = (rb0[2] - rb0[0]) / 2
        sign = 1 if rng.rand() < 0.5 else -1
        uc_front = (fb[0] + fb[2]) / 2
        uc_rear = uc_front + sign * (du_f + du_r) * (1.0 - f)
        z_r = rear["trans"][2]
        rear["trans"][0] = (uc_rear - CX) * z_r / FOCAL
        if not _in_image(_proj_box(rear)):
            continue
        return [front, rear]
    return []


def _truncated_car(rng):
    """A car across the left or right image edge by a drawn fraction
    (make_quality_suite.py:375-394)."""
    for _ in range(60):
        obj = _car(rng, 9.0, 13.0)
        box = _proj_box(obj)
        du = (box[2] - box[0]) / 2
        fo = rng.uniform(0.18, 0.45)  # fraction outside
        side = 1 if rng.rand() < 0.5 else -1
        if side > 0:
            uc = (IMG_W - 1) - du * (1.0 - 2.0 * fo)
        else:
            uc = du * (1.0 - 2.0 * fo)
        z = obj["trans"][2]
        obj["trans"][0] = (uc - CX) * z / FOCAL
        box = _proj_box(obj)
        if box[1] < 4 or box[3] > IMG_H - 4:
            continue
        return obj
    return None


def sample_objects_v2(rng, condition):
    """The condition's placements and LIDAR spec
    (make_quality_suite.py:397-445)."""
    spec = {"keep": 3500, "noise": 0.008, "ground": 8000}
    if condition == "clean":
        return sample_objects(rng, rng.randint(1, 4)), spec
    if condition == "sparse":
        spec = {"keep": 500, "noise": 0.03, "ground": 2500}
        return sample_objects(rng, rng.randint(1, 4)), spec
    if condition == "occluded":
        return _occluded_pair(rng, 8.5, 11.5), spec
    if condition == "truncated":
        objs = []
        tc = _truncated_car(rng)
        if tc is not None:
            objs.append(tc)
        boxes = [_proj_box(o) for o in objs]
        for _ in range(40):
            extra = _car(rng, 10.0, 13.5)
            b = _proj_box(extra)
            if _in_image(b) and _disjoint(b, boxes):
                objs.append(extra)
                break
        return objs, spec
    if condition == "distant":
        objs, boxes = [], []
        n = rng.randint(1, 3)
        for _ in range(80):
            if len(objs) >= n:
                break
            obj = _car(rng, 20.0, 25.0)
            b = _proj_box(obj)
            if _in_image(b) and _disjoint(b, boxes):
                objs.append(obj)
                boxes.append(b)
        return objs, spec
    if condition == "hard_mix":
        spec = {"keep": 900, "noise": 0.02, "ground": 4000}
        objs = _occluded_pair(rng, 10.5, 13.0)
        boxes = [_proj_box(o) for o in objs]
        for _ in range(60):
            obj = _car(rng, 19.0, 24.0)
            b = _proj_box(obj)
            if _in_image(b) and _disjoint(b, boxes):
                objs.append(obj)
                break
        return objs, spec
    raise ValueError(condition)


def build_frame_v2(rend: Renderer, rng, condition):
    """One scene (make_quality_suite.py:448-553): every car rendered and
    pasted far to near over an owner/depth buffer, LIDAR of rear cars
    blocked against the buffer, KITTI truncation and occlusion flags.
    Returns what :func:`build_frame` returns, or None."""
    objs, spec = sample_objects_v2(rng, condition)
    if not objs:
        return None
    rendered = []
    for obj in objs:
        r = render_car(rend, obj["latent"], obj["yaw"], obj["scale"],
                       obj["trans"])
        if r is not None:
            rendered.append((obj, r))
    if not rendered:
        return None

    frame = _new_frame(rng)
    owner = np.full((IMG_H, IMG_W), -1, np.int32)
    zbuf = np.full((IMG_H, IMG_W), np.inf, np.float32)
    n_own = {}
    order = sorted(range(len(rendered)),
                   key=lambda i: -rendered[i][0]["trans"][2])
    for i in order:
        _obj, (crop_box, nocs, mask, _vis, depth, _uv) = rendered[i]
        l, t_, rr, b = crop_box
        _paste(frame, crop_box, nocs, mask)
        owner[t_:b, l:rr][mask] = i
        zbuf[t_:b, l:rr][mask] = depth[mask]
        n_own[i] = int(mask.sum())

    lidar_parts, annos = [], []
    for i, (obj, r) in enumerate(rendered):
        crop_box, nocs, mask, vis_cam, depth, full_uv = r
        hidden = 1.0 - float((owner == i).sum()) / max(n_own[i], 1)
        occl = (0 if hidden <= 0.05 else 1 if hidden <= 0.45 else
                2 if hidden <= 0.80 else 3)
        u0, v0, u1, v1 = full_uv
        full_area = max((u1 - u0) * (v1 - v0), 1e-6)
        vis_w = max(min(u1, IMG_W - 1.0) - max(u0, 0.0), 0.0)
        vis_h = max(min(v1, IMG_H - 1.0) - max(v0, 0.0), 0.0)
        trunc = float(np.clip(1.0 - vis_w * vis_h / full_area, 0.0, 1.0))
        # the tight projected box, clamped to the image
        tight_box = (int(max(u0, 0)), int(max(v0, 0)),
                     int(min(u1, IMG_W - 1)), int(min(v1, IMG_H - 1)))
        # LIDAR: the visible surface less rays a nearer car blocks
        u = vis_cam[:, 0] / vis_cam[:, 2] * FOCAL + CX
        v = vis_cam[:, 1] / vis_cam[:, 2] * FOCAL + CY
        ui = np.clip(np.round(u).astype(np.int64), 0, IMG_W - 1)
        vi = np.clip(np.round(v).astype(np.int64), 0, IMG_H - 1)
        in_img = (u >= 0) & (u < IMG_W) & (v >= 0) & (v < IMG_H)
        unblocked = zbuf[vi, ui] > vis_cam[:, 2] - 0.5
        pts = vis_cam[~in_img | unblocked]
        if len(pts):
            keep = rng.permutation(len(pts))[: min(len(pts), spec["keep"])]
            lidar_parts.append(
                pts[keep] + rng.randn(len(keep), 3) * spec["noise"])
        label, _, _ = labels_mod.get_kitti_label(
            rend.decoder, rend.grid, obj["latent"], np.array([obj["scale"]]),
            obj["trans"] / obj["scale"], np.array([obj["yaw"]]), np.eye(4),
            np.asarray(tight_box), capacity=CAPACITY)
        if label is None:
            continue
        annos.append({
            "bbox": tight_box,
            "location": [float(x) for x in label["location"]],
            "dimensions": [float(x) for x in label["dimensions"]],
            "rotation_y": float(label["rotation_y"]),
            "alpha": float(label["alpha"]),
            "latent": obj["latent"],
            "truncated": round(trunc, 3),
            "occluded": occl,
        })
    if not annos or not lidar_parts:
        return None

    ng = spec["ground"]
    ground = np.stack([rng.uniform(-12, 12, ng),
                       np.full(ng, GROUND_Y) + rng.randn(ng) * 0.01,
                       rng.uniform(4.0, 27.0, ng)], 1)
    nc = max(ng // 4, 500)
    clutter = np.stack([rng.uniform(-12, 12, nc),
                        rng.uniform(-1.2, GROUND_Y, nc),
                        rng.uniform(18.0, 28.0, nc)], 1)
    lidar_cam = np.concatenate(lidar_parts + [ground, clutter])
    return (frame[0], lidar_cam.astype(np.float32), annos, frame[1],
            frame[2])


def write_kitti_frame(root, name, image, lidar_cam, annos):
    """One frame in the KITTI layout (make_quality_suite.py:556-600)."""
    training = os.path.join(root, "training")
    kitti_mod.write_bgr(os.path.join(training, "image_2", f"{name}.png"),
                        (np.clip(image, 0, 1) * 255).astype(np.uint8))
    r_inv = np.linalg.inv(VELO_TO_CAM[:3, :3])
    velo = np.zeros((len(lidar_cam), 4), np.float32)
    velo[:, :3] = (r_inv @ (lidar_cam - VELO_TO_CAM[:3, 3]).T).T
    velo[:, 3] = 0.5
    velo.tofile(os.path.join(training, "velodyne", f"{name}.bin"))

    p2 = np.zeros((3, 4))
    p2[:3, :3] = [[FOCAL, 0, CX], [0, FOCAL, CY], [0, 0, 1]]
    calib_lines = [
        "P0: " + " ".join(["0"] * 12),
        "P1: " + " ".join(["0"] * 12),
        "P2: " + " ".join(f"{v:.12e}" for v in p2.reshape(-1)),
        "P3: " + " ".join(["0"] * 12),
        "R0_rect: " + " ".join(f"{v:.12e}" for v in np.eye(3).reshape(-1)),
        "Tr_velo_to_cam: " + " ".join(
            f"{v:.12e}" for v in VELO_TO_CAM.reshape(-1)),
        "Tr_imu_to_velo: " + " ".join(["0"] * 12),
    ]
    with open(os.path.join(training, "calib", f"{name}.txt"), "w") as f:
        f.write("\n".join(calib_lines) + "\n")
    rows = []
    for a in annos:
        l, t_, r, b = a["bbox"]
        h, w, ln = a["dimensions"]
        x, y, z = a["location"]
        rows.append(
            f"Car {a.get('truncated', 0.0):.2f} {a.get('occluded', 0)} "
            f"{a['alpha']:.4f} {l:.2f} {t_:.2f} {r:.2f} {b:.2f} "
            f"{h:.4f} {w:.4f} {ln:.4f} {x:.4f} {y:.4f} {z:.4f} "
            f"{a['rotation_y']:.4f}")
    with open(os.path.join(training, "label_2", f"{name}.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")


def difficulty_counts(frame_annos):
    """GT tier composition as the loader's predicates see it."""
    counts = {"easy": 0, "moderate_extra": 0, "hard_extra": 0, "beyond": 0}
    for annos in frame_annos:
        for a in annos:
            aa = dict(a)
            aa.setdefault("truncated", 0.0)
            aa.setdefault("occluded", 0)
            if kitti_mod.is_anno_easy(aa):
                counts["easy"] += 1
            elif kitti_mod.is_anno_moderate(aa):
                counts["moderate_extra"] += 1
            elif kitti_mod.is_anno_hard(aa):
                counts["hard_extra"] += 1
            else:
                counts["beyond"] += 1
    return counts


def _frame_loop(profile: str, rend: Renderer, rng):
    """The frames of `profile` in order, each (name, condition, what
    build_frame returns), skipping the draws that give no frame
    (make_quality_suite.py:760-778); raises after MAX_MISSES such draws
    in a row (a decoder without a usable surface), where JAX's loop would
    never end."""
    n = misses = 0
    while misses < MAX_MISSES:
        if profile == "v2":
            condition = CONDITIONS[n % len(CONDITIONS)]
            built = build_frame_v2(rend, rng, condition)
        else:
            condition = "clean"
            built = build_frame(rend, rng)
        misses = 0 if built is not None else misses + 1
        if built is not None:
            yield f"{n:06d}", condition, built
            n += 1
    raise RuntimeError(f"no frame in {MAX_MISSES} draws in a row: the "
                       "decoder's surface gives no car")


def build_frames(out: str, n_frames: int, rend: Renderer,
                 profile: str = "v1"):
    """Write the first `n_frames` frames of `profile` and the split under
    `out`. Returns (frames_meta: (name, annotations, full-frame NOCS,
    mask) a frame, conditions by name)."""
    training = os.path.join(out, "training")
    for sub in ("image_2", "label_2", "calib", "velodyne"):
        os.makedirs(os.path.join(training, sub), exist_ok=True)
    os.makedirs(os.path.join(out, "mv3d_kitti_split"), exist_ok=True)
    rng = np.random.RandomState(SEED + 2)
    frames_meta, conditions = [], {}
    frames = _frame_loop(profile, rend, rng)
    while len(frames_meta) < n_frames:
        name, condition, (image, lidar_cam, annos, nocs, mask) = next(frames)
        write_kitti_frame(out, name, image, lidar_cam, annos)
        frames_meta.append((name, annos, nocs, mask))
        conditions[name] = condition
    with open(os.path.join(out, "mv3d_kitti_split", "trainval.txt"),
              "w") as f:
        f.write("\n".join(m[0] for m in frames_meta) + "\n")
    return frames_meta, conditions


def write_meta(out: str, profile: str, frames_meta, conditions,
               css_width: int | None = None, weak_css: str | None = None
               ) -> dict:
    """suite_meta.json as JAX writes it (make_quality_suite.py:804-814)."""
    meta = {"profile": profile, "frames": len(frames_meta),
            "objects": sum(len(m[1]) for m in frames_meta), "seed": SEED,
            "img_hw": [IMG_H, IMG_W],
            "css_width": css_width or PROFILES[profile]["css_width"],
            "difficulty_tiers": difficulty_counts(m[1] for m in frames_meta),
            "conditions": conditions, "weak_css": weak_css,
            "shapes": [{"latent": s[0].tolist(), "half": s[1].tolist()}
                       for s in SHAPES]}
    with open(os.path.join(out, "suite_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def build_suite(out: str, n_frames: int | None = None, profile: str = "v1",
                device="cuda", nets: str = NETS) -> dict:
    """Write the first `n_frames` frames of `profile` (its default count
    when None) under `out` from the decoder in `nets`; returns the
    suite's meta (also written to suite_meta.json)."""
    device = refine_mod._device(device)
    dcfg, dparams = deepsdf.load_torch_checkpoint(
        os.path.join(nets, "deepsdf_quality.pt"), device=device)
    rend = Renderer(deepsdf.sdf_fn(dcfg, dparams), device)
    frames_meta, conditions = build_frames(
        out, n_frames or PROFILES[profile]["frames"], rend, profile)
    return write_meta(out, profile, frames_meta, conditions)


# ------------------------------------------------------ the CSS training

def jitter_box(rng, bbox, jitter: int, img_hw: tuple[int, int]):
    """The box (l, t, r, b) with each side moved by a draw in
    [-jitter, jitter] from `rng` (left, top, right, bottom in turn) and
    clamped to the (h, w) image, at least 2 px wide and high
    (make_quality_suite.py:620-623, make_demo_assets.py:245-248)."""
    img_h, img_w = img_hw
    l, t_, r, b = bbox
    jl = np.clip(l + rng.randint(-jitter, jitter + 1), 0, img_w - 2)
    jt = np.clip(t_ + rng.randint(-jitter, jitter + 1), 0, img_h - 2)
    jr = np.clip(r + rng.randint(-jitter, jitter + 1), jl + 2, img_w - 1)
    jb = np.clip(b + rng.randint(-jitter, jitter + 1), jt + 2, img_h - 1)
    return jl, jt, jr, jb


def crop_targets(full_nocs, full_mask, box):
    """The CSS targets of the window `box` (l, t, r, b) of a full-frame
    NOCS (3, H, W) and mask (H, W): each sampled floor-nearest at
    128 x 128, the NOCS as int32 bins round(255 x) (0 off the mask), the
    mask as int32."""
    jl, jt, jr, jb = box
    ch, cw = jb - jt, jr - jl
    ys = (np.arange(128) * ch // 128).clip(max=ch - 1)
    xs = (np.arange(128) * cw // 128).clip(max=cw - 1)
    nocs128 = full_nocs[:, jt + ys[:, None], jl + xs[None, :]]
    mask128 = full_mask[jt + ys[:, None], jl + xs[None, :]]
    bins = np.clip(np.round(nocs128 * 255), 0, 255).astype(np.int32)
    bins = bins * mask128[None].astype(np.int32)  # background -> bin 0
    return bins, mask128.astype(np.int32)


def crop_sampler(frames_meta, tree: str, jitter: int = 3, device="cpu"):
    """sample() -> (normalized crop (3, 128, 128) on `device`, NOCS bins
    (3, 128, 128) int32, mask (128, 128) int32, latent (3,)): one jittered
    annotation crop of a written frame, read back as the driver reads it
    (BGR / 255) and resized by the driver's transform, its targets by
    :func:`crop_targets`; the draws from np.random.RandomState(SEED + 3)
    in JAX's order (make_quality_suite.py:609-637)."""
    cache = {}
    for name, _annos, _nocs, _mask in frames_meta:
        img = kitti_mod.read_bgr(
            os.path.join(tree, "training", "image_2", f"{name}.png"))
        cache[name] = img.astype(np.float32) / 255.0
    rng = np.random.RandomState(SEED + 3)
    flat = [(name, a, nocs, mask)
            for name, annos, nocs, mask in frames_meta for a in annos]

    def sample():
        name, anno, full_nocs, full_mask = flat[rng.randint(len(flat))]
        jl, jt, jr, jb = jitter_box(rng, anno["bbox"], jitter,
                                    (IMG_H, IMG_W))
        crop, _ = refine_pipe.transform_bgr_crop(cache[name][jt:jb, jl:jr],
                                                 device=device)
        bins, mask = crop_targets(full_nocs, full_mask, (jl, jt, jr, jb))
        return crop, bins, mask, anno["latent"]

    return sample


def suite_css_loss(pred: dict, bins: torch.Tensor, mask: torch.Tensor,
                   latent: torch.Tensor) -> torch.Tensor:
    """The suite training's loss (make_quality_suite.py:652-661), not
    engine/css_train.py's: one NLL of each NOCS head's log-softmax over all
    B x 128 x 128 pixels against its bins times the mask (the logits are
    not masked), the mask head's NLL with weight 1, and 10 x the latent's
    MSE. Each NLL is the mean cross-entropy of the head's raw logits,
    kernel 5 on the card."""
    ce = ce_cuda.fused_cross_entropy
    nll = ce(pred["u_raw"], bins[:, 0])
    nll = nll + ce(pred["v_raw"], bins[:, 1])
    nll = nll + ce(pred["w_raw"], bins[:, 2])
    nll = nll + ce(pred["mask"], mask)
    return nll + 10.0 * torch.mean(torch.square(pred["latent"] - latent))


def css_step(model: css_mod.CSSNet, opt: css_train.Adam, batch
             ) -> torch.Tensor:
    """One Adam step of the suite's training on a batch (the stacked
    crops, bins, masks and latents of :func:`crop_sampler`, on the
    model's device); returns the loss (0-dim, not read back)."""
    pred = model(batch[0], decode=False)
    loss = suite_css_loss(pred, *batch[1:])
    opt.zero_grad()
    loss.backward()
    opt.step()
    return loss.detach()


def stack_batch(samples, device) -> tuple:
    """:func:`crop_sampler`'s samples as one batch on `device`."""
    xs, tbs, tms, tls = zip(*samples)
    return (torch.stack(xs).to(device),
            torch.as_tensor(np.stack(tbs), device=device),
            torch.as_tensor(np.stack(tms), device=device),
            torch.as_tensor(np.stack(tls), dtype=torch.float32,
                            device=device))


def train_css(sample, width: int, steps: int, batch: int,
              init: dict | None = None, seed: int = SEED, device="cuda",
              log_every: int = 250, what: str = "css train"):
    """Train a CSSNet of `width` on `steps` batches of `batch` draws of
    `sample()` (crop, bins, mask, latent, as :func:`crop_sampler` gives
    them): every parameter (nothing frozen), BatchNorm on the batch
    statistics, Adam at 1e-3 in optax's order, :func:`suite_css_loss`.
    `init` (flax variables {'params', 'batch_stats'}) is the start; None
    draws one from a generator seeded with `seed`. Returns the trained net
    (in train mode) and the loss of every step as a (steps,) tensor."""
    device = refine_mod._device(device)
    _no_tf32()
    if init is None:
        model = css_mod.init_params(css_mod.CSSNet(width=width),
                                    torch.Generator().manual_seed(seed))
    else:
        model = css_mod.params_from_jax(init, width)
    model = model.to(device).train()
    opt = css_train.Adam(model.named_parameters(), LR)
    losses = []
    for i in range(steps):
        losses.append(css_step(model, opt, stack_batch(
            [sample() for _ in range(batch)], device)))
        if i % log_every == 0:
            print(f"  {what} step {i}: loss {float(losses[-1]):.4f}",
                  flush=True)
    losses = torch.stack(losses) if losses else torch.zeros(0)
    if steps:
        print(f"  {what} final: loss {float(losses[-1]):.4f}", flush=True)
    return model, losses


def train_suite_css(frames_meta, tree: str, width: int = 16,
                    steps: int = 4000, batch: int = 8, jitter: int = 3,
                    init: dict | None = None, device="cuda",
                    log_every: int = 250):
    """Train the suite's CSSNet (make_quality_suite.py:602-678):
    :func:`train_css` on :func:`crop_sampler`'s crops of the written
    frames, seeded with SEED."""
    device = refine_mod._device(device)
    return train_css(crop_sampler(frames_meta, tree, jitter, device), width,
                     steps, batch, init, SEED, device, log_every)


def save_css(path: str, model: css_mod.CSSNet) -> None:
    """The net as flax msgpack, where the JAX package's
    pipelines/train_css.py::load_checkpoint and the driver read it."""
    flax_msgpack.save(path, css_mod.state_to_flax(model))


# ---------------------------------------------------------------- the CLI

def refuse_committed(path: str, committed, flag: str, what: str) -> str:
    """`path`, refused where it resolves to or into one of the `committed`
    directories (each resolved from the working directory where
    relative)."""
    real = os.path.realpath(path)
    for c in sorted({os.path.realpath(d) for d in committed}):
        if real == c or real.startswith(c + os.sep):
            raise ValueError(f"{flag} {path}: the committed {what} in {c} "
                             "are never written; choose another directory")
    return path


def check_nets_out(path: str) -> str:
    """`path`, refused where it resolves into the committed nets."""
    return refuse_committed(path, (NETS, os.path.join("data",
                                                      "quality_nets")),
                            "--nets-out", "nets")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", choices=("v1", "v2"), default="v1",
                    help="v1: 1-3 disjoint cars a frame; v2: the six "
                         "conditions (occlusion, truncation, distance, "
                         "sparse LIDAR), difficulties 0-2")
    ap.add_argument("--frames", type=int, default=0,
                    help="0 = the profile's default (v1: 60, v2: 72)")
    ap.add_argument("--css-steps", type=int, default=0,
                    help="0 = the profile's default (v1: 4000, v2: 6000)")
    ap.add_argument("--fit-steps", type=int, default=FIT_STEPS)
    ap.add_argument("--css-width", type=int, default=0,
                    help="0 = the profile's default (v1: 16, v2: 24)")
    ap.add_argument("--weak-steps", type=int, default=0,
                    help="also train an undertrained weak CSS net with "
                         "this many steps (suggested 800)")
    ap.add_argument("--skip-fit", action="store_true",
                    help="build the frames from the committed "
                         "deepsdf_quality.pt")
    ap.add_argument("--skip-css", action="store_true",
                    help="train no CSS net (the committed ones label)")
    ap.add_argument("--out", default=None,
                    help="the suite's directory (v1: data/quality_suite, "
                         "v2: data/quality_suite_v2)")
    ap.add_argument("--nets-out", default=NETS_OUT,
                    help="where fitted and trained nets are written; "
                         "never data/quality_nets")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    prof = PROFILES[args.profile]
    out = args.out or prof["out"]
    nets_out = check_nets_out(args.nets_out)
    n_frames = args.frames or prof["frames"]
    css_steps = args.css_steps or prof["css_steps"]
    css_width = args.css_width or prof["css_width"]
    device = refine_mod._device(args.device)
    seconds = {}

    t0 = time.perf_counter()
    if args.skip_fit:
        print("loading the committed DeepSDF ...", flush=True)
        dcfg, dparams = deepsdf.load_torch_checkpoint(
            os.path.join(NETS, "deepsdf_quality.pt"), device=device)
    else:
        print("fitting the 4-shape DeepSDF ...", flush=True)
        dcfg, dparams, _ = fit_deepsdf(args.fit_steps, device=device)
        os.makedirs(nets_out, exist_ok=True)
        deepsdf.save_torch_checkpoint(
            os.path.join(nets_out, "deepsdf_quality.pt"), dcfg, dparams)
    seconds["fit"] = time.perf_counter() - t0

    print(f"generating {n_frames} frames ({args.profile}) ...", flush=True)
    t0 = time.perf_counter()
    rend = Renderer(deepsdf.sdf_fn(dcfg, dparams), device)
    frames_meta, conditions = build_frames(out, n_frames, rend,
                                           args.profile)
    seconds["frames"] = time.perf_counter() - t0
    n_obj = sum(len(m[1]) for m in frames_meta)
    print(f"suite: {len(frames_meta)} frames, {n_obj} objects, difficulty "
          f"tiers {difficulty_counts(m[1] for m in frames_meta)}",
          flush=True)

    suffix = prof["suffix"]
    nets = [(f"css_quality{suffix}.msgpack", css_steps, "css")]
    if args.skip_css:
        nets = []
    if args.weak_steps:
        nets.append((f"css_quality{suffix}_weak.msgpack", args.weak_steps,
                     "css_weak"))
    for fname, steps, key in nets:
        print(f"training the suite CSSNet ({fname}, {steps} steps) ...",
              flush=True)
        t0 = time.perf_counter()
        model, _ = train_suite_css(frames_meta, out, width=css_width,
                                   steps=steps, device=device)
        os.makedirs(nets_out, exist_ok=True)
        save_css(os.path.join(nets_out, fname), model)
        seconds[key] = time.perf_counter() - t0
    meta = write_meta(out, args.profile, frames_meta, conditions,
                      css_width, f"css_quality{suffix}_weak.msgpack"
                      if args.weak_steps else None)
    print(f"suite: {meta['frames']} frames, {meta['objects']} objects, "
          f"written to {out}, nets to {nets_out}; seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}",
          flush=True)
    return meta, seconds


if __name__ == "__main__":
    main()
