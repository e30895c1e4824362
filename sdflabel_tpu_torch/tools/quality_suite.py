"""Build the v2 autolabel-quality suite: synthetic KITTI-format frames.

The frame builder of scripts/make_quality_suite.py (profile v2), without
its DeepSDF fit and CSS training: the frames come from the committed
``data/quality_nets/deepsdf_quality.pt`` and the same seeded draws
(``np.random.RandomState(SEED + 2)``, in the same order), so the suite is
the one the JAX package generates, and the committed
``css_quality_v2.msgpack`` (width 24) labels it. Six conditions in turn:
clean, occluded, truncated, distant, sparse LIDAR and a hard mix, with
KITTI truncation and occlusion flags, so difficulties 0-2 are all
populated. Each car's appearance is its NOCS render on a 320 x 320 canvas
(the row-binned splat kernel on the card); its ground-truth label is
engine/labels.py::get_kitti_label, the code the driver's labels come from.

Writes ``training/{image_2,velodyne,calib,label_2}``, the
``mv3d_kitti_split/trainval.txt`` split and ``suite_meta.json``, which
data/kitti.py::KITTI3D reads:

    python -m sdflabel_tpu_torch.tools.quality_suite --frames 72 \\
        --out data/quality_suite_v2
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from sdflabel_tpu_torch.data import kitti as kitti_mod
from sdflabel_tpu_torch.engine import labels as labels_mod
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import grid as grid_ops
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.renderer import rasterer

SEED = 11
NETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "quality_nets")
CSS_WIDTH = 24  # the suite's CSS network, css_quality_v2.msgpack

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


class Renderer:
    """The decoder's surface on the grid-40 lattice and its NOCS render on
    the canvas, on `device`."""

    def __init__(self, decoder, device):
        self.decoder = decoder
        self.device = torch.device(device)
        self.grid = grid_ops.generate_point_grid(40, device=self.device)

    def surface(self, latent):
        with torch.no_grad():
            surf, _ = grid_ops.surface_from_decoder(
                self.decoder, torch.as_tensor(latent, dtype=torch.float32,
                                              device=self.device),
                self.grid, capacity=CAPACITY)
        return surf

    def render(self, K, surf, pose):
        with torch.no_grad():
            return rasterer.render(
                K, (CANVAS, CANVAS), surf.points, surf.normals, surf.normals,
                pose, point_mask=surf.mask, rot="dcm", primitives="disc",
                output_nocs=True, bin_px=splat_cuda.BIN_AUTO_PX)


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
    Returns (BGR image, camera-frame LIDAR, annotations) or None."""
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

    image = rng.uniform(0.25, 0.45, (IMG_H, IMG_W, 3)).astype(np.float32)
    owner = np.full((IMG_H, IMG_W), -1, np.int32)
    zbuf = np.full((IMG_H, IMG_W), np.inf, np.float32)
    n_own = {}
    order = sorted(range(len(rendered)),
                   key=lambda i: -rendered[i][0]["trans"][2])
    for i in order:
        _obj, (crop_box, nocs, mask, _vis, depth, _uv) = rendered[i]
        l, t_, rr, b = crop_box
        rgb = np.transpose(nocs, (1, 2, 0))
        image[t_:b, l:rr][mask] = rgb[..., ::-1][mask]  # stored BGR
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
    return image, lidar_cam.astype(np.float32), annos


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


def build_suite(out: str, n_frames: int = 72, device="cuda",
                nets: str = NETS) -> dict:
    """Write the first `n_frames` frames of the v2 suite under `out`;
    returns the suite's meta (also written to suite_meta.json)."""
    device = refine_mod._device(device)
    training = os.path.join(out, "training")
    for sub in ("image_2", "label_2", "calib", "velodyne"):
        os.makedirs(os.path.join(training, sub), exist_ok=True)
    os.makedirs(os.path.join(out, "mv3d_kitti_split"), exist_ok=True)
    dcfg, dparams = deepsdf.load_torch_checkpoint(
        os.path.join(nets, "deepsdf_quality.pt"), device=device)
    rend = Renderer(deepsdf.sdf_fn(dcfg, dparams), device)
    rng = np.random.RandomState(SEED + 2)
    names, frame_annos, conditions = [], [], {}
    while len(names) < n_frames:
        condition = CONDITIONS[len(names) % len(CONDITIONS)]
        built = build_frame_v2(rend, rng, condition)
        if built is None:
            continue
        image, lidar_cam, annos = built
        name = f"{len(names):06d}"
        write_kitti_frame(out, name, image, lidar_cam, annos)
        frame_annos.append(annos)
        conditions[name] = condition
        names.append(name)
    with open(os.path.join(out, "mv3d_kitti_split", "trainval.txt"),
              "w") as f:
        f.write("\n".join(names) + "\n")
    meta = {"profile": "v2", "frames": len(names),
            "objects": sum(len(a) for a in frame_annos), "seed": SEED,
            "img_hw": [IMG_H, IMG_W], "css_width": CSS_WIDTH,
            "difficulty_tiers": difficulty_counts(frame_annos),
            "conditions": conditions, "weak_css": None,
            "shapes": [{"latent": s[0].tolist(), "half": s[1].tolist()}
                       for s in SHAPES]}
    with open(os.path.join(out, "suite_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=72)
    ap.add_argument("--out", default="data/quality_suite_v2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    meta = build_suite(args.out, args.frames, args.device)
    print(f"suite: {meta['frames']} frames, {meta['objects']} objects, "
          f"difficulty tiers {meta['difficulty_tiers']}, written to "
          f"{args.out}")


if __name__ == "__main__":
    main()
