"""Headless visualization: images as numpy arrays, written as PNG.

Counterpart of sdflabel_tpu/utils/viz.py (reference utils/visualizer.py:
NOCS patch comparison :9-19, full-frame normals overlay :22-48, 3D
correspondence view :51-88, final label-vs-GT cuboid view :91-120). Every
function returns its (H, W, 3) float image in [0, 1] and, given `path`,
writes it through the port's own PNG writer (utils/png.py) in place of
PIL. 3D views are bird's-eye schematics drawn with numpy.
"""

from __future__ import annotations

import numpy as np

from sdflabel_tpu_torch.ops import geometry
from sdflabel_tpu_torch.utils import png


def build_heatmap(values: np.ndarray, lo=None, hi=None) -> np.ndarray:
    """RGB heat colormap (refinement.py:413-421 without cv2 dependency)."""
    v = np.asarray(values, np.float64)
    lo = v.min() if lo is None else lo
    hi = v.max() if hi is None else hi
    t = np.clip((v - lo) / max(hi - lo, 1e-12), 0, 1)
    # simple jet-like ramp
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def plot_patches(rendering_nocs, css_nocs, path: str | None = None):
    """Side-by-side rendered-vs-CSS NOCS patches (visualizer.py:9-19)."""
    a = np.transpose(np.asarray(rendering_nocs), (1, 2, 0))
    b = np.transpose(np.asarray(css_nocs), (1, 2, 0))
    h = max(a.shape[0], b.shape[0])

    def pad(x):
        return np.pad(x, ((0, h - x.shape[0]), (0, 0), (0, 0)))

    img = np.concatenate([pad(a), pad(b)], axis=1)
    img = np.clip(img, 0, 1)
    if path:
        _save(img, path)
    return img


def plot_full_frame(frame_image, rendering_normals, bbox, path: str | None = None):
    """Overlay the rendered normals into the frame crop (visualizer.py:22-48)."""
    img = np.asarray(frame_image, np.float32).copy()
    if img.ndim == 3 and img.shape[0] == 3:
        img = np.transpose(img, (1, 2, 0))
    l, t, r, b = [int(v) for v in bbox]
    normals = np.transpose(np.asarray(rendering_normals), (1, 2, 0))
    ch, cw = b - t, r - l
    ny, nx = normals.shape[:2]
    ys = (np.arange(ch) * ny // max(ch, 1)).clip(max=ny - 1)
    xs = (np.arange(cw) * nx // max(cw, 1)).clip(max=nx - 1)
    resized = normals[ys[:, None], xs[None, :]]
    mask = resized.sum(-1) > 0
    region = img[t:b, l:r]
    region[mask] = resized[mask]
    img[t:b, l:r] = region
    if path:
        _save(img, path)
    return img


def plot_bev(
    lidar_points,
    label=None,
    gt_anno=None,
    extent: float = 40.0,
    resolution: int = 512,
    path: str | None = None,
):
    """BEV schematic: LIDAR points + predicted/GT cuboids.

    Camera-frame convention (x right, z forward). Replaces the Open3D
    interactive views (visualizer.py:51-120) for headless debugging.
    """
    img = np.zeros((resolution, resolution, 3), np.float32)

    def to_px(xz):
        x = (xz[:, 0] / extent / 2 + 0.5) * (resolution - 1)
        z = (1.0 - xz[:, 1] / extent) * (resolution - 1)
        return np.clip(np.stack([z, x], 1).astype(int), 0, resolution - 1)

    pts = np.asarray(lidar_points)
    if len(pts):
        px = to_px(pts[:, [0, 2]])
        img[px[:, 0], px[:, 1]] = (0.4, 0.4, 0.4)

    def draw_box(anno, color):
        h, w, l = anno["dimensions"]
        corners = geometry.transform_kitti_to_cuboid(
            w, h, l, anno["location"], anno["rotation_y"]
        )
        # BEV footprint: corners 0-3 are the FRONT face (all share z=+l/2
        # pre-rotation, collapsing to one edge in (x, z)); the footprint
        # rectangle is front pair + back pair in loop order 0-1-5-4
        px = to_px(corners[[0, 1, 5, 4]][:, [0, 2]])
        for i in range(4):
            a, b = px[i], px[(i + 1) % 4]
            n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
            rr = np.linspace(a[0], b[0], n).astype(int)
            cc = np.linspace(a[1], b[1], n).astype(int)
            img[rr, cc] = color

    if gt_anno is not None:
        draw_box(gt_anno, (0.0, 1.0, 0.0))
    if label is not None:
        draw_box(label, (1.0, 0.3, 0.3))
    if path:
        _save(img, path)
    return img


def plot_correspondences_bev(
    pts_a,
    pts_b,
    idxs,
    dists=None,
    mask_a=None,
    mask_b=None,
    resolution: int = 512,
    margin: float = 0.1,
    path: str | None = None,
):
    """BEV correspondence view — headless analogue of visualizer.py:51-88.

    Draws both point clouds in bird's-eye view (camera frame: x right,
    z forward) and a line from pts_a[i] to pts_b[idxs[i]] for every valid
    correspondence, heat-colored by `dists` (red = far, blue = near),
    mirroring the reference's build_heatmap + build_correspondence_lineset
    (refinement.py:280-300, visualizer.py:69-72). pts_a is typically the
    transformed model cloud, pts_b the scene frustum cloud.
    """
    pts_a = np.asarray(pts_a, np.float64)
    pts_b = np.asarray(pts_b, np.float64)
    idxs = np.asarray(idxs, np.int64).reshape(-1)
    mask_a = (np.ones(len(pts_a), bool) if mask_a is None
              else np.asarray(mask_a, bool))
    mask_b = (np.ones(len(pts_b), bool) if mask_b is None
              else np.asarray(mask_b, bool))
    if dists is None:
        dists = np.linalg.norm(
            pts_a - pts_b[np.clip(idxs, 0, max(len(pts_b) - 1, 0))], axis=-1
        )
    dists = np.asarray(dists, np.float64).reshape(-1)

    img = np.zeros((resolution, resolution, 3), np.float32)
    both = np.concatenate([pts_a[mask_a], pts_b[mask_b]], 0)
    if len(both) == 0:
        if path:
            _save(img, path)
        return img
    lo = both[:, [0, 2]].min(0)
    hi = both[:, [0, 2]].max(0)
    span = np.maximum(hi - lo, 1e-6)
    lo = lo - margin * span
    span = span * (1 + 2 * margin)

    def to_px(xz):
        t = (np.asarray(xz)[:, :2] - lo) / span
        col = t[:, 0] * (resolution - 1)
        row = (1.0 - t[:, 1]) * (resolution - 1)
        return np.clip(np.stack([row, col], 1).astype(int), 0, resolution - 1)

    pa = to_px(pts_a[:, [0, 2]])
    pb = to_px(pts_b[:, [0, 2]])

    # correspondence lines first so the points draw on top
    heat = build_heatmap(dists, lo=0.0)
    valid = mask_a & (idxs >= 0) & (idxs < len(pts_b))
    valid &= mask_b[np.clip(idxs, 0, len(pts_b) - 1)]
    for i in np.nonzero(valid)[0]:
        a, b = pa[i], pb[idxs[i]]
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        rr = np.linspace(a[0], b[0], n).astype(int)
        cc = np.linspace(a[1], b[1], n).astype(int)
        img[rr, cc] = heat[i]

    img[pb[mask_b, 0], pb[mask_b, 1]] = (0.45, 0.45, 0.45)  # scene
    img[pa[mask_a, 0], pa[mask_a, 1]] = (1.0, 0.35, 0.2)  # model
    if path:
        _save(img, path)
    return img


def plot_loss_curves(history: dict, path: str | None = None,
                     height: int = 128) -> np.ndarray:
    """Render refinement loss histories as a simple sparkline strip.

    Returns an empty image for a history without any known key (total,
    like plot_correspondences_bev on empty inputs)."""
    keys = [k for k in ("loss", "loss_2d", "loss_3d") if k in history]
    if not keys:
        img = np.ones((height, 2, 3), np.float32)
        if path:
            _save(img, path)
        return img
    w = max(len(np.asarray(history[k]).reshape(-1)) for k in keys)
    img = np.ones((height * len(keys), max(w, 2), 3), np.float32)
    colors = [(0.8, 0.2, 0.2), (0.2, 0.5, 0.9), (0.2, 0.7, 0.3)]
    for row, (k, c) in enumerate(zip(keys, colors)):
        v = np.asarray(history[k], np.float64).reshape(-1)
        v = np.where(np.isfinite(v), v, np.nan)
        lo = np.nanmin(v)
        hi = np.nanmax(v)
        t = (v - lo) / max(hi - lo, 1e-12)
        ys = ((1 - t) * (height - 1)).astype(int) + row * height
        xs = np.arange(len(v))
        ok = np.isfinite(v)
        img[ys[ok], xs[ok]] = c
    if path:
        _save(img, path)
    return img


def _save(img: np.ndarray, path: str) -> None:
    png.write(path, (np.clip(img, 0, 1) * 255).astype(np.uint8))
