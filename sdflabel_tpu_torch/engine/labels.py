"""KITTI label generation from refined parameters.

Counterpart of sdflabel_tpu/engine/labels.py (reference
utils/refinement.py:501-562): the surface band is decoded again at the
final latent on the device and reduced to its model-frame bounds
(``surface_extents``); the label math stays host-side float64
(``kitti_label_from_extents``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdflabel_tpu_torch.ops import geometry, grid as grid_ops


class SurfaceExtents(NamedTuple):
    """Masked min/max of the unscaled surface band (model frame), after
    the crop axis if any."""

    mn: torch.Tensor  # (3,) +inf where the band is empty
    mx: torch.Tensor  # (3,) -inf where the band is empty
    valid: torch.Tensor  # () bool: some |sdf| < threshold point exists


def surface_extents(sdf_decoder, grid_points, latent, capacity: int = 4096,
                    threshold: float = 0.03) -> SurfaceExtents:
    """Surface-band bounding box at the raw (unnormalized) `latent`
    (refinement.py:516-529); (B, L) latents give one box per crop."""
    if latent.dim() != 2:
        latent = latent.reshape(-1)
    with torch.no_grad():
        surf, _ = grid_ops.surface_from_decoder(
            sdf_decoder, latent, grid_points, capacity=capacity,
            threshold=threshold)
    pts = surf.points.detach()
    mask = surf.mask[..., None]
    big = torch.full_like(pts, float("inf"))
    mn = torch.where(mask, pts, big).min(-2).values
    mx = torch.where(mask, pts, -big).max(-2).values
    return SurfaceExtents(mn=mn, mx=mx, valid=surf.mask.any(-1))


def kitti_label_from_extents(yaw, scale, trans, mn, mx, p_wc: np.ndarray,
                             bbox) -> dict:
    """Host float64 label math (refinement.py:530-562) from the unscaled
    extents; `trans` is the scale-normalized translation."""
    yaw_f = float(np.asarray(yaw).reshape(-1)[0])
    scale_f = float(np.asarray(scale).reshape(-1)[0])
    trans_np = np.asarray(trans, np.float64).reshape(3)

    cam_t = np.eye(4)
    cam_t[:3, :3] = geometry.rot_from_yaw_np(yaw_f) @ np.diag([1.0, -1.0, 1.0])
    cam_t[:3, 3] = trans_np * scale_f
    global_t = np.linalg.inv(np.asarray(p_wc)) @ cam_t

    a = np.asarray(mn, np.float64) * scale_f
    b = np.asarray(mx, np.float64) * scale_f
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    width, height, length = hi - lo
    bottom_center = np.asarray([0.0, lo[1], 0.0])

    label = {"name": "Car", "bbox": np.asarray(bbox)}
    label["location"] = global_t[:3, :3] @ bottom_center + global_t[:3, 3]
    label["dimensions"] = [height, width, length]
    label["rotation_y"] = geometry.roty_in_bev(global_t)
    label["alpha"] = geometry.alpha_in_bev(global_t, label["rotation_y"])
    label["score"] = 1
    return label


def get_kitti_label(sdf_decoder, grid_points, latent, scale, trans, yaw,
                    p_wc: np.ndarray, bbox, capacity: int = 4096):
    """(label dict, scaled surface points, cam_T 4x4), decoding the surface
    at `latent` on the grid's device (refinement.py:501-562): the
    host-driven label that the quality suite's ground truth uses. The label
    is None when the band is empty (QUIRKS #15)."""
    yaw_f = float(np.asarray(yaw).reshape(-1)[0])
    scale_f = float(np.asarray(scale).reshape(-1)[0])
    trans_np = np.asarray(trans, np.float64).reshape(3)
    cam_t = np.eye(4)
    cam_t[:3, :3] = geometry.rot_from_yaw_np(yaw_f) @ np.diag([1.0, -1.0, 1.0])
    cam_t[:3, 3] = trans_np * scale_f
    with torch.no_grad():
        surf, _ = grid_ops.surface_from_decoder(
            sdf_decoder, torch.as_tensor(np.asarray(latent, np.float32),
                                         device=grid_points.device).reshape(
                                             -1), grid_points,
            capacity=capacity)
    pts = surf.points.detach().cpu().numpy()[surf.mask.cpu().numpy()]
    if len(pts) == 0:
        return None, None, cam_t
    scaled_points = pts * scale_f
    label = kitti_label_from_extents(
        yaw_f, 1.0, trans_np * scale_f, scaled_points.min(0),
        scaled_points.max(0), p_wc, bbox)
    return label, scaled_points, cam_t
