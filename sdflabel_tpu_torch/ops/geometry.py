"""Geometry helpers used on the refinement path.

Counterpart of sdflabel_tpu/ops/geometry.py: ``rot_from_yaw`` on tensors
(it runs inside the differentiable iteration) and copies of the host-side
numpy helpers that crop preparation and label finishing use.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rot_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    """Yaw -> 3x3 rotation about +Y (refinement.py:108-125); (B, 1) yaws,
    one per crop, give (B, 3, 3)."""
    yaw = yaw[:, 0] if yaw.dim() == 2 else yaw.reshape(())
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([c, z, s, z, o, z, -s, z, c], -1).reshape(
        *yaw.shape, 3, 3)


def rot_from_yaw_np(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def roty_in_bev(pose: np.ndarray) -> float:
    """Rotation about Y in BEV from a pose matrix (refinement.py:201-227)."""
    forward = pose[:3, :3] @ np.asarray([0.0, 0.0, 1.0])
    rotation_y = math.acos(float(np.clip(np.asarray([1.0, 0, 0]) @ forward,
                                         -1, 1)))
    if forward[2] > 0:
        rotation_y *= -1
    return rotation_y


def alpha_in_bev(pose: np.ndarray, rot_y: float) -> float:
    """Observation angle alpha from pose + rot_y (refinement.py:230-252)."""
    car = np.asarray([[0.0, 0, 1], [0, 0, 0]])
    car = ((pose[:3, :3] @ car.T).T + pose[:3, 3])[:, ::2]
    theta = np.arctan2(abs(car[1, 0]), abs(car[1, 1]))
    if car[1, 0] < 0:
        return rot_y + theta
    return rot_y - theta


def get_iou(a, b, epsilon: float = 1e-5) -> float:
    """LTRB IoU without the +1 convention (refinement.py:128-165)."""
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    w, h = x2 - x1, y2 - y1
    if w < 0 or h < 0:
        return 0.0
    inter = w * h
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return inter / (union + epsilon)


def compute_iou(box_a, box_b) -> float:
    """LTRB IoU with the inclusive +1 convention (refinement.py:168-198)."""
    xa, ya = max(box_a[0], box_b[0]), max(box_a[1], box_b[1])
    xb, yb = min(box_a[2], box_b[2]), min(box_a[3], box_b[3])
    inter = max(0, xb - xa + 1) * max(0, yb - ya + 1)
    area_a = (box_a[2] - box_a[0] + 1) * (box_a[3] - box_a[1] + 1)
    area_b = (box_b[2] - box_b[0] + 1) * (box_b[3] - box_b[1] + 1)
    return inter / float(area_a + area_b - inter)


def project_np(K: np.ndarray, p3d: np.ndarray) -> np.ndarray:
    """Pinhole projection (refinement.py:470-472 without cv2)."""
    p2h = p3d @ K.T
    return (p2h[:, :2] / p2h[:, 2:3]).astype(np.float32)


def unproject_np(K: np.ndarray, p2d: np.ndarray) -> np.ndarray:
    """Pixel -> unit-depth ray (refinement.py:475-477 without cv2)."""
    ones = np.ones((p2d.shape[0], 1), dtype=np.float64)
    homo = np.concatenate([p2d.astype(np.float64), ones], axis=1)
    return (homo @ np.linalg.inv(K).T).astype(np.float32)


def build_view_frustum(K: np.ndarray, l, t, r, b) -> np.ndarray:
    """The 4 inward frustum plane normals (refinement.py:480-498)."""
    corners = np.asarray([(l, t), (r - 1, t), (r - 1, b - 1), (l, b - 1)],
                         dtype=np.float32)
    rays = unproject_np(K, corners)
    rays /= np.linalg.norm(rays, axis=1)[:, None]
    return np.stack((np.cross(rays[0], rays[1]), np.cross(rays[1], rays[2]),
                     np.cross(rays[2], rays[3]), np.cross(rays[3], rays[0])))


def compute_depth_map(lidar: np.ndarray, cam: np.ndarray, w: int,
                      h: int) -> np.ndarray:
    """LIDAR depth map without a z-buffer: the last point written to a
    pixel wins (refinement.py:87-105, vectorised)."""
    frustum = build_view_frustum(cam, 0, 0, w, h)
    xyz = lidar[np.logical_and.reduce(frustum @ lidar.T > 0, axis=0)]
    depth = np.zeros((h, w), dtype=np.float32)
    if len(xyz) == 0:
        return depth
    uv = project_np(cam, xyz).astype(np.int32)
    ok = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
    depth[uv[ok, 1], uv[ok, 0]] = xyz[ok, 2]
    return depth


def reproject_np(color: np.ndarray, depth: np.ndarray, K: np.ndarray,
                 filter_nocs: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Depth map -> colored 3D points of the nonzero-depth pixels
    (refinement.py:360-410); with filter_nocs, drops black colors.
    color: (H,W,3) or (3,H,W); depth: (H,W) or (1,H,W)."""
    depth = np.squeeze(np.asarray(depth))
    y, x = np.nonzero(depth)
    good_xy = np.stack((x, y), axis=1).astype(np.float32)
    homo = np.concatenate([good_xy, np.ones((len(good_xy), 1), np.float32)],
                          axis=1)
    p3 = homo @ np.linalg.inv(K).T.astype(np.float32)
    pts = p3 * depth[y, x][:, None]
    color = np.asarray(color)
    if color.ndim == 3 and color.shape[0] == 3:
        cols = color[:, y, x].T
    else:
        cols = color[y, x]
    if filter_nocs:
        active = (cols > 0).sum(axis=1) > 0
        pts, cols = pts[active], cols[active]
    return pts.astype(np.float32), cols.astype(np.float32)


def transform_kitti_to_cuboid(width, height, length, location,
                              rot_y) -> np.ndarray:
    """KITTI label -> (8, 3) cuboid corners, the front face first
    (refinement.py:424-447): rotated about +Y by rot_y + pi/2, placed at
    the bottom-centre `location`."""
    w, h, l = width, height, length
    front = np.asarray([[-w / 2, -h, l / 2], [w / 2, -h, l / 2],
                        [w / 2, 0, l / 2], [-w / 2, 0, l / 2]])
    back = front.copy()
    back[:, 2] *= -1
    angle = rot_y + np.pi / 2
    rot = np.array([[math.cos(angle), 0, math.sin(angle)], [0, 1, 0],
                    [-math.sin(angle), 0, math.cos(angle)]])
    return (rot @ np.vstack((front, back)).T).T + np.asarray(location)


def adjust_intrinsics_crop(K, crop_size, bbox, max_crop_area):
    """Intrinsics for a crop under an area budget (refinement.py:586-609).
    Returns (new [h, w] crop size, scaled intrinsics, offset-only ones)."""
    l, t, r, b = bbox
    crop_h, crop_w = float(crop_size[0]), float(crop_size[1])
    ratio = math.sqrt(max_crop_area / (crop_h * crop_w))
    new_size = [int(crop_h * ratio), int(crop_w * ratio)]
    intrinsics = np.array(K, dtype=np.float32).reshape(3, 3).copy()
    intrinsics[0, 2] -= l
    intrinsics[1, 2] -= t
    off_intrinsics = intrinsics.copy()
    intrinsics[:2] *= ratio
    return new_size, intrinsics, off_intrinsics
