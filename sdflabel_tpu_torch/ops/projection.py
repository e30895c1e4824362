"""Point projection world -> camera -> pixel, DCM and quaternion variants.

Counterpart of sdflabel_tpu/ops/projection.py (projection.py:7-199):
back-face culling gives a boolean ``front_mask`` instead of a dynamic
masked_select, so shapes stay fixed. All products run in fp32. The DCM
variant also takes a crop axis: (B, 3, 3) intrinsics, (B, 4, 4) poses and
(B, N, 3) points, each crop projected by its own camera; the gradient of
each crop's pose sums over that crop's points alone, in the operators of
one crop, so that it does not depend on the number of crops (cuBLAS and
the reduction kernels sum a batch of another size in another order, and
the refine carries such an ulp to centimetres).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v (..., 3) by w-first quaternions q (..., 4)
    (utils_rasterer.py:6-24)."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


class ProjectedPoints(NamedTuple):
    """Per point; a crop axis leads every field when the inputs carry one."""

    points_3d: torch.Tensor  # (N, 3) camera-frame points
    normals_3d: torch.Tensor  # (N, 3) rotated normals
    colors_3d: torch.Tensor  # (N, 3) colors (NOCS coords if output_nocs)
    points_2d: torch.Tensor  # (N, 2) pixel coords, clamped to [-1, res]
    front_mask: torch.Tensor  # (N,) normal faces the camera


class _Rigid(torch.autograd.Function):
    """x @ rot_t (+ trans) for (N, 3) points, or a crop axis (B, N, 3) with
    (B, 3, 3) and (B, 3): the forward as matmul computes it; the backward
    takes each crop's rot_t and trans gradients from that crop's rows
    alone, with the operators of one crop (an (N, 3)^T @ (N, 3) product and
    a sum over N), whatever the number of crops."""

    @staticmethod
    def forward(ctx, x, rot_t, trans):
        ctx.save_for_backward(x, rot_t)
        ctx.with_trans = trans is not None
        y = x @ rot_t
        return y if trans is None else y + trans[..., None, :]

    @staticmethod
    def backward(ctx, g):
        x, rot_t = ctx.saved_tensors
        gx = g_rot = g_trans = None
        if ctx.needs_input_grad[0]:
            gx = g @ rot_t.transpose(-1, -2)
        crops = [(x, g)] if x.dim() == 2 else list(zip(x, g))
        if ctx.needs_input_grad[1]:
            g_rot = [xb.transpose(0, 1) @ gb for xb, gb in crops]
            g_rot = g_rot[0] if x.dim() == 2 else torch.stack(g_rot)
        if ctx.with_trans and ctx.needs_input_grad[2]:
            g_trans = [gb.sum(0) for _, gb in crops]
            g_trans = g_trans[0] if x.dim() == 2 else torch.stack(g_trans)
        return gx, g_rot, g_trans


def _project_pixels(K, points_cam, resolution_px):
    res_x, res_y = resolution_px
    eps = torch.finfo(K.dtype).eps
    p2h = points_cam @ K.transpose(-1, -2)
    p2 = p2h[..., :2] / (p2h[..., 2:3] + eps)
    x = torch.clamp(p2[..., 0:1], -1.0, float(res_x))
    y = torch.clamp(p2[..., 1:2], -1.0, float(res_y))
    return torch.cat([x, y], dim=-1)


def project_dcm(K, camera_pose, points, normals, colors, resolution_px,
                output_nocs: bool = True) -> ProjectedPoints:
    """(4, 4) camera matrix projection (projection.py:7-101); with
    output_nocs the colors become the x-flipped object coordinates."""
    rot_t = camera_pose[..., :3, :3].transpose(-1, -2)
    points_cam = _Rigid.apply(points, rot_t, camera_pose[..., :3, 3])
    normals_cam = _Rigid.apply(normals, rot_t, None)
    if output_nocs:
        flip = torch.tensor([-1.0, 1.0, 1.0], device=points.device,
                            dtype=points.dtype)
        colors = points * flip
    dot = (normals_cam * points_cam).sum(-1)
    return ProjectedPoints(points_cam, normals_cam, colors,
                           _project_pixels(K, points_cam, resolution_px),
                           dot < 0)


def project_quat(K, camera_pose, points, normals, colors, resolution_px,
                 output_nocs: bool = True) -> ProjectedPoints:
    """(7,) [qw, qx, qy, qz, tx, ty, tz] pose (projection.py:104-199); the
    quaternion variant does not x-flip NOCS colors."""
    q = camera_pose[:4].expand(points.shape[0], 4)
    points_cam = qrot(q, points) + camera_pose[4:]
    normals_cam = qrot(q, normals)
    if output_nocs:
        colors = points
    dot = (normals_cam * points_cam).sum(-1)
    return ProjectedPoints(points_cam, normals_cam, colors,
                           _project_pixels(K, points_cam, resolution_px),
                           dot < 0)
