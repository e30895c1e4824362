"""Differentiable point-splat rasterizer, 'disc' primitive.

Counterpart of sdflabel_tpu/renderer/rasterer.py::render for the paths the
refinement loop and the crop generator take: 'disc' surfels without a
background. Per-point
features [color(3) | 1 | z | normal(3)] composite in one call of kernel 1
(ops/splat_cuda.py), which takes its plain version on CPU tensors. The
batched driver renders B crops at once (``rot='dcm'``): (B, 3, 3)
intrinsics, (B, 4, 4) poses and (B, N, ·) points give images and points
with a leading crop axis, as ``jax.vmap`` of the JAX render does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdflabel_tpu_torch.ops import splat as splat_ops
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.ops.projection import project_dcm, project_quat


def calibration_matrix(resolution_px, diagonal_mm=20.0, focal_len_mm=70.0,
                       skew=0.0) -> np.ndarray:
    """Default intrinsics from sensor geometry (utils_rasterer.py:59-83)."""
    res_x, res_y = resolution_px
    diagonal_px = float(np.sqrt(res_x**2 + res_y**2))
    alpha = focal_len_mm * diagonal_px / diagonal_mm
    return np.array([[alpha, skew, res_x / 2.0], [0.0, alpha, res_y / 2.0],
                     [0.0, 0.0, 1.0]], dtype=np.float32)


class Rendering(NamedTuple):
    """Rendered images, channel first (C, H, W), after the crop axis if
    any."""

    color: torch.Tensor  # (3, H, W), clamped to <= 1
    mask: torch.Tensor  # (1, H, W)
    depth: torch.Tensor  # (1, H, W)
    normals: torch.Tensor  # (3, H, W)


class RenderedPoints(NamedTuple):
    xyz: torch.Tensor  # (N, 3) camera-frame points
    rgb: torch.Tensor  # (N, 3) (colors + 1) / 2
    mask: torch.Tensor  # (N,) valid surface points
    front_mask: torch.Tensor  # (N,) valid and facing the camera


def splat_inputs(K: torch.Tensor, resolution_px: tuple[int, int],
                 coords: torch.Tensor, normals: torch.Tensor,
                 colors: torch.Tensor, camera_pose: torch.Tensor,
                 rot: str = "quat", output_nocs: bool = False):
    """The projection and what :func:`render` composites: (projected
    points, (N, 8) features [color(3) | 1 | z | normal(3)], (P, 3) pixel
    rays), each after the crop axis if any."""
    res_x, res_y = resolution_px
    dev = coords.device
    if rot == "dcm":
        proj = project_dcm(K, camera_pose, coords, normals, colors,
                           resolution_px, output_nocs=output_nocs)
    elif rot == "quat":
        if coords.dim() != 2:
            raise NotImplementedError("the quaternion projection takes one "
                                      "crop")
        proj = project_quat(K, camera_pose, coords, normals, colors,
                            resolution_px, output_nocs=output_nocs)
    else:
        raise ValueError(f"unknown rot {rot!r}")
    v3d, nrm, clr = proj.points_3d, proj.normals_3d, proj.colors_3d
    colors_ext = (clr + 1.0) / 2.0 if output_nocs else clr
    feats = torch.cat([colors_ext,
                       torch.ones(*v3d.shape[:-1], 1, device=dev,
                                  dtype=coords.dtype),
                       v3d[..., 2:3], (nrm + 1.0) / 2.0], dim=-1)
    kinv_grid = splat_ops.kinv_pixel_rays(
        K, splat_ops.pixel_grid(res_x, res_y, device=dev))
    return proj, feats, kinv_grid


def render(K: torch.Tensor, resolution_px: tuple[int, int],
           coords: torch.Tensor, normals: torch.Tensor, colors: torch.Tensor,
           camera_pose: torch.Tensor, point_mask: torch.Tensor | None = None,
           rot: str = "quat", primitives: str = "disc",
           output_nocs: bool = False, use_bg: bool = False,
           bg: torch.Tensor | None = None, bin_px: int | None = None
           ) -> tuple[Rendering, RenderedPoints]:
    """Render a point set (rasterer.py:49-155). Only the 'disc' primitive
    without a background is ported; other arguments raise. Renders of
    4096 pixels and more take the row-binned splat kernels
    (ops/splat_cuda.py::bin_policy), smaller ones the dense ones; `bin_px`
    is passed to surfel_composite (on the CPU, 512 takes the windowed
    plain version, which a large canvas needs)."""
    if primitives != "disc":
        raise NotImplementedError(f"primitive {primitives!r} is not ported")
    if use_bg or bg is not None:
        raise NotImplementedError("background compositing is not ported")
    res_x, res_y = resolution_px
    dev = coords.device
    proj, feats, kinv_grid = splat_inputs(K, resolution_px, coords, normals,
                                          colors, camera_pose, rot,
                                          output_nocs)
    v3d, nrm, clr = proj.points_3d, proj.normals_3d, proj.colors_3d
    img = splat_cuda.surfel_composite(v3d, nrm, feats, kinv_grid,
                                      point_mask=point_mask, diam=0.04,
                                      bin_px=bin_px)
    img = img.transpose(-1, -2).reshape(*img.shape[:-2], 8, res_y, res_x)
    rendering = Rendering(color=torch.clamp(img[..., 0:3, :, :], max=1.0),
                          mask=torch.clamp(img[..., 3:4, :, :], max=1.0),
                          depth=img[..., 4:5, :, :],
                          normals=torch.clamp(img[..., 5:8, :, :], max=1.0))
    valid = (torch.ones(v3d.shape[:-1], dtype=torch.bool, device=dev)
             if point_mask is None else point_mask.bool())
    points = RenderedPoints(xyz=v3d, rgb=(clr + 1.0) / 2.0, mask=valid,
                            front_mask=valid & proj.front_mask)
    return rendering, points
