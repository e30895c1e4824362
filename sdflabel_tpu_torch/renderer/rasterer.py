"""Differentiable point-splat rasterizer.

Counterpart of sdflabel_tpu/renderer/rasterer.py. Per-point features
[color(3) | 1 | z | normal(3)] composite into the color, mask, depth and
normal images. 'disc' surfels without a background, the refinement
loop's and the crop generator's renders, composite in one call of kernel
1 (ops/splat_cuda.py), which takes its plain version on CPU tensors. The
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
    """Render a point set (rasterer.py:49-155); primitives 'disc' (surfels,
    diam 0.04), 'circle' (2D circles, diam 0.02) or 'circle_opt' (stamped
    circles, diam 0.025). `bg`, a (3, H, W) or (P, 3) background color
    image (implies `use_bg`), composites through the background softmax
    row: color gets its share of the background, mask counts the row,
    depth and normals composite from the points alone, as in JAX. A
    'disc' render without a background takes the splat kernels: renders
    of 4096 pixels and more the row-binned ones
    (ops/splat_cuda.py::bin_policy), smaller ones the dense ones; `bin_px`
    is passed to surfel_composite (on the CPU, 512 takes the windowed
    plain version, which a large canvas needs). With a crop axis, the
    circles and a background (then one per crop) render crop by crop."""
    if primitives not in ("disc", "circle", "circle_opt"):
        raise ValueError(f"unknown primitives {primitives!r}")
    use_bg = use_bg or bg is not None
    if (use_bg or primitives != "disc") and coords.dim() == 3:
        # one crop at a time, as jax.vmap of the plain render
        out = [render(K[b] if K.dim() == 3 else K, resolution_px,
                      coords[b], normals[b], colors[b], camera_pose[b],
                      None if point_mask is None else point_mask[b], rot,
                      primitives, output_nocs, use_bg,
                      None if bg is None else bg[b])
               for b in range(coords.shape[0])]
        return tuple(type(parts[0])(*(torch.stack(f) for f in zip(*parts)))
                     for parts in zip(*out))
    res_x, res_y = resolution_px
    dev = coords.device
    proj, feats, kinv_grid = splat_inputs(K, resolution_px, coords, normals,
                                          colors, camera_pose, rot,
                                          output_nocs)
    v3d, nrm, clr = proj.points_3d, proj.normals_3d, proj.colors_3d
    if primitives == "disc" and not use_bg:
        img = splat_cuda.surfel_composite(v3d, nrm, feats, kinv_grid,
                                          point_mask=point_mask, diam=0.04,
                                          bin_px=bin_px)
    else:
        # JAX computes the circles and every background render in plain
        # XLA on every backend (no Pallas kernel models them), so plain
        # torch is their counterpart on the card too
        img = _plain_composite(K, (res_x, res_y), proj, feats, kinv_grid,
                               point_mask, primitives, use_bg, bg)
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


def _plain_composite(K, resolution_px, proj, feats, kinv_grid, point_mask,
                     primitives, use_bg, bg):
    """(P, 8) composite through the dense probabilities of `primitives`,
    the background row added to color and mask."""
    res_x, res_y = resolution_px
    v3d, v2d = proj.points_3d, proj.points_2d
    n = v3d.shape[0]
    if primitives == "circle":
        grid = splat_ops.pixel_grid(res_x, res_y, device=v3d.device)
        prob = splat_ops.splat_circle(K, grid, v2d, v3d, point_mask,
                                      diam=0.02, add_bg=use_bg)
    elif primitives == "circle_opt":
        prob = splat_ops.splat_circle_opt(
            K, splat_ops.primitive_grid(v3d.dtype, v3d.device), v2d, v3d,
            res_x, res_y, point_mask, diam=0.025, add_bg=use_bg)
    else:
        prob = splat_ops.surfel_prob(kinv_grid, v3d, proj.normals_3d,
                                     point_mask, diam=0.04, add_bg=use_bg)
    img = prob[:n].T @ feats
    if not use_bg:
        return img
    prob_bg = prob[n][:, None]
    color = torch.zeros_like(img[:, 0:3])
    if bg is not None:
        bg_flat = bg.reshape(3, -1).T if bg.dim() == 3 else bg
        color = prob_bg * bg_flat.to(img.dtype)
    # the mask counts the background row (rasterer.py:124)
    return img + torch.cat([color, prob_bg, torch.zeros_like(img[:, 4:])],
                           -1)
