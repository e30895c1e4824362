"""Differentiable surfel splatting: the dense plain version of kernel 1.

Counterpart of sdflabel_tpu/ops/splat.py for the 'disc' primitive
(primitives.py:165-242). The footprint is a detached binary indicator;
the depth softmax is differentiable, so gradients reach point positions
and normals through the ray-plane depth. This module builds the (N, P)
matrices; ops/splat_cuda.py computes the same composite without them.
"""

from __future__ import annotations

import torch

# Largest fp32 x with torch.sigmoid(x) == 0 (QUIRKS #1). The 'disc' path
# splats with softclamp=False and never reaches it; kept for the circle
# primitives, which binarize sigmoid footprints against it.
_SIGMOID_ZERO_X = -88.72283
_EPS = torch.finfo(torch.float32).eps


def pixel_grid(res_x: int, res_y: int, device="cpu",
               dtype=torch.float32) -> torch.Tensor:
    """(P, 2) pixel grid in (x, y) order, row-major over y then x."""
    ys = torch.arange(res_y, device=device, dtype=dtype)
    xs = torch.arange(res_x, device=device, dtype=dtype)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def kinv_pixel_rays(K: torch.Tensor, grid_2d: torch.Tensor) -> torch.Tensor:
    """(P, 3) per-pixel camera rays [grid | 1] @ inv(K).T in fp32 — the one
    definition shared by the dense version and the kernel. (B, 3, 3)
    intrinsics, one per crop, give (B, P, 3)."""
    ones = torch.ones(grid_2d.shape[0], 1, device=grid_2d.device,
                      dtype=torch.float32)
    kinv = torch.linalg.inv(K.float())
    return torch.cat([grid_2d.float(), ones], dim=-1) @ kinv.transpose(-1, -2)


def surfel_prob(kinv_grid: torch.Tensor, vertex_3d: torch.Tensor,
                normals: torch.Tensor, point_mask: torch.Tensor | None = None,
                diam: float = 0.03, depth_constant: float = 150.0
                ) -> torch.Tensor:
    """(N, P) composition probabilities of splat_surfel(softclamp=False,
    add_bg=False), from precomputed pixel rays."""
    n_v3d = (normals * vertex_3d).sum(-1)  # (N,)
    n_kinv = normals @ kinv_grid.T  # (N, P)
    eps = torch.full_like(n_kinv, _EPS)
    n_kinv = torch.where(n_kinv.abs() < 0.01, eps, n_kinv)
    z = n_v3d[:, None] / n_kinv  # ray depth of the tangent plane
    # explicit (N, P, 3) tangent-plane points, as primitives.py:215-218
    vec = vertex_3d[:, None, :] - kinv_grid[None, :, :] * z[:, :, None]
    dist = torch.sqrt((vec * vec).sum(-1))
    footprint = (torch.clamp(diam - dist, min=0.0) > 0).to(
        vertex_3d.dtype).detach()
    if point_mask is not None:
        footprint = footprint * point_mask.to(vertex_3d.dtype)[:, None]
    z_scores = -z * footprint
    z_norm = torch.linalg.norm(z_scores, dim=0, keepdim=True).detach()
    z_scores = torch.clamp(z_scores / (z_norm + _EPS) + 1.0,
                           min=0.0) * depth_constant
    fmin = torch.finfo(vertex_3d.dtype).min
    masked = torch.where(footprint > 0, z_scores,
                         torch.full_like(z_scores, fmin))
    return torch.softmax(masked, dim=0) * footprint


def splat_surfel(K: torch.Tensor, grid_2d: torch.Tensor,
                 vertex_3d: torch.Tensor, normals: torch.Tensor,
                 point_mask: torch.Tensor | None = None, diam: float = 0.03,
                 depth_constant: float = 150.0) -> torch.Tensor:
    """3D tangent-disc splats (primitives.py:165-242), softclamp=False and
    no background row — the only form the port's main path uses."""
    return surfel_prob(kinv_pixel_rays(K, grid_2d), vertex_3d, normals,
                       point_mask, diam, depth_constant)


def surfel_composite_dense(points_cam: torch.Tensor, normals_cam: torch.Tensor,
                           features: torch.Tensor, kinv_grid: torch.Tensor,
                           point_mask: torch.Tensor | None = None,
                           diam: float = 0.04, depth_constant: float = 150.0
                           ) -> torch.Tensor:
    """Plain version of kernel 1: ``prob.T @ features`` -> (P, F). Autograd
    through it is the plain version of the kernel's backward; as in the
    kernel, no gradient reaches the pixel rays."""
    prob = surfel_prob(kinv_grid.detach(), points_cam, normals_cam,
                       point_mask, diam, depth_constant)
    return prob.T @ features
