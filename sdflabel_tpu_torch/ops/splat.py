"""Differentiable point splatting: the dense plain version of kernel 1,
and the circle primitives.

Counterpart of sdflabel_tpu/ops/splat.py: the 'disc' surfels
(primitives.py:165-242), the 2D circles (:4-71) and the stamped circles
(:74-162). The footprint is a detached binary indicator; the depth softmax
is differentiable, so gradients reach point positions (and, for discs,
normals through the ray-plane depth). This module builds the (N, P)
matrices; ops/splat_cuda.py computes the disc composite without them.
"""

from __future__ import annotations

import math

import torch

# Largest fp32 x with torch.sigmoid(x) == 0 (QUIRKS #1). The 'disc' path
# splats with softclamp=False and never reaches it; the circle primitives
# binarize their sigmoid footprints against it.
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


def _background_score(z: torch.Tensor, point_mask) -> torch.Tensor:
    """The background row's score: one below the least point score, 0
    when every point is masked (inf - 1 would make the softmax NaN)."""
    if point_mask is not None:
        z = torch.where(point_mask.bool(), z, torch.full_like(z, math.inf))
    zmin = z.min()
    return torch.where(torch.isfinite(zmin), zmin - 1.0,
                       torch.zeros_like(zmin))


def _masked_depth_softmax(scores, footprint, bg_score=None):
    """softmax over points of the scores where the footprint is set
    (finfo.min elsewhere, not -inf: an uncovered pixel softmaxes to
    uniform, then zeroes against the footprint), times the footprint
    (primitives.py:158-161, :238-241). A background score appends a row
    that covers every pixel."""
    if bg_score is not None:
        scores = torch.cat([scores, bg_score.expand(1, scores.shape[1])])
        footprint = torch.cat([footprint, torch.ones_like(footprint[:1])])
    masked = torch.where(footprint > 0, scores,
                         torch.full_like(scores,
                                         torch.finfo(scores.dtype).min))
    return torch.softmax(masked, dim=0) * footprint


def surfel_prob(kinv_grid: torch.Tensor, vertex_3d: torch.Tensor,
                normals: torch.Tensor, point_mask: torch.Tensor | None = None,
                diam: float = 0.03, depth_constant: float = 150.0,
                add_bg: bool = False) -> torch.Tensor:
    """(N, P) composition probabilities of splat_surfel(softclamp=False),
    from precomputed pixel rays; (N + 1, P) with the background row."""
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
    bg = (_background_score(-vertex_3d[:, 2] * depth_constant, point_mask)
          if add_bg else None)
    return _masked_depth_softmax(z_scores, footprint, bg)


def splat_surfel(K: torch.Tensor, grid_2d: torch.Tensor,
                 vertex_3d: torch.Tensor, normals: torch.Tensor,
                 point_mask: torch.Tensor | None = None, diam: float = 0.03,
                 depth_constant: float = 150.0,
                 add_bg: bool = False) -> torch.Tensor:
    """3D tangent-disc splats (primitives.py:165-242) with softclamp=False,
    the form every caller uses; `add_bg` appends the background row."""
    return surfel_prob(kinv_pixel_rays(K, grid_2d), vertex_3d, normals,
                       point_mask, diam, depth_constant, add_bg)


def _point_depth_scores(vertex_3d, point_mask, depth_constant):
    """(N, 1) circle scores: -z normalized over the valid points, + 1,
    clamped at 0, times depth_constant; the norm carries no gradient."""
    z = -vertex_3d[:, 2:3]
    zm = z if point_mask is None else torch.where(
        point_mask.bool()[:, None], z, torch.zeros_like(z))
    z_norm = torch.linalg.norm(zm, dim=0, keepdim=True).detach()
    return torch.clamp(z / (z_norm + _EPS) + 1.0, min=0.0) * depth_constant


def splat_circle(K: torch.Tensor, grid_2d: torch.Tensor,
                 vertex_2d: torch.Tensor, vertex_3d: torch.Tensor,
                 point_mask: torch.Tensor | None = None, diam: float = 0.07,
                 depth_constant: float = 100.0,
                 softclamp_constant: float = 3.0,
                 add_bg: bool = False) -> torch.Tensor:
    """Dense 2D circle splats (primitives.py:4-71), softclamped: (N, P), or
    (N + 1, P) with the background row. The reference composes
    softmax(scores * footprint) with no masked fill, so a pixel outside a
    point's footprint still counts exp(0) in that point's denominator
    (primitives.py:68); masked points leave every denominator."""
    diff = vertex_2d[:, None, :2] - grid_2d[None, :, :]
    pix_dist = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    radius = (K[0, 0] * diam / (vertex_3d[:, 2] + _EPS)).abs()[:, None]
    x_soft = (radius - pix_dist) * softclamp_constant
    footprint = (x_soft > _SIGMOID_ZERO_X).to(vertex_3d.dtype).detach()
    if point_mask is not None:
        footprint = footprint * point_mask.to(vertex_3d.dtype)[:, None]
    z = _point_depth_scores(vertex_3d, point_mask, depth_constant)
    scores = z.expand(footprint.shape)
    keep = (torch.ones_like(footprint[:, :1], dtype=torch.bool)
            if point_mask is None else point_mask.bool()[:, None])
    if add_bg:
        scores = torch.cat([scores, _background_score(z[:, 0], point_mask)
                            .expand(1, scores.shape[1])])
        footprint = torch.cat([footprint, torch.ones_like(footprint[:1])])
        keep = torch.cat([keep, torch.ones_like(keep[:1])])
    base = torch.where(keep, scores * footprint,
                       torch.full_like(footprint,
                                       torch.finfo(footprint.dtype).min))
    return torch.softmax(base, dim=0) * footprint


def primitive_grid(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(225, 2) offsets of the 15x15 stamp in (x, y), rows over y
    (rasterer.py:30-32)."""
    ys, xs = torch.meshgrid(torch.arange(-7, 8), torch.arange(-7, 8),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).to(
        device=device, dtype=dtype)


def splat_circle_opt(K: torch.Tensor, grid_prim: torch.Tensor,
                     vertex_2d: torch.Tensor, vertex_3d: torch.Tensor,
                     res_x: int, res_y: int,
                     point_mask: torch.Tensor | None = None,
                     diam: float = 0.06, depth_constant: float = 10000.0,
                     softclamp_constant: float = 5.0,
                     add_bg: bool = True) -> torch.Tensor:
    """Stamped circle splats (primitives.py:74-162), softclamped: each point
    adds its 15x15 stamp of sigmoid values at the pixels under it (clamped
    to the image) into a dense (N, P) matrix, repeated pixels adding up as
    the reference's sparse COO densify does; the footprint is where that
    sum is positive."""
    n, p = vertex_3d.shape[0], res_x * res_y
    dt = vertex_3d.dtype
    stamp_dist = torch.sqrt(torch.clamp((grid_prim.to(dt) ** 2).sum(-1),
                                        min=0.0))
    radius = (K[0, 0] * diam / (vertex_3d[:, 2] + _EPS)).abs()
    vals = torch.sigmoid((radius[:, None] - stamp_dist[None, :])
                         * softclamp_constant)
    pos = torch.floor(grid_prim.to(dt)[None] + vertex_2d[:, None, :2]).long()
    flat = pos[..., 1].clamp(0, res_y - 1) * res_x \
        + pos[..., 0].clamp(0, res_x - 1)
    if point_mask is not None:
        vals = vals * point_mask.to(dt)[:, None]
    rows = torch.arange(n, device=flat.device)[:, None].expand_as(flat)
    dense = torch.zeros(n * p, device=vertex_3d.device, dtype=dt)
    dense = dense.index_put(((rows * p + flat).reshape(-1),),
                            vals.reshape(-1).detach(), accumulate=True)
    footprint = (dense.reshape(n, p) > 0).to(dt)
    z = _point_depth_scores(vertex_3d, point_mask, depth_constant)
    scores = z.expand(n, p)
    if point_mask is not None:
        footprint = footprint * point_mask.to(dt)[:, None]
        scores = torch.where(point_mask.bool()[:, None], scores,
                             torch.full_like(scores, torch.finfo(dt).min))
    bg = _background_score(z[:, 0], point_mask) if add_bg else None
    return _masked_depth_softmax(scores, footprint, bg)


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
