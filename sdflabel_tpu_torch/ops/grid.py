"""3D sampling grid + zero-isosurface projection.

Counterpart of sdflabel_tpu/ops/grid.py (reference: sdfrenderer/grid.py).
The reference's dynamic masked_select becomes a fixed-capacity top-k of the
smallest |sdf| with a validity mask (|sdf| < threshold); every consumer
downstream is mask-aware. The selection passes run without gradients; the
K selected points are decoded again differentiably (stage 2) and their
normals are the autograd gradient of the SDF w.r.t. the points, detached.
Top-k results are sets: the order of ties in torch.topk is unspecified,
and nothing downstream depends on order.

The batched driver passes (B, L) latents, one per crop: every function
then keeps a leading crop axis (top-k per crop, the selected points
(B, K, 3)), as ``jax.vmap`` of the JAX functions does. The grid stays one
(N, 3) set shared by every crop. Autograd normals come from d(sum of every
crop's sdf)/dp, exact because crops do not couple.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _generate_point_grid_np(density: int) -> np.ndarray:
    """density^3 grid over [-1,1]^3; every second point in FLATTENED order
    gets x,y shifted by half a cell (grid.py:34-38 — the code, not its
    comment; QUIRKS #4)."""
    lin = np.linspace(-1.0, 1.0, density)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    grid = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    half_cell = (lin.max() - lin.min()) / density / 2.0
    grid[1::2, :2] += half_cell
    return grid.astype(np.float32)


def generate_point_grid(density: int, device="cpu",
                        dtype=torch.float32) -> torch.Tensor:
    """The (density^3, 3) sample grid."""
    return torch.as_tensor(_generate_point_grid_np(density), device=device,
                           dtype=dtype)


class SurfacePoints(NamedTuple):
    """Fixed-capacity surface point set (dim K everywhere, after the crop
    axis if any).

    points (K,3) projected p - sdf * n; nocs (K,3) (p + 1) / 2;
    normals (K,3) unit SDF gradients; mask (K,) |sdf| < threshold.
    """

    points: torch.Tensor
    nocs: torch.Tensor
    normals: torch.Tensor
    mask: torch.Tensor


def _unit(grads: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.norm(grads, dim=-1, keepdim=True)
    return grads / torch.clamp(norm, min=torch.finfo(grads.dtype).tiny)


def isosurface_project(points: torch.Tensor, sdf: torch.Tensor,
                       normals: torch.Tensor, capacity: int,
                       threshold: float = 0.03) -> SurfacePoints:
    """Project p -> p - sdf * n and keep the `capacity` smallest |sdf|
    with a validity mask (grid.py:43-71). normals are raw gradients."""
    sdf = sdf.reshape(-1)
    normals_unit = _unit(normals)
    projected = points - sdf[:, None] * normals_unit
    neg_abs, idx = torch.topk(-sdf.abs(), capacity)
    pts = projected[idx]
    return SurfacePoints(points=pts, nocs=(pts + 1.0) / 2.0,
                         normals=normals_unit[idx], mask=(-neg_abs) < threshold)


def _select(sel_fn, latent, points, k) -> torch.Tensor:
    """Indices of the k smallest |sdf| (no gradient: selection only), per
    crop for (B, L) latents."""
    with torch.no_grad():
        sdf = sel_fn(latent.detach(), points).reshape(
            *latent.shape[:-1], -1).float()
    return torch.topk(-sdf.abs(), k).indices


def _take(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `idx` (..., K) of points (N, 3) shared by every crop or
    (B, N, 3) of their own -> (..., K, 3)."""
    if points.dim() == 2:
        return points[idx]
    return torch.take_along_dim(points, idx[..., None], dim=-2)


def _stage2_surface(decoder_fn, latent, pts_sel, threshold,
                    stage2_fn=None) -> SurfacePoints:
    """Exact differentiable decode at the selected points: the SDF keeps
    its graph to the latent; the normals are d sdf / d p from autograd,
    detached (optimizer.py:107; QUIRKS #5). retain_graph keeps the SDF's
    graph alive for the loss backward. `stage2_fn(latent, points) -> (sdf,
    raw normals)`, e.g. the fused kernels of ops/mlp2_cuda.py, replaces
    the decode and the autograd normals."""
    pts_sel = pts_sel.detach()
    if stage2_fn is not None and latent.dim() == 2:
        # kernels 4a and 4b take one crop: one launch each per crop
        sdf, grads = (torch.stack(t) for t in zip(*(
            stage2_fn(lat, p) for lat, p in zip(latent, pts_sel))))
    elif stage2_fn is not None:
        sdf, grads = stage2_fn(latent, pts_sel)
    else:
        with torch.enable_grad():
            p = pts_sel.clone().requires_grad_(True)
            sdf = decoder_fn(latent, p)
            (grads,) = torch.autograd.grad(sdf.sum(), p, retain_graph=True)
    sdf = sdf.reshape(pts_sel.shape[:-1])
    normals_unit = _unit(grads.detach())
    projected = pts_sel - sdf[..., None] * normals_unit
    return SurfacePoints(points=projected, nocs=(projected + 1.0) / 2.0,
                         normals=normals_unit, mask=sdf.abs() < threshold)


def surface_from_decoder(decoder_fn, latent: torch.Tensor,
                         points: torch.Tensor, capacity: int,
                         threshold: float = 0.03, select_decoder_fn=None,
                         stage2_fn=None
                         ) -> tuple[SurfacePoints, torch.Tensor]:
    """Two-stage decode: stage 1 ranks the whole grid without gradients
    (through `select_decoder_fn` when given, e.g. the selection kernel),
    stage 2 decodes the `capacity` selected points exactly (through
    `stage2_fn` when given). Returns (surface, stage-1 sdf of the grid)."""
    sel_fn = select_decoder_fn if select_decoder_fn is not None \
        else decoder_fn
    with torch.no_grad():
        sdf_all = sel_fn(latent.detach(), points).reshape(
            *latent.shape[:-1], -1).float()
    idx = torch.topk(-sdf_all.abs(), capacity).indices
    return _stage2_surface(decoder_fn, latent, points[idx], threshold,
                           stage2_fn), sdf_all


def surface_from_candidates(decoder_fn, latent: torch.Tensor,
                            points: torch.Tensor, cand_idx: torch.Tensor,
                            capacity: int, threshold: float = 0.03,
                            select_decoder_fn=None,
                            stage2_fn=None) -> SurfacePoints:
    """Two-stage decode restricted to a candidate set (the warm band).
    With exactly `capacity` candidates all are kept and stage 1 is
    skipped: the surface is a set and stage 2 computes the mask."""
    pts_cand = points[cand_idx]
    if cand_idx.shape[-1] == capacity:
        pts_sel = pts_cand
    else:
        sel_fn = select_decoder_fn if select_decoder_fn is not None \
            else decoder_fn
        pts_sel = _take(pts_cand, _select(sel_fn, latent, pts_cand,
                                          capacity))
    return _stage2_surface(decoder_fn, latent, pts_sel, threshold,
                           stage2_fn)


def band_candidates(decoder_fn, latent: torch.Tensor, points: torch.Tensor,
                    n_candidates: int) -> torch.Tensor:
    """Full-grid selection pass: the `n_candidates` indices with smallest
    |sdf| — the warm band's refresh."""
    return _select(decoder_fn, latent, points, n_candidates)
