"""3D sampling grid + zero-isosurface projection.

Counterpart of sdflabel_tpu/ops/grid.py (reference: sdfrenderer/grid.py).
The reference's dynamic masked_select becomes a fixed-capacity top-k of the
smallest |sdf| with a validity mask (|sdf| < threshold); every consumer
downstream is mask-aware. The selection passes run without gradients; the
K selected points are decoded again differentiably (stage 2) and their
normals are the autograd gradient of the SDF w.r.t. the points, detached.
Every top-k keeps JAX's order, ties included (``_smallest``): a bf16
decoder's |sdf| ties at the k-th place, and every cell the surface
crosses scores exactly 0 in the coarse-cell pass, so which of the tied
points or cells is kept changes the selected set, not just its order.

Opt-in coarse-to-fine selection (``coarse_cells``): the grid is tiled into
(d / factor)^3 cells, each cell is scored from the decoded SDF at its 8
corners (one shared corner lattice), and only the best cells' points are
ranked.

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


@functools.lru_cache(maxsize=8)
def _cell_children_np(density: int, factor: int) -> np.ndarray:
    """(Nc, factor^3) flat indices of each coarse cell's grid points
    (flattened ij order: idx = x*d^2 + y*d + z); column 0 is the cell's
    origin corner."""
    d, r = density, factor
    if d % r != 0:
        raise ValueError(f"density {d} not divisible by coarse factor {r}")
    c = np.arange(d // r, dtype=np.int64) * r
    cx, cy, cz = np.meshgrid(c, c, c, indexing="ij")
    base = (cx * d * d + cy * d + cz).reshape(-1)
    o = np.arange(r, dtype=np.int64)
    ox, oy, oz = np.meshgrid(o, o, o, indexing="ij")
    offs = (ox * d * d + oy * d + oz).reshape(-1)
    return (base[:, None] + offs[None, :]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _cell_corner_lattice_np(density: int, factor: int):
    """(lattice_idx ((d/factor+1)^3,), cell2corner (Nc, 8)): the grid
    indices of every cell-boundary point (coordinates clamped to d-1 on
    the far face, where the grid has no point), and each cell's 8 corners
    as indices into that lattice, cells in _cell_children_np's order."""
    d, r = density, factor
    if d % r != 0:
        raise ValueError(f"density {d} not divisible by coarse factor {r}")
    dc = d // r
    cc = np.minimum(np.arange(dc + 1, dtype=np.int64) * r, d - 1)
    lx, ly, lz = np.meshgrid(cc, cc, cc, indexing="ij")
    lattice_idx = (lx * d * d + ly * d + lz).reshape(-1).astype(np.int32)
    ci = np.arange(dc, dtype=np.int64)
    ix, iy, iz = np.meshgrid(ci, ci, ci, indexing="ij")
    base = (ix * (dc + 1) * (dc + 1) + iy * (dc + 1) + iz).reshape(-1)
    o = np.arange(2, dtype=np.int64)
    ox, oy, oz = np.meshgrid(o, o, o, indexing="ij")
    offs = (ox * (dc + 1) * (dc + 1) + oy * (dc + 1) + oz).reshape(-1)
    return lattice_idx, (base[:, None] + offs[None, :]).astype(np.int32)


def _smallest(values: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, ties in index order: jax.lax.top_k(-values, k), which keeps
    the lower index of equal keys. torch.topk promises no order among
    ties; a stable sort does."""
    vals, idx = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _grid_density(points: torch.Tensor) -> int:
    n = points.shape[-2]
    d = round(n ** (1.0 / 3.0))
    if d ** 3 != n:
        raise ValueError(f"points ({n}) is not a cube grid")
    return d


def cell_scores(sel_fn, latent, points, factor: int) -> torch.Tensor:
    """(..., Nc) score of each coarse cell: 0 where its corner SDFs change
    sign (the surface crosses it), else its smallest |corner sdf|. The
    (d/factor+1)^3 corner lattice is one set shared by every crop: with
    (B, L) latents one decode ranks it for all of them."""
    d = _grid_density(points)
    lattice_np, cell2corner_np = _cell_corner_lattice_np(d, factor)
    dev = points.device
    lattice = torch.as_tensor(lattice_np, device=dev, dtype=torch.long)
    with torch.no_grad():
        corner_sdf = sel_fn(latent.detach(), points[lattice]).reshape(
            *latent.shape[:-1], -1).float()
    cs = corner_sdf[..., torch.as_tensor(cell2corner_np, device=dev,
                                         dtype=torch.long)]
    crosses = (cs.amin(-1) < 0) & (cs.amax(-1) > 0)
    return torch.where(crosses, torch.zeros_like(cs[..., 0]),
                       cs.abs().amin(-1))


def _coarse_cell_candidates(sel_fn, latent, points, factor: int,
                            coarse_cells: int, pool: int) -> torch.Tensor:
    """Grid indices (..., coarse_cells * factor^3) of the points of the
    `coarse_cells` cells of least cell_scores, cell-major, ties in index
    order. Raises when `pool` (the capacity or the candidate count asked
    for) exceeds the cells' points."""
    children_np = _cell_children_np(_grid_density(points), factor)
    coarse_cells = min(coarse_cells, children_np.shape[0])
    if pool > coarse_cells * children_np.shape[1]:
        raise ValueError(f"{pool} points asked for exceed the coarse "
                         f"candidate pool {coarse_cells}*"
                         f"{children_np.shape[1]}")
    _, cell_idx = _smallest(cell_scores(sel_fn, latent, points, factor),
                            coarse_cells)
    children = torch.as_tensor(children_np, device=points.device,
                               dtype=torch.long)
    return children[cell_idx].reshape(*cell_idx.shape[:-1], -1)


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
    abs_sel, idx = _smallest(sdf.abs(), capacity)
    pts = projected[idx]
    return SurfacePoints(points=pts, nocs=(pts + 1.0) / 2.0,
                         normals=normals_unit[idx], mask=abs_sel < threshold)


def _select(sel_fn, latent, points, k) -> torch.Tensor:
    """Indices of the k smallest |sdf| (no gradient: selection only), per
    crop for (B, L) latents."""
    with torch.no_grad():
        sdf = sel_fn(latent.detach(), points).reshape(
            *latent.shape[:-1], -1).float()
    return _smallest(sdf.abs(), k)[1]


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
    the decode and the autograd normals; with (B, L) latents it takes
    every crop's (B, K, 3) points at once (kernels 4a and 4b: one launch
    each for all crops)."""
    pts_sel = pts_sel.detach()
    if stage2_fn is not None:
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
                         threshold: float = 0.03,
                         coarse_cells: int | None = None,
                         coarse_factor: int = 2, select_decoder_fn=None,
                         stage2_fn=None
                         ) -> tuple[SurfacePoints, torch.Tensor]:
    """Two-stage decode: stage 1 ranks the whole grid without gradients
    (through `select_decoder_fn` when given, e.g. the selection kernel),
    stage 2 decodes the `capacity` selected points exactly (through
    `stage2_fn` when given). With `coarse_cells`, stage 1 ranks only the
    points of the best cells (_coarse_cell_candidates; a budget of at
    least the cell count ranks every point) and raises when `capacity`
    exceeds them. Returns (surface, stage-1 sdf of the ranked points, the
    candidates' in cell-major order under coarse_cells)."""
    sel_fn = select_decoder_fn if select_decoder_fn is not None \
        else decoder_fn
    if coarse_cells is not None:
        cand = _coarse_cell_candidates(sel_fn, latent, points,
                                       coarse_factor, coarse_cells,
                                       capacity)
        points = points[cand]
    with torch.no_grad():
        sdf_all = sel_fn(latent.detach(), points).reshape(
            *latent.shape[:-1], -1).float()
    _, idx = _smallest(sdf_all.abs(), capacity)
    return _stage2_surface(decoder_fn, latent, _take(points, idx), threshold,
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
                    n_candidates: int, coarse_cells: int | None = None,
                    coarse_factor: int = 2) -> torch.Tensor:
    """Full-grid selection pass: the `n_candidates` indices with smallest
    |sdf| — the warm band's refresh. With `coarse_cells` (the composed
    refresh) only the points of the best cells are ranked; the indices
    still index the full grid."""
    if coarse_cells is None:
        return _select(decoder_fn, latent, points, n_candidates)
    cand = _coarse_cell_candidates(decoder_fn, latent, points, coarse_factor,
                                   coarse_cells, n_candidates)
    idx = _select(decoder_fn, latent, points[cand], n_candidates)
    return torch.take_along_dim(cand, idx, dim=-1)
