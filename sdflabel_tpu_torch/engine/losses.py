"""Refinement losses: 3D chamfer-to-LIDAR and projective 2D NOCS loss.

Counterpart of sdflabel_tpu/engine/losses.py (reference
Optimizer.compute_loss_3d / compute_loss_2d, optimizer.py:166-237). Shapes
stay fixed: the nearest neighbour is the streaming kernel 2 on the card
(ops/knn.py) and the reference's dynamic pixel gathers are dense masked
reductions. An empty 2D mean is NaN, as in the reference (QUIRKS #6); the
refine step's guard then skips the update. Every loss also takes a leading
crop axis (the batched driver) and gives one loss per crop, each crop with
its own pixel mask, nearest neighbours and NaN, as ``jax.vmap`` of the JAX
losses does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sdflabel_tpu_torch.ops import knn


def loss_3d(rendered_pts: torch.Tensor, rendered_mask: torch.Tensor,
            frustum_pts: torch.Tensor, frustum_mask: torch.Tensor,
            scale: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Mean distance of close NN pairs rendered -> frustum. `frustum_pts`
    is already divided by scale, so the scale gradient flows through it
    (optimizer.py:84); the threshold uses the detached scale. With a crop
    axis: (B, N, 3) / (B, N) rendered, (B, M, 3) / (B, M) frustum and
    (B, 1) scales -> (B,)."""
    total, cnt = loss_3d_terms(rendered_pts, rendered_mask, frustum_pts,
                               frustum_mask, scale, threshold)
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1),
                       torch.zeros_like(total))


def loss_3d_terms(rendered_pts, rendered_mask, frustum_pts, frustum_mask,
                  scale, threshold: float = 0.2):
    """(sum, count) partials of loss_3d."""
    dists, idxs = knn.nearest_neighbor(rendered_pts.detach(),
                                       frustum_pts.detach(), frustum_mask)
    thresh = threshold / scale.detach()  # (1,) or one per crop (B, 1)
    close = (dists < thresh) & rendered_mask
    if frustum_pts.dim() == 2:
        nn_pts = frustum_pts[idxs]
    else:  # each crop's own frustum
        crop = torch.arange(frustum_pts.shape[0],
                            device=frustum_pts.device)[:, None]
        nn_pts = frustum_pts[crop, idxs]
    d2 = (nn_pts - rendered_pts).square().sum(-1)
    # double-where guards sqrt(0): its gradient would be NaN
    safe = d2 > 0
    pair_d = torch.where(safe, torch.sqrt(torch.where(safe, d2,
                                                      torch.ones_like(d2))),
                         torch.zeros_like(d2))
    cnt = close.sum(-1)
    total = torch.where(close, pair_d, torch.zeros_like(pair_d)).sum(-1)
    return total, cnt


def disc_offsets(diam: float):
    """(radius, integer offsets strictly inside the disc, their weights
    diam - |offset|): the one enumeration of the windowed 2D loss."""
    radius = int(math.ceil(diam)) - 1
    offsets = [(dy, dx) for dy in range(-radius, radius + 1)
               for dx in range(-radius, radius + 1)
               if dy * dy + dx * dx < diam * diam]
    wgts = [diam - math.sqrt(dy * dy + dx * dx) for dy, dx in offsets]
    return radius, offsets, wgts


def _sqrt_guarded(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x,
                                                   torch.ones_like(x))),
                       torch.zeros_like(x))


def loss_2d(rendering_nocs: torch.Tensor, css_nocs: torch.Tensor,
            diam: float = 5.0, threshold_nocs: float = 1.0,
            pixel_mask: torch.Tensor | None = None,
            windowed: bool | None = None) -> torch.Tensor:
    """Projective NOCS loss (optimizer.py:200-237) on (3, H, W) images.

    For every nonzero rendered pixel r: the minimum over CSS pixels p of
    ||css[p] * clamp(diam - |p - r|, 0) - rendered[r]||, averaged over the
    r whose minimum is below `threshold_nocs` (NaN when none is). Padded
    pixels (pixel_mask False) take part on neither side. `windowed`: None
    = auto (windowed above 64x64), else force the O(K^2 P) windowed or the
    dense O(P^2) form; both compute the same function. With a crop axis,
    (B, 3, H, W) images and (B, H, W) masks give (B,) losses."""
    c, h, w = rendering_nocs.shape[-3:]
    batch = rendering_nocs.shape[:-3]
    if windowed is None:
        windowed = h * w > 64 * 64
    if windowed:
        return _loss_2d_windowed(rendering_nocs, css_nocs, diam,
                                 threshold_nocs, pixel_mask)
    p = h * w
    rend = rendering_nocs.reshape(*batch, c, p).transpose(-1, -2)
    css = css_nocs.reshape(*batch, c, p).transpose(-1, -2)
    nonzero = rend.sum(-1) != 0
    if pixel_mask is not None:
        pm = pixel_mask.reshape(*batch, p).bool()
        nonzero = nonzero & pm
    dev, dt = rendering_nocs.device, rendering_nocs.dtype
    gy, gx = torch.meshgrid(torch.arange(h, device=dev, dtype=dt),
                            torch.arange(w, device=dev, dtype=dt),
                            indexing="ij")
    pix = torch.stack([gy.reshape(-1), gx.reshape(-1)], -1)
    d = torch.sqrt(knn.pairwise_sq_dists(pix, pix))
    wgt = torch.clamp(diam - d, min=0.0)
    css_sq = (css * css).sum(-1)
    rend_sq = (rend * rend).sum(-1)
    cross = rend @ css.transpose(-1, -2)
    diff_sq = wgt * wgt * css_sq[..., None, :] - 2.0 * wgt * cross \
        + rend_sq[..., :, None]
    diff = _sqrt_guarded(diff_sq)
    if pixel_mask is not None:
        diff = torch.where(pm[..., None, :], diff,
                           torch.full_like(diff, float("inf")))
    diff_min = diff.min(-1).values
    sel = nonzero & (diff_min < threshold_nocs)
    mean = torch.where(sel, diff_min, torch.zeros_like(diff_min)).sum(-1) \
        / sel.sum(-1)  # NaN when nothing is selected
    return torch.where(nonzero.any(-1), mean, torch.zeros_like(mean))


def _loss_2d_windowed(rendering_nocs, css_nocs, diam, threshold_nocs,
                      pixel_mask):
    """loss_2d as shifted copies of the CSS image, one per in-disc offset,
    plus the single zero-weight fallback candidate ||rend[r]||."""
    c, h, w = rendering_nocs.shape[-3:]
    batch = rendering_nocs.shape[:-3]
    dev, dt = rendering_nocs.device, rendering_nocs.dtype
    radius, offsets, wgts_list = disc_offsets(diam)
    wgts = torch.tensor(wgts_list, device=dev, dtype=dt)
    valid = (torch.ones(*batch, h, w, dtype=torch.bool, device=dev)
             if pixel_mask is None
             else pixel_mask.reshape(*batch, h, w).bool())
    css_pad = F.pad(css_nocs, (radius, radius, radius, radius))
    val_pad = F.pad(valid, (radius, radius, radius, radius))
    css_sh = torch.stack([
        css_pad[..., radius + dy:radius + dy + h, radius + dx:radius + dx + w]
        for dy, dx in offsets], dim=-4)  # (..., O, 3, H, W)
    val_sh = torch.stack([
        val_pad[..., radius + dy:radius + dy + h, radius + dx:radius + dx + w]
        for dy, dx in offsets], dim=-3)  # (..., O, H, W)
    rend_sq = (rendering_nocs * rendering_nocs).sum(-3)
    css_sq_sh = (css_sh * css_sh).sum(-3)
    cross_sh = (css_sh * rendering_nocs[..., None, :, :, :]).sum(-3)
    wv = wgts[:, None, None]
    diff_sq = wv * wv * css_sq_sh - 2.0 * wv * cross_sh \
        + rend_sq[..., None, :, :]
    inf = torch.full_like(diff_sq, float("inf"))
    win_min_sq = torch.where(val_sh, diff_sq, inf).min(-3).values
    has_fallback = valid.sum((-2, -1))[..., None, None] > val_sh.sum(-3)
    fb_sq = torch.where(has_fallback, rend_sq,
                        torch.full_like(rend_sq, float("inf")))
    min_sq = torch.minimum(win_min_sq, fb_sq)
    finite = torch.isfinite(min_sq)
    pos = (min_sq > 0) & finite
    diff_min = torch.where(
        pos, torch.sqrt(torch.where(pos, min_sq, torch.ones_like(min_sq))),
        torch.where(finite, torch.zeros_like(min_sq),
                    torch.full_like(min_sq, float("inf"))))
    nonzero = (rendering_nocs.sum(-3) != 0) & valid
    sel = nonzero & (diff_min < threshold_nocs)
    mean = torch.where(sel, diff_min, torch.zeros_like(diff_min)).sum(
        (-2, -1)) / sel.sum((-2, -1))
    return torch.where(nonzero.flatten(-2).any(-1), mean,
                       torch.zeros_like(mean))
