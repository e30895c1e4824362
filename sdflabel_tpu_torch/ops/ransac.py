"""RANSAC pose initialization from NOCS correspondences.

Counterpart of sdflabel_tpu/ops/ransac.py (reference utils/pose.py:84-356,
init_pose_3d with kabsch / procrustes steps). All hypotheses are fitted as
one batch of 3x3 SVDs. Both nearest-neighbour searches, the per-scene-point
colour match (pose.py:146-149) and the inlier scoring of every hypothesis
(pose.py:174-197), go through ops/knn.py, so on the card they are the
streaming kernel 2: the scoring is one launch over hypotheses x scene
points. The winning hypothesis's inliers are fitted again model -> scene
(pose.py:200-233).

The JAX package draws hypotheses with jax.random, which torch cannot
reproduce; ``ransac_pose`` therefore takes the (H, S) ranks as an optional
argument and otherwise draws the same shifted-uniform scheme from a
torch.Generator.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sdflabel_tpu_torch.ops import knn


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    num_hypotheses: int = 567  # pose.py:127-134: p=.99, outliers .7, n=4
    sample_size: int = 4
    metric_threshold: float = 0.15  # pose.py:91
    nocs_threshold: float = 0.15  # pose.py:92
    min_inliers: int = 5  # pose.py:135
    max_scale: float = 3.0  # pose.py:168


class RansacPose(NamedTuple):
    scale: torch.Tensor  # ()
    rot: torch.Tensor  # (3, 3)
    tra: torch.Tensor  # (3,)
    num_inliers: torch.Tensor  # () int; < min_inliers means no pose
    inlier_mask: torch.Tensor  # (N,)


def _flip_last_row(vt: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    factor = torch.ones_like(vt)
    factor[..., -1, :] = sign[..., None]
    return vt * factor


def kabsch(canonical: torch.Tensor, predicted: torch.Tensor):
    """Rigid alignment canonical -> predicted (pose.py:325-356), batched:
    returns (R, t) with x_pred ~= R @ x_canon + t."""
    cm = canonical.mean(-2, keepdim=True)
    pm = predicted.mean(-2, keepdim=True)
    cross = (predicted - pm).transpose(-1, -2) @ (canonical - cm)
    u, _, vt = torch.linalg.svd(cross)
    det = torch.linalg.det(u @ vt)
    vt = _flip_last_row(vt, torch.where(det < 0, -1.0, 1.0))
    rot = u @ vt
    t = pm[..., 0, :] - cm[..., 0, :]
    t = (torch.einsum("...ij,...j->...i", rot, t)
         - torch.einsum("...ij,...j->...i", rot, pm[..., 0, :])
         + pm[..., 0, :])
    return rot, t


def procrustes(from_pts: torch.Tensor, to_pts: torch.Tensor,
               eps: float = 1e-9):
    """Similarity alignment (pose.py:281-322), batched: (c, R, t, valid)."""
    n = from_pts.shape[-2]
    mf = from_pts.mean(-2, keepdim=True)
    mt = to_pts.mean(-2, keepdim=True)
    df = from_pts - mf
    dt = to_pts - mt
    sigma_from = (df * df).sum(-1).mean(-1)
    cov = dt.transpose(-1, -2) @ df / n
    u, d, vt = torch.linalg.svd(cov)
    tol = d[..., :1] * 3 * torch.finfo(d.dtype).eps  # numpy matrix_rank
    rank = (d > tol).sum(-1)
    det = torch.linalg.det(cov)
    s_last = torch.where((rank >= 2) & (det < 0), -1.0, 1.0)
    vt = _flip_last_row(vt, s_last)
    rot = u @ vt
    sdiag = torch.cat([torch.ones_like(d[..., :2]), s_last[..., None]], -1)
    c = (d * sdiag).sum(-1) / torch.clamp(sigma_from, min=eps)
    t = mt[..., 0, :] - c[..., None] * torch.einsum(
        "...ij,...j->...i", rot, mf[..., 0, :])
    return c, rot, t, rank >= 2


def draw_ranks(num_valid: int, cfg: RansacConfig,
               generator: torch.Generator) -> torch.Tensor:
    """(H, S) distinct ranks < num_valid per hypothesis (when num_valid >=
    S): the j-th pick is uniform over the num_valid - j remaining ranks,
    shifted past the earlier picks in ascending order (the JAX package's
    draw_distinct scheme). Drawn on the generator's device."""
    h, s = cfg.num_hypotheses, cfg.sample_size
    dev = generator.device
    u = torch.rand(h, s, generator=generator, dtype=torch.float64,
                   device=dev)
    widths = torch.clamp(num_valid - torch.arange(s, device=dev), min=1)
    r = torch.minimum((u * widths).long(), widths - 1)
    cols = [r[:, 0]]
    for j in range(1, s):
        rj = r[:, j]
        prev = torch.sort(torch.stack(cols, 1), dim=1).values
        for t in range(j):
            rj = rj + (rj >= prev[:, t]).long()
        cols.append(rj)
    return torch.stack(cols, 1)


def ransac_pose(model_pts, model_cls, model_mask, scene_pts, scene_cls,
                scene_mask, ranks: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                method: str = "kabsch", scale_model: float = 1.0,
                cfg: RansacConfig = RansacConfig()) -> RansacPose:
    """SE(3) (+ scale under procrustes) from NOCS correspondences. Arrays
    are fixed-capacity with masks; `ranks` (H, S) index the valid scene
    points (see the module note). With kabsch the model is pre-scaled by
    `scale_model` (pose.py:121)."""
    dev, dtype = scene_pts.device, scene_pts.dtype
    if method == "kabsch":
        model_pts = model_pts * scale_model
    h = cfg.num_hypotheses
    n = scene_pts.shape[0]

    color_d, color_idx = knn.nearest_neighbor(scene_cls, model_cls,
                                              model_mask)
    corr_pts = model_pts[color_idx]

    valid_order = torch.argsort((~scene_mask.bool()).to(torch.uint8),
                                stable=True)
    if ranks is None:
        if generator is None:
            raise ValueError("ransac_pose needs `ranks` or a `generator`")
        ranks = draw_ranks(int(scene_mask.sum()), cfg, generator)
    idx = valid_order[torch.as_tensor(ranks, device=dev).long()]  # (H, S)
    eye = torch.eye(cfg.sample_size, dtype=torch.bool, device=dev)
    distinct_ok = ((idx[:, :, None] != idx[:, None, :]) | eye).all(-1).all(-1)

    samp_scene = scene_pts[idx]
    samp_corr = corr_pts[idx]
    color_ok = (color_d[idx] <= cfg.nocs_threshold).all(-1)

    if method == "procrustes":
        c, rot, tra, fit_ok = procrustes(samp_scene, samp_corr)
        fit_ok = fit_ok & (c <= cfg.max_scale)
        scale_h = c
    else:
        rot, tra = kabsch(samp_scene, samp_corr)
        scale_h = torch.ones(h, device=dev, dtype=dtype)
        fit_ok = torch.ones(h, dtype=torch.bool, device=dev)
    hyp_ok = color_ok & fit_ok & distinct_ok

    # score: every hypothesis's transformed scene -> model, one NN search
    ts = (torch.einsum("bij,nj->bni", rot * scale_h[:, None, None],
                       scene_pts) + tra[:, None, :])  # (H, N, 3)
    nn_d, nn_idx = knn.nearest_neighbor(ts.reshape(-1, 3), model_pts,
                                        model_mask)
    cd = torch.linalg.norm(scene_cls[None] - model_cls[nn_idx].reshape(
        h, n, 3), dim=-1)
    inliers = ((nn_d.reshape(h, n) < cfg.metric_threshold)
               & (cd < cfg.nocs_threshold) & scene_mask.bool()[None, :])
    counts = torch.where(hyp_ok, inliers.sum(-1), torch.full(
        (h,), -1, device=dev, dtype=torch.long))
    best = torch.argmax(counts)
    best_inliers = inliers[best]

    w = best_inliers.to(dtype)
    wsum = torch.clamp(w.sum(), min=1.0)
    if method == "procrustes":
        mf = (corr_pts * w[:, None]).sum(0) / wsum
        mt = (scene_pts * w[:, None]).sum(0) / wsum
        df = (corr_pts - mf) * torch.sqrt(w)[:, None]
        dt = (scene_pts - mt) * torch.sqrt(w)[:, None]
        sigma_from = (df * df).sum() / wsum
        cov = dt.T @ df / wsum
        u, d, vt = torch.linalg.svd(cov)
        s_last = torch.where(torch.linalg.det(cov) < 0, -1.0, 1.0)
        rot_f = u @ _flip_last_row(vt, s_last)
        sdiag = torch.stack([torch.ones_like(s_last), torch.ones_like(s_last),
                             s_last])
        scale_f = (d * sdiag).sum() / torch.clamp(sigma_from, min=1e-9)
        tra_f = mt - scale_f * (rot_f @ mf)
    else:
        cm = (corr_pts * w[:, None]).sum(0) / wsum
        pm = (scene_pts * w[:, None]).sum(0) / wsum
        cross = (scene_pts - pm).T @ ((corr_pts - cm) * w[:, None])
        u, _, vt = torch.linalg.svd(cross)
        det = torch.linalg.det(u @ vt)
        rot_f = u @ _flip_last_row(vt, torch.where(det < 0, -1.0, 1.0))
        tra_f = rot_f @ (pm - cm) - rot_f @ pm + pm
        scale_f = torch.tensor(scale_model, device=dev, dtype=dtype)
    return RansacPose(scale=scale_f, rot=rot_f, tra=tra_f,
                      num_inliers=counts[best], inlier_mask=best_inliers)
