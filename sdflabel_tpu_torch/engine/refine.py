"""Pose/shape refinement engine: the reference's hot loop, eagerly.

Counterpart of sdflabel_tpu/engine/refine.py (reference optimizer.py:13-164).
Parameters {yaw, trans, scale, latent}; Adam for yaw and for trans, SGD
for scale and for latent, each in its own parameter group (QUIRKS #7).
Each iteration: scene / scale, pose from yaw with the Y row flipped, the
latent renormalized to the unit sphere, the band selection (warm-started
in the stock config), the exact stage-2 decode with autograd normals, the
surfel render, the 3D NN loss plus the 2D NOCS loss, and the step behind
the NaN/zero guard. The JAX ``lax.scan`` becomes a Python loop.

``make_refine_batch_fn`` refines B crops at once, as ``jax.vmap`` of the
JAX refine does (parallel/batched_refine.py builds on it): one iteration
body serves both, with a leading crop axis on every tensor. The guard is
per crop, and so is the optimizer state: optax keeps Adam's step count as a
lane of its state and ``jnp.where(ok, new, old)`` freezes a guarded crop's
count and moments, which ``torch.optim.Adam`` (one count per tensor) cannot
express. Both loops therefore step through ``batch_step``, optax's Adam
and SGD arithmetic written out (the sequential loop on a crop axis of one;
torch.optim.Adam's update rounds another way, and the refine carries an
ulp to centimetres), and neither reads anything back to the host inside
the loop. Under a profiler both mark each iteration and its refresh,
forward pass, backward pass and step as spans (utils/profiling.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from sdflabel_tpu_torch.engine import losses
from sdflabel_tpu_torch.ops import geometry, grid as grid_ops
from sdflabel_tpu_torch.renderer import rasterer as rast_mod
from sdflabel_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    iters: int = 60  # config_refine.ini [optimization] iters
    weight_2d: float = 0.3  # [losses] 2d_weight
    weight_3d: float = 0.5  # [losses] 3d_weight
    lr_yaw: float = 0.01  # optimizer.py:34
    lr_trans: float = 0.01  # optimizer.py:36
    lr_scale: float = 0.01  # optimizer.py:37
    lr_latent: float = 3e-5  # optimizer.py:38
    surface_capacity: int = 4096
    surface_threshold: float = 0.03  # grid.py:43
    # Opt-in coarse-to-fine selection each iteration: only the points of
    # the `coarse_cells` best cells of coarse_factor^3 points are ranked
    # (ops/grid.py::surface_from_decoder). None = every grid point.
    coarse_cells: int | None = None
    coarse_factor: int = 2
    # Warm-started band selection: every `warm_refresh` iterations the full
    # grid is ranked for the `warm_band` smallest |sdf| candidates; between
    # refreshes the band comes from those candidates only. 0 = exact
    # full-grid selection each iteration.
    warm_band: int = 0
    warm_refresh: int = 10
    # The composed refresh: the warm refresh ranks only the points of this
    # many coarse cells (needs warm_band <= cells * coarse_factor^3).
    # None = the full grid.
    warm_refresh_cells: int | None = None
    loss3d_threshold: float = 0.2  # optimizer.py:166
    loss2d_diam: float = 5.0  # optimizer.py:200
    loss2d_threshold: float = 1.0  # optimizer.py:200


class RefineParams(NamedTuple):
    """One crop's parameters; the batched loop's lead with a crop axis."""

    yaw: torch.Tensor  # (1,)
    trans: torch.Tensor  # (3,)
    scale: torch.Tensor  # (1,)
    latent: torch.Tensor  # (L,)


class RefineStepOut(NamedTuple):
    """Per-iteration history, stacked over iterations."""

    loss: torch.Tensor
    loss_2d: torch.Tensor
    loss_3d: torch.Tensor
    applied: torch.Tensor  # False where the NaN/zero guard skipped the step
    params: RefineParams  # parameters USED by each iteration (pre-update)


def build_render_pose(yaw: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """4x4 render pose: rotation from yaw with its Y row flipped, then the
    translation, whose y keeps its sign (optimizer.py:87-90). (B, 1) yaws
    and (B, 3) translations give (B, 4, 4)."""
    rot = geometry.rot_from_yaw(yaw).to(trans.dtype)
    rot = rot * torch.tensor([1.0, -1.0, 1.0], device=trans.device,
                             dtype=trans.dtype)[:, None]
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=trans.device,
                          dtype=trans.dtype).expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def _normalize_latent(latent: torch.Tensor) -> torch.Tensor:
    # F.normalize (optimizer.py:96) with a NaN-free gradient at zero, per
    # crop
    return latent / torch.sqrt(torch.clamp(
        latent.square().sum(-1, keepdim=True), min=1e-24))


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the CPU")
    return device


def _check_warm(cfg: RefineConfig) -> bool:
    """Whether the warm band is on; raises on an unusable setting."""
    if cfg.warm_band <= 0:
        return False
    if cfg.warm_band < cfg.surface_capacity:
        raise ValueError(f"warm_band {cfg.warm_band} must be >= "
                         f"surface_capacity {cfg.surface_capacity}")
    if cfg.coarse_cells is not None:
        raise ValueError("warm_band and coarse_cells are alternative "
                         "selection accelerations; enable at most one (the "
                         "composed refresh is warm_refresh_cells)")
    if cfg.warm_refresh < 1:
        raise ValueError(f"warm_refresh must be >= 1 (got "
                         f"{cfg.warm_refresh})")
    return True


def _refresh(sel, cfg: RefineConfig, latent, grid_points):
    """The warm band's candidates for the current latent, selection only
    (outside the gradient): over the full grid, or through the coarse
    cells with warm_refresh_cells."""
    return grid_ops.band_candidates(
        sel, _normalize_latent(latent), grid_points, cfg.warm_band,
        coarse_cells=cfg.warm_refresh_cells,
        coarse_factor=cfg.coarse_factor)


def _make_iteration(sdf_decoder, cfg: RefineConfig, grid_points, crop_hw,
                    select_decoder, stage2_fn):
    """One iteration's loss, for one crop or for a crop axis on every
    argument: iteration(params, K, nocs_target, frustum_pts, frustum_mask,
    pixel_mask, cand_idx) -> (loss, loss_2d, loss_3d)."""
    h, w = crop_hw
    use_warm = cfg.warm_band > 0

    def iteration(params: RefineParams, K, nocs_target, frustum_pts,
                  frustum_mask, pixel_mask, cand_idx):
        scene = frustum_pts / params.scale[..., None, :]
        pose = build_render_pose(params.yaw, params.trans)
        latent = _normalize_latent(params.latent)
        if use_warm:
            surf = grid_ops.surface_from_candidates(
                sdf_decoder, latent, grid_points, cand_idx,
                capacity=cfg.surface_capacity,
                threshold=cfg.surface_threshold,
                select_decoder_fn=select_decoder, stage2_fn=stage2_fn)
        else:
            surf, _ = grid_ops.surface_from_decoder(
                sdf_decoder, latent, grid_points,
                capacity=cfg.surface_capacity,
                threshold=cfg.surface_threshold,
                coarse_cells=cfg.coarse_cells,
                coarse_factor=cfg.coarse_factor,
                select_decoder_fn=select_decoder, stage2_fn=stage2_fn)
        rendering, points = rast_mod.render(
            K, (w, h), surf.points, surf.normals, surf.normals, pose,
            point_mask=surf.mask, rot="dcm", primitives="disc",
            output_nocs=True)
        l3d = losses.loss_3d(points.xyz, points.front_mask, scene,
                             frustum_mask, params.scale,
                             threshold=cfg.loss3d_threshold)
        l2d = losses.loss_2d(rendering.color, nocs_target,
                             diam=cfg.loss2d_diam,
                             threshold_nocs=cfg.loss2d_threshold,
                             pixel_mask=pixel_mask)
        return cfg.weight_3d * l3d + cfg.weight_2d * l2d, l2d, l3d

    return iteration


def make_refine_fn(sdf_decoder, cfg: RefineConfig, grid_points: torch.Tensor,
                   K: torch.Tensor, crop_hw: tuple[int, int],
                   select_decoder=None, stage2_fn=None, device="cuda"):
    """Build refine(params0, nocs_target, frustum_pts, frustum_mask,
    pixel_mask=None) -> (final RefineParams, RefineStepOut) for one crop
    geometry.

    sdf_decoder(latent, points) -> (N,) sdf, differentiable; select_decoder:
    optional rank-only decoder for the selection passes (the selection
    kernel); stage2_fn: optional fused stage-2 decode and normals
    (ops/mlp2_cuda.py). nocs_target (3, h, w); frustum (M, 3) with its
    (M,) mask.
    """
    device = _device(device)
    h, w = crop_hw
    use_warm = _check_warm(cfg)
    grid_points = grid_points.to(device)
    K = torch.as_tensor(K, dtype=torch.float32).to(device)
    sel = select_decoder if select_decoder is not None else sdf_decoder
    iteration = _make_iteration(sdf_decoder, cfg, grid_points, crop_hw,
                                select_decoder, stage2_fn)

    def refine(params0: RefineParams, nocs_target, frustum_pts,
               frustum_mask, pixel_mask=None):
        params = RefineParams(*(torch.as_tensor(p, dtype=torch.float32)
                                .to(device).detach().clone()
                                for p in params0))
        nocs_target = torch.as_tensor(nocs_target).to(device)
        frustum_pts = torch.as_tensor(frustum_pts).to(device)
        frustum_mask = torch.as_tensor(frustum_mask).to(device).bool()
        if pixel_mask is None:
            pixel_mask = torch.ones(h, w, dtype=torch.bool, device=device)
        pixel_mask = torch.as_tensor(pixel_mask).to(device).bool()
        # optax's Adam and SGD arithmetic (batch_step on a crop axis of
        # one), as JAX steps: torch.optim.Adam rounds its update another
        # way, an ulp a step that the refine can carry to centimetres
        state = init_batch_opt_state(RefineParams(*(p[None]
                                                    for p in params)))
        cand_idx = None
        hist = []
        for it in range(cfg.iters):
            with span("refine.iteration"):
                if use_warm and it % cfg.warm_refresh == 0:
                    with span("refine.refresh"):
                        cand_idx = _refresh(sel, cfg, params.latent,
                                            grid_points)
                leaves = RefineParams(*(p.requires_grad_(True)
                                        for p in params))
                with span("refine.forward"):
                    loss, l2d, l3d = iteration(
                        leaves, K, nocs_target, frustum_pts, frustum_mask,
                        pixel_mask, cand_idx)
                with span("refine.backward"):
                    grads = torch.autograd.grad(loss, list(leaves),
                                                allow_unused=True)
                with span("refine.step"):
                    params = RefineParams(*(p.detach() for p in leaves))
                    # NaN / zero-loss guard (optimizer.py:149-151): no step
                    # at all, so neither the parameters nor the optimizer
                    # state move; on the card, without a host read
                    ok = torch.isfinite(loss) & (loss != 0.0)
                    hist.append((loss.detach(), l2d.detach(), l3d.detach(),
                                 ok, params))
                    new, state = batch_step(
                        cfg, RefineParams(*(p[None] for p in params)),
                        [(torch.zeros_like(p) if g is None else g)[None]
                         for p, g in zip(params, grads)], ok[None], state)
                    params = RefineParams(*(p[0] for p in new))
        return params, RefineStepOut(
            loss=torch.stack([x[0] for x in hist]),
            loss_2d=torch.stack([x[1] for x in hist]),
            loss_3d=torch.stack([x[2] for x in hist]),
            applied=torch.stack([x[3] for x in hist]),
            params=RefineParams(*(torch.stack([x[4][i] for x in hist])
                                  for i in range(4))))

    return refine


class BatchOptState(NamedTuple):
    """optax's state of make_optimizer for B crops: Adam's `count` is one
    lane per crop, as under vmap; SGD keeps none."""

    count: torch.Tensor  # (B,) int32, the Adam steps each crop has taken
    mu: tuple  # Adam's first moments of (yaw, trans)
    nu: tuple  # Adam's second moments of (yaw, trans)


def init_batch_opt_state(params: RefineParams) -> BatchOptState:
    zeros = tuple(torch.zeros_like(p) for p in params[:2])
    return BatchOptState(torch.zeros(params.yaw.shape[0], dtype=torch.int32,
                                     device=params.yaw.device), zeros, zeros)


def batch_step(cfg: RefineConfig, params: RefineParams, grads, ok,
               state: BatchOptState) -> tuple[RefineParams, BatchOptState]:
    """One guarded step of B crops, as the JAX step under vmap: a leaf
    whose gradient is not all finite in a crop steps on zero; Adam(yaw),
    Adam(trans) (optax scale_by_adam, then scale(-lr)) and SGD(scale),
    SGD(latent); then crops where `ok` (B,) is False keep their parameters
    and their whole optimizer state, count included."""
    grads = [torch.where((ok & torch.isfinite(g).all(-1))[:, None], g,
                         torch.zeros_like(g)) for g in grads]
    b1, b2, eps = 0.9, 0.999, 1e-8
    count = state.count + 1
    bc1 = (1.0 - b1 ** count.float())[:, None]
    bc2 = (1.0 - b2 ** count.float())[:, None]
    mu = tuple((1.0 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
    nu = tuple((1.0 - b2) * (g * g) + b2 * v
               for g, v in zip(grads, state.nu))
    updates = [(m / bc1) / (torch.sqrt(v / bc2) + eps) * -lr
               for m, v, lr in zip(mu, nu, (cfg.lr_yaw, cfg.lr_trans))]
    updates += [g * -lr for g, lr in zip(grads[2:],
                                         (cfg.lr_scale, cfg.lr_latent))]
    keep = ok[:, None]
    new = RefineParams(*(torch.where(keep, p + u, p)
                         for p, u in zip(params, updates)))
    return new, BatchOptState(
        torch.where(ok, count, state.count),
        tuple(torch.where(keep, a, o) for a, o in zip(mu, state.mu)),
        tuple(torch.where(keep, a, o) for a, o in zip(nu, state.nu)))


def make_refine_batch_fn(sdf_decoder, cfg: RefineConfig,
                         grid_points: torch.Tensor, crop_hw: tuple[int, int],
                         select_decoder=None, stage2_fn=None, device="cuda"):
    """Build refine_batch(params0, K, nocs_target, frustum_pts,
    frustum_mask, pixel_mask) -> (final RefineParams, RefineStepOut) for B
    crops of one render bucket `crop_hw`: the counterpart of ``jax.vmap``
    over the JAX refine (parallel/batched_refine.py).

    Every argument carries a leading crop axis: RefineParams of (B, 1),
    (B, 3), (B, 1), (B, L); K (B, 3, 3), each crop's own intrinsics;
    nocs_target (B, 3, h, w); frustum (B, M, 3) with its (B, M) mask;
    pixel_mask (B, h, w), required. The result's leaves are (B, ·) and the
    history's (B, iters, ·), as vmap's. Per crop, the guard (a finite,
    nonzero loss; a leaf whose gradient is not all finite steps on zero)
    and the optimizer state are the sequential loop's; the warm refresh
    (`it % warm_refresh == 0`) is the same for every crop, as under vmap.
    """
    device = _device(device)
    use_warm = _check_warm(cfg)
    grid_points = grid_points.to(device)
    sel = select_decoder if select_decoder is not None else sdf_decoder
    iteration = _make_iteration(sdf_decoder, cfg, grid_points, crop_hw,
                                select_decoder, stage2_fn)

    def refine_batch(params0: RefineParams, K, nocs_target, frustum_pts,
                     frustum_mask, pixel_mask):
        params = RefineParams(*(torch.as_tensor(p, dtype=torch.float32)
                                .to(device).detach().clone()
                                for p in params0))
        K = torch.as_tensor(K, dtype=torch.float32).to(device)
        nocs_target = torch.as_tensor(nocs_target).to(device)
        frustum_pts = torch.as_tensor(frustum_pts).to(device)
        frustum_mask = torch.as_tensor(frustum_mask).to(device).bool()
        pixel_mask = torch.as_tensor(pixel_mask).to(device).bool()
        state = init_batch_opt_state(params)
        cand_idx = None
        hist = []
        for it in range(cfg.iters):
            with span("refine.iteration"):
                if use_warm and it % cfg.warm_refresh == 0:
                    with span("refine.refresh"):
                        cand_idx = _refresh(sel, cfg, params.latent,
                                            grid_points)
                leaves = RefineParams(*(p.requires_grad_(True)
                                        for p in params))
                with span("refine.forward"):
                    loss, l2d, l3d = iteration(
                        leaves, K, nocs_target, frustum_pts, frustum_mask,
                        pixel_mask, cand_idx)
                with span("refine.backward"):
                    # crops do not couple: the gradient of the sum is each
                    # crop's
                    grads = torch.autograd.grad(loss.sum(), list(leaves),
                                                allow_unused=True)
                with span("refine.step"):
                    params = RefineParams(*(p.detach() for p in leaves))
                    grads = [torch.zeros_like(p) if g is None else g
                             for p, g in zip(params, grads)]
                    # the guard, per crop and on the card: no host read
                    ok = torch.isfinite(loss) & (loss != 0.0)
                    hist.append((loss.detach(), l2d.detach(), l3d.detach(),
                                 ok, params))
                    params, state = batch_step(cfg, params, grads, ok,
                                               state)
        return params, RefineStepOut(
            loss=torch.stack([x[0] for x in hist], 1),
            loss_2d=torch.stack([x[1] for x in hist], 1),
            loss_3d=torch.stack([x[2] for x in hist], 1),
            applied=torch.stack([x[3] for x in hist], 1),
            params=RefineParams(*(torch.stack([x[4][i] for x in hist], 1)
                                  for i in range(4))))

    return refine_batch


def init_refine_params(yaw: float, trans, scale: float, latent,
                       device="cpu") -> RefineParams:
    """Pack initial values; `trans` is already divided by scale
    (refine_css.py:192-196)."""
    def t(x, n):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=device).reshape(n)
    return RefineParams(yaw=t(yaw, 1), trans=t(trans, 3), scale=t(scale, 1),
                        latent=t(latent, -1))
