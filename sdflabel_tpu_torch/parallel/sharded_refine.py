"""One crop's refinement over the ranks of a mesh axis: the grid decode
sharded by points, the render and the 2D loss by pixels.

Counterpart of sdflabel_tpu/parallel/sharded_refine.py. Per iteration,
on each rank of the axis's group:

* stage 1 (the band selection, no gradient) decodes only the rank's block
  of the grid (padded with 1e3 sentinels to a multiple of the ranks),
  keeps its local top-k, all-gathers the candidates in rank order and
  takes the global top-k, ties in index order as ``lax.top_k`` keeps them
  (ops/grid.py::_smallest); with coarse cells the grid is laid out
  cell-major so that each rank owns whole cells, scored from 2 diagonal
  children each (JAX's sharded approximation, not ops/grid.py's 8-corner
  lattice). The warm band (pool == surface_capacity only) runs that
  selection every ``warm_refresh`` iterations on every rank alike;
* stage 2 decodes the rank's slice of the selected points, with autograd
  normals, and all-gathers the slices into the set every rank renders;
* the rank renders its block of pixel rows, scores the 2D loss over it
  and the 3D loss over its slice of points; the (sum, count) partials are
  summed over the ranks (an empty 2D selection stays 0/0 NaN, QUIRKS #6).

Gradient accounting (parallel/mesh.py's convention): each parameter
enters the rank's share through ``from_replicated``, the gathered stage-2
set too, and the partial sums become whole through ``sum_to_replicated``.
Every rank then ends each step with the full gradient, the single-device
loop's, and steps alike through engine/refine.py::batch_step (optax's
arithmetic) behind the same guard. On the card the kernels run on each
rank's share: the splat pair on its pixel block, the NN kernel in its 3D
loss, and the selection kernel on its grid block when it is the
``select_decoder``; on the CPU their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from sdflabel_tpu_torch.engine import losses as losses_mod
from sdflabel_tpu_torch.engine import refine as refine_mod
from sdflabel_tpu_torch.ops import grid as grid_ops
from sdflabel_tpu_torch.ops import knn
from sdflabel_tpu_torch.ops import splat as splat_ops
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.ops.projection import project_dcm
from sdflabel_tpu_torch.parallel import mesh as mesh_mod


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def make_sharded_refine_fn(sdf_decoder, cfg: refine_mod.RefineConfig,
                           grid_points, K, crop_hw: tuple[int, int],
                           mesh: mesh_mod.Mesh, axis: str = "rays",
                           windowed_2d: bool | None = None,
                           select_decoder=None, device="cuda"):
    """Build refine(params0, nocs_target (3, h, w), frustum (M, 3),
    fmask (M,)) -> (final RefineParams, loss history (iters,)), the same on
    every rank of `mesh`'s `axis` group, which all call it together.

    select_decoder: a rank-only decoder for the selection passes (stage 1,
    the cells, the warm refresh), e.g. the selection kernel; stage 2
    always decodes with `sdf_decoder`. windowed_2d: None = windowed above
    64x64 px (engine/losses.py::loss_2d's rule)."""
    device = refine_mod._device(device)
    h, w = crop_hw
    n_dev = mesh.shape[axis]
    group = mesh.rays_group if axis == "rays" else mesh.data_group
    rank = mesh.rays_index if axis == "rays" else mesh.data_index
    p_total = h * w
    p_pad = _round_up(p_total, n_dev)
    use_warm = cfg.warm_band > 0
    warm_cells = (cfg.warm_refresh_cells
                  if use_warm and cfg.warm_refresh_cells else None)
    if use_warm:
        if cfg.warm_band != cfg.surface_capacity:
            raise ValueError(
                "sharded warm_band supports only the pool == "
                f"surface_capacity form (got {cfg.warm_band} vs "
                f"{cfg.surface_capacity})")
        if cfg.coarse_cells is not None:
            raise ValueError(
                "warm_band and coarse_cells are alternative per-iteration "
                "selection accelerations; enable at most one (the "
                "composed refresh is warm_refresh_cells)")
        if cfg.warm_refresh < 1:
            raise ValueError(
                f"warm_refresh must be >= 1 (got {cfg.warm_refresh})")
    if windowed_2d is None:
        windowed_2d = p_total > 64 * 64

    grid_np = np.asarray(torch.as_tensor(grid_points).cpu(), np.float32)
    n_grid = len(grid_np)
    cap = cfg.surface_capacity
    cells_budget = (cfg.coarse_cells if cfg.coarse_cells is not None
                    else warm_cells)
    if cells_budget is not None:
        d = round(n_grid ** (1.0 / 3.0))
        if d ** 3 != n_grid:
            raise ValueError(f"grid ({n_grid}) is not a cube")
        children = grid_ops._cell_children_np(d, cfg.coarse_factor)
        n_cells, r3 = children.shape
        # cell-major, padded so that each rank owns whole cells
        nc_pad = _round_up(n_cells, n_dev)
        grid_padded = np.concatenate(
            [grid_np[children.reshape(-1)],
             np.full(((nc_pad - n_cells) * r3, 3), 1e3, np.float32)])
        cells_local = nc_pad // n_dev
        kc_local = min(-(-min(cells_budget, n_cells) // n_dev), cells_local)
        local_cap = min(cap, kc_local * r3)
        if n_dev * local_cap < cap:
            knob = ("coarse_cells" if cfg.coarse_cells is not None
                    else "warm_refresh_cells")
            raise ValueError(
                f"capacity {cap} exceeds the sharded coarse candidate pool "
                f"{n_dev}x{local_cap}; raise {knob}")
    else:
        g_pad = _round_up(n_grid, n_dev)
        # far-away pad points: never selected
        grid_padded = np.concatenate(
            [grid_np, np.full((g_pad - n_grid, 3), 1e3, np.float32)])
        local_cap = min(cap, g_pad // n_dev)
    g_local = len(grid_padded) // n_dev
    grid_block = torch.as_tensor(
        grid_padded[rank * g_local:(rank + 1) * g_local], device=device)

    # pixel (row, col) of every pixel, padded with far-away rows
    ys, xs = np.mgrid[0:h, 0:w]
    pix_rc = np.stack([ys.reshape(-1), xs.reshape(-1)], 1).astype(np.float32)
    pix_rc = np.concatenate([pix_rc, np.full((p_pad - p_total, 2), 1e6,
                                             np.float32)])
    px_valid = np.arange(p_pad) < p_total
    p_local = p_pad // n_dev
    block = slice(rank * p_local, (rank + 1) * p_local)
    rc_block = torch.as_tensor(pix_rc[block], device=device)
    pxv_block = torch.as_tensor(px_valid[block], device=device)
    css_rc = torch.as_tensor(pix_rc[:p_total], device=device)
    K_t = torch.as_tensor(np.asarray(K, np.float32), device=device)
    # the block's rays through the one shared definition (an ulp-different
    # variant flips binarized footprint bits)
    kinv_block = splat_ops.kinv_pixel_rays(K_t, rc_block.flip(-1))

    # stage-2 slices: the selected points padded to a multiple of the ranks
    cap_pad = _round_up(cap, n_dev)
    c2_local = cap_pad // n_dev
    idx_global = rank * c2_local + torch.arange(c2_local, device=device)
    sel_dec = select_decoder if select_decoder is not None else sdf_decoder

    if n_dev > 1:
        def gather(t):
            return mesh_mod.all_gather(t, group)

        def whole(t):
            return mesh_mod.sum_to_replicated(t, group)

        def enter(t):
            return mesh_mod.from_replicated(t, group)
    else:
        def gather(t):
            return t
        whole = enter = gather

    def decode_sel(latent, pts):
        with torch.no_grad():
            return sel_dec(latent.detach(), pts).reshape(-1).float()

    def select_band(latent, grid_blk):
        """Local top-k of the rank's block (pads masked), all-gathered in
        rank order, global top-k: the (cap, 3) selected points, the same
        on every rank. A sentinel row (coordinate > 10) must never win,
        even where a degenerate decoder gives it a small |sdf|."""
        score = torch.where(grid_blk[:, 0] < 10.0,
                            decode_sel(latent, grid_blk).abs(),
                            torch.full((len(grid_blk),), float("inf"),
                                       device=device))
        vals, idx = grid_ops._smallest(score, local_cap)
        all_vals = gather(vals)
        all_pts = gather(grid_blk[idx])
        return all_pts[grid_ops._smallest(all_vals, cap)[1]]

    if cells_budget is not None:
        def cell_candidates(latent, grid_blk):
            """The points of the rank's kc_local best cells, each scored
            from its 2 diagonal children: 0 where their SDFs change sign,
            else the smaller |sdf|; pads never win."""
            blk = grid_blk.reshape(-1, r3, 3)
            s0 = decode_sel(latent, blk[:, 0])
            s1 = decode_sel(latent, blk[:, -1])
            crosses = (torch.minimum(s0, s1) < 0) & (torch.maximum(s0, s1)
                                                     > 0)
            score = torch.where(crosses, torch.zeros_like(s0),
                                torch.minimum(s0.abs(), s1.abs()))
            score = torch.where(blk[:, 0, 0] < 10.0, score,
                                torch.full_like(score, float("inf")))
            cell_idx = grid_ops._smallest(score, kc_local)[1]
            return blk[cell_idx].reshape(-1, 3)

    if warm_cells is not None:
        def refresh_band(latent, grid_blk):
            return select_band(latent, cell_candidates(latent, grid_blk))
    else:
        refresh_band = select_band

    if windowed_2d:
        # the in-disc offsets of each block pixel, gathered from the whole
        # row-major css; a pixel out of the crop is no candidate, and the
        # ||rend|| fallback exists while the disc does not cover the crop
        _, offs, wgts_list = losses_mod.disc_offsets(cfg.loss2d_diam)
        wv = torch.tensor(wgts_list, device=device)[:, None]
        dyx = torch.tensor(offs, device=device, dtype=torch.long)
        pr = rc_block[:, 0].long()[None, :] + dyx[:, 0:1]
        pc = rc_block[:, 1].long()[None, :] + dyx[:, 1:2]
        inb = (pr >= 0) & (pr < h) & (pc >= 0) & (pc < w) \
            & pxv_block[None, :]
        cand_idx = (pr.clamp(0, h - 1) * w + pc.clamp(0, w - 1)).reshape(-1)
        fallback = inb.sum(0) < p_total
    else:
        wgt = torch.clamp(cfg.loss2d_diam - torch.sqrt(
            knn.pairwise_sq_dists(rc_block, css_rc)), min=0.0)

    def loss_2d_block(rend_block, css_rgb):
        """(sum, count, nonzero count) of the 2D loss over the block."""
        nonzero = (rend_block.sum(-1) != 0) & pxv_block
        rend_sq = (rend_block * rend_block).sum(-1)
        if windowed_2d:
            cand = css_rgb[cand_idx].reshape(*inb.shape, 3)
            cand_sq = (cand * cand).sum(-1)
            cross_o = (cand * rend_block[None]).sum(-1)
            dsq = wv * wv * cand_sq - 2.0 * wv * cross_o + rend_sq[None]
            dsq = torch.where(inb, dsq, torch.full_like(dsq, float("inf")))
            fb_sq = torch.where(fallback, rend_sq,
                                torch.full_like(rend_sq, float("inf")))
            min_sq = torch.minimum(dsq.min(0).values, fb_sq)
            finite = torch.isfinite(min_sq)
            pos = (min_sq > 0) & finite
            diff_min = torch.where(
                pos, torch.sqrt(torch.where(pos, min_sq,
                                            torch.ones_like(min_sq))),
                torch.where(finite, torch.zeros_like(min_sq),
                            torch.full_like(min_sq, float("inf"))))
        else:
            css_sq = (css_rgb * css_rgb).sum(-1)
            cross = rend_block @ css_rgb.T
            diff_sq = wgt * wgt * css_sq[None, :] - 2.0 * wgt * cross \
                + rend_sq[:, None]
            diff_min = losses_mod._sqrt_guarded(diff_sq).min(-1).values
        sel = nonzero & (diff_min < cfg.loss2d_threshold)
        return (torch.where(sel, diff_min, torch.zeros_like(diff_min)).sum(),
                sel.sum(), nonzero.sum())

    def iteration(params, css_rgb, frustum, fmask, pts_warm):
        yaw, trans, scale_p, latent_p = (enter(p) for p in params)
        scene = frustum / scale_p
        pose = refine_mod.build_render_pose(yaw, trans)
        latent = refine_mod._normalize_latent(latent_p)

        # stage 1: the grid-sharded selection
        if use_warm:
            pts_sel = pts_warm
        elif cfg.coarse_cells is not None:
            pts_sel = select_band(latent, cell_candidates(latent,
                                                          grid_block))
        else:
            pts_sel = select_band(latent, grid_block)

        # stage 2: this rank's slice, decoded with autograd normals
        pts_pad = (torch.cat([pts_sel, pts_sel[-1:].expand(cap_pad - cap,
                                                           3)])
                   if cap_pad > cap else pts_sel)
        pts_slice = pts_pad[rank * c2_local:(rank + 1) * c2_local]
        with torch.enable_grad():
            p = pts_slice.clone().requires_grad_(True)
            sdf_slice = sdf_decoder(latent, p).reshape(-1)
            (g_slice,) = torch.autograd.grad(sdf_slice.sum(), p,
                                             retain_graph=True)
        normals_slice = grid_ops._unit(g_slice)
        surf_slice = pts_slice - sdf_slice[:, None] * normals_slice
        # pads: beyond the capacity, and a sentinel that survived the
        # selection (more capacity than valid candidates)
        mask_slice = (sdf_slice.abs() < cfg.surface_threshold) \
            & (idx_global < cap) & (pts_slice[:, 0] < 10.0)

        # the gathered set every rank renders
        sdf_sel = enter(gather(sdf_slice))[:cap]
        normals = grid_ops._unit(gather(g_slice)[:cap])
        surf_pts = pts_sel - sdf_sel[:, None] * normals
        surf_mask = (sdf_sel.abs() < cfg.surface_threshold) \
            & (pts_sel[:, 0] < 10.0)

        proj = project_dcm(K_t, pose, surf_pts, normals, normals, (w, h),
                           output_nocs=True)
        v3d, nrm = proj.points_3d, proj.normals_3d
        proj_slice = project_dcm(K_t, pose, surf_slice, normals_slice,
                                 normals_slice, (w, h))

        # the rank's pixel block
        feats = torch.cat([(proj.colors_3d + 1.0) / 2.0,
                           torch.ones_like(v3d[:, :1]), v3d[:, 2:3],
                           (nrm + 1.0) / 2.0], -1)
        rend_block = torch.clamp(splat_cuda.surfel_composite(
            v3d, nrm, feats, kinv_block, point_mask=surf_mask,
            diam=0.04)[:, :3], max=1.0)

        # 3D loss over the rank's slice (optimizer.py:166-198)
        l3_sum, l3_cnt = losses_mod.loss_3d_terms(
            proj_slice.points_3d, mask_slice & proj_slice.front_mask,
            scene, fmask, scale_p, threshold=cfg.loss3d_threshold)
        l3_sum, l3_cnt = whole(l3_sum), whole(l3_cnt)
        l3d = torch.where(l3_cnt > 0, l3_sum / torch.clamp(l3_cnt, min=1),
                          torch.zeros_like(l3_sum))

        # 2D loss over the rank's block; 0/0 NaN when nothing is selected
        l2_sum, l2_cnt, n_nonzero = loss_2d_block(rend_block, css_rgb)
        l2_sum, l2_cnt, n_nonzero = whole(l2_sum), whole(l2_cnt), \
            whole(n_nonzero)
        l2d = torch.where(n_nonzero > 0, l2_sum / l2_cnt,
                          torch.zeros_like(l2_sum))
        return cfg.weight_3d * l3d + cfg.weight_2d * l2d

    def refine(params0, nocs_target, frustum, fmask):
        params = refine_mod.RefineParams(*(
            torch.as_tensor(p, dtype=torch.float32).to(device).detach()
            .clone() for p in params0))
        css_rgb = torch.as_tensor(nocs_target, dtype=torch.float32).to(
            device).reshape(3, p_total).T.contiguous()
        frustum = torch.as_tensor(frustum, dtype=torch.float32).to(device)
        fmask = torch.as_tensor(fmask).to(device).bool()
        state = refine_mod.init_batch_opt_state(
            refine_mod.RefineParams(*(p[None] for p in params)))
        pts_warm, hist = None, []
        for it in range(cfg.iters):
            if use_warm and it % cfg.warm_refresh == 0:
                # selection only, outside the gradient, on every rank
                pts_warm = refresh_band(
                    refine_mod._normalize_latent(params.latent), grid_block)
            leaves = refine_mod.RefineParams(*(p.requires_grad_(True)
                                               for p in params))
            loss = iteration(leaves, css_rgb, frustum, fmask, pts_warm)
            grads = torch.autograd.grad(loss, list(leaves),
                                        allow_unused=True)
            params = refine_mod.RefineParams(*(p.detach() for p in leaves))
            ok = torch.isfinite(loss) & (loss != 0.0)
            hist.append(loss.detach())
            new, state = refine_mod.batch_step(
                cfg, refine_mod.RefineParams(*(p[None] for p in params)),
                [(torch.zeros_like(p) if g is None else g)[None]
                 for p, g in zip(params, grads)], ok[None], state)
            params = refine_mod.RefineParams(*(p[0] for p in new))
        return params, torch.stack(hist)

    return refine
