"""Plain PyTorch reference of the batched refine (one frame's crops) and of
its KITTI label, in the configuration's precision.

It follows the algorithm of sdflabel's refinement as the stock
config_refine.ini runs it: the decoder in bf16 ([optimization] precision
float16), the warm band (the 8192 grid points of least |sdf| ranked every
10 iterations, all of them kept between refreshes), the exact stage-2
decode with autograd normals, the disc-surfel render of the NOCS image,
the 3D nearest-neighbour loss against the LIDAR and the projective 2D NOCS
loss, then optax's Adam (yaw, translation) and SGD (scale, latent) behind
the NaN/zero guard. Dense (B, N, P) matrices stand in for every kernel,
each crop on its own rows.

The refine is chaotic over 60 iterations (a 1e-6 change of the start
moves the end by centimetres), so the reference does not run its own 60
iterations: it takes the parameters the program used at each iteration
(the program's history), recomputes that iteration's losses and
gradients, steps its own optimizer state on them, and compares the step
it predicts with the program's next parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS32 = torch.finfo(torch.float32).eps


# ---------------------------------------------------------------- decoder

def grid_points(density: int, device) -> torch.Tensor:
    """density^3 points over [-1, 1]^3, every second point in flattened
    order shifted by half a cell in x and y (sdfrenderer/grid.py:34-38 as
    the code reads, not as its comment does)."""
    lin = np.linspace(-1.0, 1.0, density)
    X, Y, Z = np.meshgrid(lin, lin, lin, indexing="ij")
    grid = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    grid[1::2, :2] += (lin.max() - lin.min()) / density / 2.0
    return torch.as_tensor(grid.astype(np.float32), device=device)


def _quant_fp8(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale (amax to 448), the
    gradient passed straight through."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    s = amax / 448.0
    q = (x.float() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q.to(x.dtype) - x).detach()


class Decoder:
    """The DeepSDF decoder (deep_sdf_decoder_scale.py:78-107, eval mode) on
    the parameter tree {lin<l>: {v, g, b} | {w, b}}.

    precision "bf16": every parameter cast to bf16 and the weight norm
    folded in bf16, latent and points cast to bf16, the sdf returned as
    fp32, as the configuration's float16 states. "fp32": all in fp32.
    "fp8": the control, each layer's weights and inputs through float8
    e4m3 (per-tensor scales), products in fp32."""

    def __init__(self, params: dict, latent_in, precision: str = "bf16"):
        self.latent_in = tuple(latent_in)
        self.precision = precision
        self.n = sum(1 for k in params if k.startswith("lin"))
        dt = torch.bfloat16 if precision == "bf16" else torch.float32
        self.dtype = dt
        self.w, self.b = [], []
        for l in range(self.n):
            p = {k: v.to(dt) for k, v in params[f"lin{l}"].items()}
            if "v" in p:
                w = p["v"] * (p["g"] / torch.linalg.norm(p["v"], dim=0))[None]
            else:
                w = p["w"]
            self.w.append(w)
            self.b.append(p["b"])

    def _linear(self, l, x):
        w = self.w[l]
        if self.precision == "fp8":
            return _quant_fp8(x) @ _quant_fp8(w) + self.b[l]
        return x @ w + self.b[l]

    def __call__(self, latent: torch.Tensor, points: torch.Tensor):
        """(B, L) latents with (N, 3) shared or (B, N, 3) own points ->
        (B, N) fp32 sdf."""
        dt = self.dtype
        lat = latent.to(dt)
        pts = points.to(dt)
        b, n = lat.shape[0], pts.shape[-2]
        inputs = torch.cat([lat[:, None, :].expand(b, n, lat.shape[-1]),
                            pts.expand(b, n, 3)], -1)
        x = inputs
        for l in range(self.n):
            if l in self.latent_in:
                x = torch.cat([x, inputs], -1)
            x = self._linear(l, x)
            if l < self.n - 1:
                x = torch.relu(x)
        return torch.tanh(x)[..., 0].float()


def smallest(values: torch.Tensor, k: int):
    """(values, indices) of the k least entries along the last axis, ties
    kept in index order."""
    vals, idx = torch.sort(values, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def select(decoder, latent, points, k: int) -> torch.Tensor:
    """Grid indices (B, k) of the k least |sdf| (no gradient)."""
    with torch.no_grad():
        sdf = decoder(latent.detach(), points)
    return smallest(sdf.abs(), k)[1]


def normalize_latent(latent):
    return latent / torch.sqrt(torch.clamp(
        latent.square().sum(-1, keepdim=True), min=1e-24))


def stage2(decoder, latent, pts_sel, threshold: float):
    """Differentiable decode at the selected (B, K, 3) points: (projected
    points, unit normals (detached autograd gradients), mask)."""
    p = pts_sel.detach().clone().requires_grad_(True)
    sdf = decoder(latent, p)
    (grads,) = torch.autograd.grad(sdf.sum(), p, retain_graph=True)
    g = grads.detach()
    n = g / torch.clamp(torch.linalg.norm(g, dim=-1, keepdim=True),
                        min=torch.finfo(g.dtype).tiny)
    proj = pts_sel.detach() - sdf[..., None] * n
    return proj, n, sdf.abs() < threshold


# ----------------------------------------------------------------- render

def render_pose(yaw: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4): rotation about +Y by yaw with its Y row negated, then the
    translation (optimizer.py:87-90)."""
    y = yaw[:, 0]
    c, s = torch.cos(y), torch.sin(y)
    z, o = torch.zeros_like(y), torch.ones_like(y)
    rot = torch.stack([c, z, s, z, -o, z, -s, z, c], -1).reshape(-1, 3, 3)
    top = torch.cat([rot, trans[:, :, None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=yaw.device).expand(
        top.shape[0], 1, 4)
    return torch.cat([top, bottom], 1)


def pixel_rays(K: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, P, 3) camera rays [x, y, 1] inv(K)^T of the pixels, row-major,
    for (B, 3, 3) intrinsics."""
    ys = torch.arange(h, device=K.device, dtype=torch.float32)
    xs = torch.arange(w, device=K.device, dtype=torch.float32)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([xx.reshape(-1), yy.reshape(-1),
                       torch.ones(h * w, device=K.device)], -1)
    return pix @ torch.linalg.inv(K.float()).transpose(-1, -2)


def surfel_prob(rays, pts_cam, nrm_cam, mask, diam=0.04, depth_c=150.0):
    """(B, N, P) disc-surfel composition weights of each crop
    (primitives.py:165-242, softclamp off) and the footprint pair count."""
    n_v3d = (nrm_cam * pts_cam).sum(-1)
    n_k = nrm_cam @ rays.transpose(-1, -2)
    n_k = torch.where(n_k.abs() < 0.01, torch.full_like(n_k, EPS32), n_k)
    z = n_v3d[..., None] / n_k
    vec = pts_cam[..., :, None, :] - rays[..., None, :, :] * z[..., None]
    dist = torch.sqrt((vec * vec).sum(-1))
    foot = (torch.clamp(diam - dist, min=0.0) > 0).float().detach()
    foot = foot * mask.float()[..., None]
    zs = -z * foot
    zn = torch.linalg.norm(zs, dim=-2, keepdim=True).detach()
    zs = torch.clamp(zs / (zn + EPS32) + 1.0, min=0.0) * depth_c
    masked = torch.where(foot > 0, zs, torch.full_like(zs, torch.finfo(
        torch.float32).min))
    return torch.softmax(masked, dim=-2) * foot, float(foot.sum())


def render(K, hw, pts, nrm, mask, pose):
    """B crops' NOCS renders: ((B, 3, h, w) colour clamped to 1, camera
    points, front-facing masks, footprint pairs)."""
    h, w = hw
    rot_t = pose[:, :3, :3].transpose(1, 2)
    pc = pts @ rot_t + pose[:, None, :3, 3]
    nc = nrm @ rot_t
    colors = pts * torch.tensor([-1.0, 1.0, 1.0], device=pts.device)
    feats = torch.cat([(colors + 1.0) / 2.0, torch.ones_like(pc[..., :1]),
                       pc[..., 2:3], (nc + 1.0) / 2.0], -1)
    prob, pairs = surfel_prob(pixel_rays(K, h, w).detach(), pc, nc, mask)
    img = (prob.transpose(1, 2) @ feats).transpose(1, 2).reshape(
        -1, 8, h, w)
    front = mask & ((nc * pc).sum(-1) < 0)
    return torch.clamp(img[:, 0:3], max=1.0), pc, front, pairs


def render_crop(K, hw, pts, nrm, mask, pose):
    """One crop's render (see :func:`render`)."""
    color, pc, front, pairs = render(K[None], hw, pts[None], nrm[None],
                                     mask[None], pose[None])
    return color[0], pc[0], front[0], pairs


# ----------------------------------------------------------------- losses

def nearest(query, data, data_mask):
    """(squared distance, index) of each query's nearest unmasked data
    point, crop by crop ((B, N, 3) against (B, M, 3)), in fp32 ((a0-b0)^2
    + (a1-b1)^2) + (a2-b2)^2, the first of equal minima."""
    d2 = (query[..., :, None, 0] - data[..., None, :, 0]).square()
    d2 = d2 + (query[..., :, None, 1] - data[..., None, :, 1]).square()
    d2 = d2 + (query[..., :, None, 2] - data[..., None, :, 2]).square()
    d2 = d2.masked_fill(~data_mask[..., None, :], float("inf"))
    return torch.min(d2, dim=-1)


def loss_3d(pc, front, scene, fmask, scale, threshold=0.2):
    """(B,) mean distance of the front points' close nearest LIDAR
    neighbours (optimizer.py:166-198); `scene` is the LIDAR over the
    scale."""
    d2, idx = nearest(pc.detach(), scene.detach(), fmask)
    close = (torch.sqrt(d2) < threshold / scale.detach()) & front
    nn_pts = torch.take_along_dim(scene, idx[..., None], dim=-2)
    e2 = (nn_pts - pc).square().sum(-1)
    safe = e2 > 0
    pair = torch.where(safe, torch.sqrt(torch.where(safe, e2,
                                                    torch.ones_like(e2))),
                       torch.zeros_like(e2))
    cnt = close.sum(-1)
    tot = torch.where(close, pair, torch.zeros_like(pair)).sum(-1)
    return torch.where(cnt > 0, tot / torch.clamp(cnt, min=1),
                       torch.zeros_like(tot))


def loss_2d(rend, css, pmask, diam=5.0, thr=1.0):
    """(B,) projective NOCS loss (optimizer.py:200-237), dense: for each
    rendered nonzero pixel the least ||css[p] * max(diam - |p - r|, 0) -
    rend[r]|| over the valid pixels p, averaged over those under `thr`."""
    b, c, h, w = rend.shape
    r = rend.reshape(b, c, -1).transpose(1, 2)
    s = css.reshape(b, c, -1).transpose(1, 2)
    pm = pmask.reshape(b, -1)
    nonzero = (r.sum(-1) != 0) & pm
    gy, gx = torch.meshgrid(torch.arange(h, device=r.device,
                                         dtype=torch.float32),
                            torch.arange(w, device=r.device,
                                         dtype=torch.float32),
                            indexing="ij")
    pix = torch.stack([gy.reshape(-1), gx.reshape(-1)], -1)
    dd = (pix[:, None, :] - pix[None, :, :]).square().sum(-1)
    wgt = torch.clamp(diam - torch.sqrt(dd), min=0.0)
    diff_sq = wgt * wgt * (s * s).sum(-1)[:, None, :] \
        - 2.0 * wgt * (r @ s.transpose(1, 2)) + (r * r).sum(-1)[..., None]
    pos = diff_sq > 0
    diff = torch.where(pos, torch.sqrt(torch.where(pos, diff_sq,
                                                   torch.ones_like(diff_sq))),
                       torch.zeros_like(diff_sq))
    diff = torch.where(pm[:, None, :], diff,
                       torch.full_like(diff, math.inf))
    dmin = diff.min(-1).values
    sel = nonzero & (dmin < thr)
    mean = torch.where(sel, dmin, torch.zeros_like(dmin)).sum(-1) \
        / sel.sum(-1)
    return torch.where(nonzero.any(-1), mean, torch.zeros_like(mean))


# -------------------------------------------------------------- optimizer

LEAVES = ("yaw", "trans", "scale", "latent")


def adam_sgd_step(params, grads, ok, state, lrs):
    """optax Adam(yaw), Adam(trans) and SGD(scale), SGD(latent) for B
    crops; a leaf whose gradient is not all finite steps on zero, a crop
    whose loss is not finite and nonzero keeps its parameters and its
    state (count included)."""
    count, mu, nu = state
    grads = [torch.where((ok & torch.isfinite(g).all(-1))[:, None], g,
                         torch.zeros_like(g)) for g in grads]
    b1, b2, eps = 0.9, 0.999, 1e-8
    c = count + 1
    bc1 = (1.0 - b1 ** c.float())[:, None]
    bc2 = (1.0 - b2 ** c.float())[:, None]
    mu2 = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, mu)]
    nu2 = [(1.0 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu)]
    ups = [(m / bc1) / (torch.sqrt(v / bc2) + eps) * -lr
           for m, v, lr in zip(mu2, nu2, lrs[:2])]
    ups += [g * -lr for g, lr in zip(grads[2:], lrs[2:])]
    keep = ok[:, None]
    new = [torch.where(keep, p + u, p) for p, u in zip(params, ups)]
    state = (torch.where(ok, c, count),
             [torch.where(keep, a, o) for a, o in zip(mu2, mu)],
             [torch.where(keep, a, o) for a, o in zip(nu2, nu)])
    return new, state


# ------------------------------------------------------------ frame follow

def bucket_hw(crops, bucket: int) -> tuple[int, int]:
    """The render canvas of a frame's crops: the largest h and w rounded
    up to `bucket`."""
    return tuple(-(-max(c["crop_hw"][i] for c in crops) // bucket) * bucket
                 for i in (0, 1))


def letterbox(crops, bucket: int, device):
    """Each crop's NOCS target in the frame's canvas (:func:`bucket_hw`)
    with its pixel mask."""
    bh, bw = bucket_hw(crops, bucket)
    nocs = torch.zeros(len(crops), 3, bh, bw, device=device)
    pm = torch.zeros(len(crops), bh, bw, dtype=torch.bool, device=device)
    for i, c in enumerate(crops):
        h, w = c["crop_hw"]
        nocs[i, :, :h, :w] = torch.as_tensor(c["nocs_target"], device=device)
        pm[i, :h, :w] = True
    return (bh, bw), nocs, pm


def iteration_loss(decoder, rc: dict, grid, params, cand, K, hw, nocs, pm,
                   frustum, fmask):
    """(loss (B,), l2d, l3d, footprint pairs) of one iteration for B crops
    at `params` (a list of leaves that may require grad)."""
    yaw, trans, scale, latent = params
    lat = normalize_latent(latent)
    pts, nrm, mask = stage2(decoder, lat, grid[cand],
                            rc["surface_threshold"])
    color, pc, front, pairs = render(K, hw, pts, nrm, mask,
                                     render_pose(yaw, trans))
    l3d = loss_3d(pc, front, frustum / scale[:, :, None], fmask, scale,
                  rc["loss3d_threshold"])
    l2d = loss_2d(color, nocs, pm, rc["loss2d_diam"], rc["loss2d_threshold"])
    return rc["weight_3d"] * l3d + rc["weight_2d"] * l2d, l2d, l3d, pairs


def follow(decoder, rc: dict, grid, crops, hist_params, final, device,
           sel_decoder=None):
    """Follow the program's refine of one frame's crops.

    `hist_params`: the program's parameters as used by each iteration,
    leaves (B, T, .) in LEAVES order; `final`: its parameters after the
    last step. Returns per-iteration losses (B, T) and the steps this
    reference predicts from each of the program's states (leaf list of (B,
    T, .)), and the footprint pairs of every iteration's render."""
    hw, nocs, pm = letterbox(crops, rc["render_bucket"], device)
    K = torch.stack([torch.as_tensor(c["intrinsics"], device=device)
                     for c in crops]).float()
    frustum = torch.stack([torch.as_tensor(c["frustum"], device=device)
                           for c in crops]).float()
    fmask = torch.stack([torch.as_tensor(c["fmask"], device=device)
                         for c in crops]).bool()
    b, iters = hist_params[0].shape[:2]
    sel_decoder = sel_decoder or decoder
    zeros = [torch.zeros_like(hist_params[i][:, 0]) for i in (0, 1)]
    state = (torch.zeros(b, dtype=torch.int32, device=device), zeros, zeros)
    lrs = (rc["lr_yaw"], rc["lr_trans"], rc["lr_scale"], rc["lr_latent"])
    losses, steps, pairs = [], [], []
    cand = None
    for t in range(iters):
        p = [h[:, t].detach().float() for h in hist_params]
        if t % rc["warm_refresh"] == 0:
            cand = select(sel_decoder, normalize_latent(p[3]), grid,
                          rc["warm_band"])
        leaves = [x.clone().requires_grad_(True) for x in p]
        loss, _, _, pr = iteration_loss(decoder, rc, grid, leaves, cand, K,
                                        hw, nocs, pm, frustum, fmask)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        ok = torch.isfinite(loss) & (loss != 0.0)
        new, state = adam_sgd_step(p, grads, ok, state, lrs)
        losses.append(loss.detach())
        steps.append([n - q for n, q in zip(new, p)])
        pairs.append(pr)
    nxt = [torch.cat([h[:, 1:], f[:, None]], 1)
           for h, f in zip(hist_params, final)]
    prog_steps = [n - h for n, h in zip(nxt, hist_params)]
    ref_steps = [torch.stack([s[i] for s in steps], 1) for i in range(4)]
    return torch.stack(losses, 1), ref_steps, prog_steps, pairs


# ------------------------------------------------------------------ label

def extents(decoder, grid, latent, capacity: int, threshold: float):
    """Masked min / max (B, 3) of the surface band at the raw latent, and
    whether it is non-empty (refinement.py:516-529)."""
    cand = select(decoder, latent, grid, capacity)
    pts, _, mask = stage2(decoder, latent, grid[cand], threshold)
    pts = pts.detach()
    big = torch.full_like(pts, math.inf)
    mn = torch.where(mask[..., None], pts, big).min(-2).values
    mx = torch.where(mask[..., None], pts, -big).max(-2).values
    return mn, mx, mask.any(-1)


def _rot_y(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _roty_in_bev(pose: np.ndarray) -> float:
    fwd = pose[:3, :3] @ np.asarray([0.0, 0.0, 1.0])
    ry = math.acos(float(np.clip(np.asarray([1.0, 0, 0]) @ fwd, -1, 1)))
    return -ry if fwd[2] > 0 else ry


def kitti_label(yaw, scale, trans, mn, mx, world_to_cam) -> dict:
    """Host float64 KITTI label (refinement.py:530-562): location,
    dimensions (h, w, l), rotation_y and alpha."""
    s = float(scale)
    cam_t = np.eye(4)
    cam_t[:3, :3] = _rot_y(float(yaw)) @ np.diag([1.0, -1.0, 1.0])
    cam_t[:3, 3] = np.asarray(trans, np.float64) * s
    g = np.linalg.inv(np.asarray(world_to_cam, np.float64)) @ cam_t
    a, b = np.asarray(mn, np.float64) * s, np.asarray(mx, np.float64) * s
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    wd, ht, ln = hi - lo
    loc = g[:3, :3] @ np.asarray([0.0, lo[1], 0.0]) + g[:3, 3]
    ry = _roty_in_bev(g)
    car = np.asarray([[0.0, 0, 1], [0, 0, 0]])
    car = ((g[:3, :3] @ car.T).T + g[:3, 3])[:, ::2]
    theta = math.atan2(abs(car[1, 0]), abs(car[1, 1]))
    alpha = ry + theta if car[1, 0] < 0 else ry - theta
    return {"location": loc, "dimensions": [ht, wd, ln], "rotation_y": ry,
            "alpha": alpha}


def label_gap(a: dict, b: dict) -> float:
    """Largest difference of two labels: location and dimensions in metres,
    rotation_y and alpha in radians (wrapped)."""
    gaps = [np.abs(np.asarray(a["location"], np.float64)
                   - np.asarray(b["location"], np.float64)).max(),
            np.abs(np.asarray(a["dimensions"], np.float64)
                   - np.asarray(b["dimensions"], np.float64)).max()]
    for k in ("rotation_y", "alpha"):
        d = (float(a[k]) - float(b[k]) + math.pi) % (2 * math.pi) - math.pi
        gaps.append(abs(d))
    return float(max(gaps))
