"""PnP pose init from the NOCS image, in torch, without OpenCV.

Counterpart of sdflabel_tpu/ops/pnp.py (reference utils/pose.py:40-81 and
:236-278), which calls ``cv2.solvePnPRansac(iterationsCount=1000,
reprojectionError=1.0)`` with SOLVEPNP_ITERATIVE. The port mirrors that
solver on the caller's device, in float64:

- 1000 minimal sets of 5 correspondences, drawn from an explicit
  ``torch.Generator`` (ops/ransac.py::draw_ranks), each solved by EPnP
  (Lepetit et al. 2009, as cv2's RANSAC kernel solves them), all in one
  batched pass;
- a hypothesis's inliers are the points it reprojects within 1 px;
- the hypothesis with the most inliers (the first of equals) is refined by
  Levenberg-Marquardt over its inliers' reprojection error (Rodrigues
  rotation and translation), as cv2 refines its best model with
  ``solvePnP(ITERATIVE)`` from that guess.

cv2 draws with its own RNG and stops early once confident, so the poses
agree with it to a tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from sdflabel_tpu_torch.ops import ransac

HYPOTHESES = 1000  # iterationsCount
MINIMAL = 5  # cv2's model points for the EPnP kernel
REPROJECTION_PX = 1.0  # reprojectionError
LM_ITERS = 20  # cv2's solvePnP(ITERATIVE) criteria
_SCORE_CHUNK = 64  # hypotheses scored at once: (chunk, N) residuals
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _project(R: torch.Tensor, t: torch.Tensor, obj: torch.Tensor,
             K: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) pixels of (..., N, 3) points under (..., 3, 3) R and
    (..., 3) t, without distortion (cv2.projectPoints: fx, fy, cx, cy)."""
    cam = obj @ R.transpose(-1, -2) + t[..., None, :]
    xy = cam[..., :2] / cam[..., 2:3]
    return torch.stack([K[0, 0] * xy[..., 0] + K[0, 2],
                        K[1, 1] * xy[..., 1] + K[1, 2]], -1)


def _take(t: torch.Tensor, idx, dim: int) -> torch.Tensor:
    """t's entries `idx` (a list) along `dim`, the index on t's device."""
    return t.index_select(dim, torch.as_tensor(idx, device=t.device))


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched least squares of (H, m, k) A against (H, m) b."""
    return (torch.linalg.pinv(A) @ b[..., None])[..., 0]


def _betas_from_halves(b0, b_mid, b_last):
    """betas[0], betas[1] of cv2's find_betas_approx_2 / _3."""
    first = torch.sqrt(b0.abs())
    second = torch.where(b0 < 0, torch.sqrt(torch.clamp(-b_last, min=0)),
                         torch.sqrt(torch.clamp(b_last, min=0)))
    return torch.where(b_mid < 0, -first, first), second


def epnp(obj: torch.Tensor, img: torch.Tensor, K: torch.Tensor):
    """EPnP on H problems at once: (H, n, 3) object points and (H, n, 2)
    pixels -> (R (H, 3, 3), t (H, 3)), cv2's epnp::compute_pose: the
    control points from the points' principal axes, the null space of
    M^T M, betas for 1, 2 and 3 null vectors (each refined by 5
    Gauss-Newton steps), the pose of least mean reprojection error."""
    h, n, _ = obj.shape
    c0 = obj.mean(1)
    pw0 = obj - c0[:, None]
    evals, evecs = torch.linalg.eigh(pw0.transpose(1, 2) @ pw0)
    evals, evecs = evals.flip(-1).clamp(min=0), evecs.flip(-1)
    axes = torch.sqrt(evals / n)[..., None] * evecs.transpose(1, 2)
    cws = torch.cat([c0[:, None], c0[:, None] + axes], 1)  # (H, 4, 3)
    cc = (cws[:, 1:] - cws[:, :1]).transpose(1, 2)
    a = (torch.linalg.pinv(cc) @ pw0.transpose(1, 2)).transpose(1, 2)
    alphas = torch.cat([1.0 - a.sum(-1, keepdim=True), a], -1)  # (H, n, 4)
    zero = torch.zeros_like(alphas)
    du = (K[0, 2] - img[..., 0])[..., None]
    dv = (K[1, 2] - img[..., 1])[..., None]
    rows = torch.stack([
        torch.stack([alphas * K[0, 0], zero, alphas * du], -1),
        torch.stack([zero, alphas * K[1, 1], alphas * dv], -1)], 2)
    M = rows.reshape(h, 2 * n, 12)
    _, V = torch.linalg.eigh(M.transpose(1, 2) @ M)
    null = V[..., :4].transpose(1, 2).reshape(h, 4, 4, 3)  # smallest first
    ia, ib = [p[0] for p in _PAIRS], [p[1] for p in _PAIRS]
    d = _take(null, ia, 2) - _take(null, ib, 2)  # (H, 4, 6 pairs, 3)

    def dot(i, j):
        return (d[:, i] * d[:, j]).sum(-1)

    L = torch.stack([dot(0, 0), 2 * dot(0, 1), dot(1, 1), 2 * dot(0, 2),
                     2 * dot(1, 2), dot(2, 2), 2 * dot(0, 3), 2 * dot(1, 3),
                     2 * dot(2, 3), dot(3, 3)], -1)  # (H, 6, 10)
    rho = (_take(cws, ia, 1) - _take(cws, ib, 1)).square().sum(-1)  # (H, 6)
    zeros = torch.zeros_like(rho[:, 0])

    b4 = _lstsq(_take(L, [0, 1, 3, 6], 2), rho)
    s = torch.sqrt(b4[:, 0].abs()).clamp(min=1e-300)
    sign = torch.where(b4[:, 0] < 0, -1.0, 1.0).to(b4)
    approx1 = torch.stack([s, sign * b4[:, 1] / s, sign * b4[:, 2] / s,
                           sign * b4[:, 3] / s], -1)
    b3 = _lstsq(L[..., :3], rho)
    f, g = _betas_from_halves(b3[:, 0], b3[:, 1], b3[:, 2])
    approx2 = torch.stack([f, g, zeros, zeros], -1)
    b5 = _lstsq(L[..., :5], rho)
    f, g = _betas_from_halves(b5[:, 0], b5[:, 1], b5[:, 2])
    approx3 = torch.stack([f, g, b5[:, 3] / torch.where(
        f == 0, torch.ones_like(f), f), zeros], -1)

    best_err, best_R, best_t = None, None, None
    for betas in (approx1, approx2, approx3):
        betas = _gauss_newton(L, rho, betas)
        R, t = _pose_from_betas(null, betas, alphas, obj)
        err = (_project(R, t, obj, K) - img).norm(dim=-1).mean(-1)
        err = torch.where(torch.isfinite(err), err, torch.inf)
        if best_err is None:
            best_err, best_R, best_t = err, R, t
        else:
            better = err < best_err
            best_err = torch.where(better, err, best_err)
            best_R = torch.where(better[:, None, None], R, best_R)
            best_t = torch.where(better[:, None], t, best_t)
    return best_R, best_t


def _gauss_newton(L, rho, betas, steps: int = 5):
    """cv2's epnp::gauss_newton: all four betas against the six control
    point distances."""
    for _ in range(steps):
        b0, b1, b2, b3 = betas.unbind(-1)
        l = L.unbind(-1)
        A = torch.stack([
            2 * l[0] * b0[:, None] + l[1] * b1[:, None] + l[3] * b2[:, None]
            + l[6] * b3[:, None],
            l[1] * b0[:, None] + 2 * l[2] * b1[:, None] + l[4] * b2[:, None]
            + l[7] * b3[:, None],
            l[3] * b0[:, None] + l[4] * b1[:, None] + 2 * l[5] * b2[:, None]
            + l[8] * b3[:, None],
            l[6] * b0[:, None] + l[7] * b1[:, None] + l[8] * b2[:, None]
            + 2 * l[9] * b3[:, None]], -1)
        quad = torch.stack([b0 * b0, b0 * b1, b1 * b1, b0 * b2, b1 * b2,
                            b2 * b2, b0 * b3, b1 * b3, b2 * b3, b3 * b3], -1)
        r = rho - (L * quad[:, None]).sum(-1)
        betas = betas + _lstsq(A, r)
    return betas


def _pose_from_betas(null, betas, alphas, obj):
    """cv2's epnp::compute_R_and_t: the control points in the camera
    frame, the points there (in front of it), then the rotation and
    translation that carry the object points onto them."""
    ccs = (betas[:, :, None, None] * null).sum(1)  # (H, 4, 3)
    pcs = alphas @ ccs
    flip = torch.where(pcs[:, 0, 2] < 0, -1.0, 1.0).to(pcs)[:, None, None]
    pcs = pcs * flip
    pc0, pw0 = pcs.mean(1), obj.mean(1)
    abt = (pcs - pc0[:, None]).transpose(1, 2) @ (obj - pw0[:, None])
    U, _, Vh = torch.linalg.svd(abt)
    R = U @ Vh
    neg = torch.linalg.det(R) < 0
    R = torch.where(neg[:, None, None], R * torch.tensor(
        [1.0, 1.0, -1.0], dtype=R.dtype, device=R.device)[:, None], R)
    t = pc0 - (R @ pw0[..., None])[..., 0]
    return R, t


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """(3,) rotation vector -> (3, 3) matrix (cv2.Rodrigues): I + A [r]x +
    B [r]x^2 with A = sin(t)/t, B = (1 - cos(t))/t^2, their Taylor series
    near t = 0. No branch on the data, so that jacfwd can trace it."""
    t2 = r @ r
    small = t2 < 1e-8
    t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    a = torch.where(small, 1 - t2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(t)) / (t * t))
    kx = _skew(r)
    return torch.eye(3, dtype=r.dtype, device=r.device) + a * kx \
        + b * (kx @ kx)


def _skew(k: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(k[0])
    return torch.stack([torch.stack([z, -k[2], k[1]]),
                        torch.stack([k[2], z, -k[0]]),
                        torch.stack([-k[1], k[0], z])])


def rotation_vector(R: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation -> (3,) rotation vector, the inverse of
    :func:`rodrigues` (angles up to pi)."""
    cos = torch.clamp((torch.trace(R) - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    if float(theta) < 1e-12:
        return w / 2
    if float(np.pi - theta) < 1e-6:  # w vanishes: the axis from R + I
        col = torch.argmax(torch.diagonal(R))
        axis = (R + torch.eye(3, dtype=R.dtype, device=R.device))[:, col]
        return axis / torch.linalg.norm(axis) * theta
    return w * (theta / (2 * torch.sin(theta)))


def refine_lm(rvec: torch.Tensor, t: torch.Tensor, obj: torch.Tensor,
              img: torch.Tensor, K: torch.Tensor, iters: int = LM_ITERS):
    """Levenberg-Marquardt on the reprojection residuals of (N, 3) points
    against (N, 2) pixels over (rvec, t), Marquardt's diagonal damping;
    returns the refined (rvec, t)."""
    def residual(x):
        return (_project(rodrigues(x[:3]), x[3:], obj, K) - img).reshape(-1)

    x = torch.cat([rvec, t])
    r = residual(x)
    cost = float(r @ r)
    lam = 1e-3
    for _ in range(iters):
        J = torch.func.jacfwd(residual)(x)
        A, g = J.T @ J, J.T @ r
        improved = False
        for _ in range(10):
            step = torch.linalg.solve(
                A + lam * torch.diag(torch.diagonal(A)), -g)
            xn = x + step
            rn = residual(xn)
            cn = float(rn @ rn)
            if np.isfinite(cn) and cn < cost:
                x, r, improved = xn, rn, True
                small = cost - cn <= 1e-15 * max(cost, 1e-300)
                cost = cn
                lam = max(lam / 10, 1e-12)
                break
            lam *= 10
        if not improved or small:
            break
    return x[:3], x[3:]


def solve_pnp(cam, image_points, object_points, return_inliers: bool = False,
              device="cpu", generator: torch.Generator | None = None):
    """The 4x4 camera pose of (N, 3) object points seen at (N, 2) image
    points given as (row, col), swapped to (x, y) as the reference does
    (pose.py:257); identity with fewer than 4 points or when no hypothesis
    has an inlier. `generator` (on `device`) draws the minimal sets; seed 0
    when None. With return_inliers, (pose, inlier count of the best
    hypothesis)."""
    pose = np.eye(4)
    n = int(np.shape(image_points)[0])
    if n < 4:
        return (pose, 0) if return_inliers else pose
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    img = torch.as_tensor(np.ascontiguousarray(
        np.asarray(image_points, np.float64)[:, ::-1]), **f64)
    obj = torch.as_tensor(np.asarray(object_points, np.float64), **f64)
    K = torch.as_tensor(np.asarray(cam, np.float64), **f64)
    if n <= MINIMAL:
        # as many points as a minimal set: one solve of all of them
        R, t = epnp(obj[None], img[None], K)
        R, t, inliers = R[0], t[0], torch.ones(n, dtype=torch.bool,
                                               device=dev)
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        sets = ransac.draw_ranks(n, ransac.RansacConfig(
            num_hypotheses=HYPOTHESES, sample_size=MINIMAL), generator)
        Rs, ts = epnp(obj[sets], img[sets], K)
        counts = torch.cat([
            ((_project(Rs[i:i + _SCORE_CHUNK], ts[i:i + _SCORE_CHUNK], obj,
                       K) - img).square().sum(-1)
             <= REPROJECTION_PX ** 2).sum(-1)
            for i in range(0, HYPOTHESES, _SCORE_CHUNK)])
        best = int(torch.argmax(counts))  # the first of the most inliers
        if int(counts[best]) == 0:
            return (pose, 0) if return_inliers else pose
        R, t = Rs[best], ts[best]
        inliers = ((_project(R, t, obj, K) - img).square().sum(-1)
                   <= REPROJECTION_PX ** 2)
    rvec, t = refine_lm(rotation_vector(R), t, obj[inliers], img[inliers], K)
    pose[:3, :3] = rodrigues(rvec).cpu().numpy()
    pose[:3, 3] = t.cpu().numpy()
    if return_inliers:
        return pose, int(inliers.sum())
    return pose


def init_pose_2d(cam, nocs_region, scale_model: float = 1.0, device="cpu",
                 generator: torch.Generator | None = None) -> dict:
    """NOCS image -> 2D-3D correspondences -> PnP pose (pose.py:40-81):
    every pixel whose red channel is nonzero pairs its (row, col) with its
    NOCS coordinate * 2 - 1, times `scale_model`. Returns the reference's
    dict {rot, quat (w, x, y, z), tra, scale}."""
    from scipy.spatial.transform import Rotation

    nocs = np.transpose(np.asarray(nocs_region), (1, 2, 0))
    nonzero = nocs[:, :, 0] > 0
    object_points = (nocs[nonzero] * 2.0 - 1.0) * scale_model
    rows, cols = np.nonzero(nonzero)
    image_points = np.stack([rows, cols], axis=1).astype(np.float64)
    predicted = solve_pnp(np.asarray(cam), image_points, object_points,
                          device=device, generator=generator)
    rot = predicted[:3, :3]
    quat = Rotation.from_matrix(rot).as_quat()
    return {"rot": rot, "quat": np.concatenate([quat[3:], quat[:3]]),
            "tra": predicted[:3, 3], "scale": scale_model}
