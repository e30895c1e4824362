"""Fused surfel splat + composite (kernel 1), forward and backward.

Counterpart of sdflabel_tpu/ops/splat_pallas.py (dense branch). The
kernels live in csrc/splat.cu, whose source note says what bounds them on
the H100 and how the design follows. ``surfel_composite`` returns the
composited (P, 8) image rows; CPU tensors take the plain version
(ops/splat.py::surfel_composite_dense) and CUDA tensors the kernels.

Tolerance against the plain version: the kernel keeps the TPU kernel's
sqrt-free expanded distance vv - 2 vk z + gg z^2, the plain version the
explicit ||v - g z||, so a footprint bit can flip for a pixel at the disc
boundary (the JAX package's own kernel test allows 0.5% of pixels);
elsewhere values agree to fp32 reassociation (2e-4). A guarded pair
(|n . g| < 0.01) passes no gradient in the kernel, as on the TPU.
"""

from __future__ import annotations

import torch

from sdflabel_tpu_torch.ops import _cuda
from sdflabel_tpu_torch.ops import splat as splat_ops

NUM_FEATURES = 8  # [color(3) | mask(1) | depth(1) | normal(3)]

SPLAT_FWD = _cuda.CudaKernel("splat", "splat_fwd", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.F, _cuda.F,
    _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P])
SPLAT_BWD = _cuda.CudaKernel("splat", "splat_bwd", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.F, _cuda.F,
    _cuda.P, _cuda.P, _cuda.P, _cuda.P])


def _fwd(pts, feats, kg, diam2, depth_constant):
    dev = pts.device
    n, p = pts.shape[0], kg.shape[0]
    _cuda.check("pts", pts, torch.float32, (n, 8), dev)
    _cuda.check("feats", feats, torch.float32, (n, NUM_FEATURES), dev)
    _cuda.check("kg", kg, torch.float32, (p, 4), dev)
    img = torch.empty(p, NUM_FEATURES, device=dev, dtype=torch.float32)
    m, d, zn = (torch.empty(p, device=dev, dtype=torch.float32)
                for _ in range(3))
    SPLAT_FWD(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(kg), n, p, diam2,
              float(depth_constant), _cuda.ptr(img), _cuda.ptr(m),
              _cuda.ptr(d), _cuda.ptr(zn), _cuda.stream(pts))
    return img, m, d, zn


def _bwd(pts, feats, pix, diam2, depth_constant):
    dev = pts.device
    n, p = pts.shape[0], pix.shape[0]
    _cuda.check("pts", pts, torch.float32, (n, 8), dev)
    _cuda.check("feats", feats, torch.float32, (n, NUM_FEATURES), dev)
    _cuda.check("pix", pix, torch.float32, (p, 16), dev)
    dv = torch.empty(n, 3, device=dev, dtype=torch.float32)
    dn = torch.empty(n, 3, device=dev, dtype=torch.float32)
    df = torch.empty(n, NUM_FEATURES, device=dev, dtype=torch.float32)
    SPLAT_BWD(_cuda.ptr(pts), _cuda.ptr(feats), _cuda.ptr(pix), n, p, diam2,
              float(depth_constant), _cuda.ptr(dv), _cuda.ptr(dn),
              _cuda.ptr(df), _cuda.stream(pts))
    return dv, dn, df


class _SurfelComposite(torch.autograd.Function):

    @staticmethod
    def forward(ctx, points_cam, normals_cam, features, kinv_grid, mask,
                diam2, depth_constant):
        n = points_cam.shape[0]
        pts = torch.cat([points_cam.float(), normals_cam.float(),
                         mask.float()[:, None],
                         points_cam.new_zeros(n, 1, dtype=torch.float32)],
                        1).contiguous()
        feats = features.float().contiguous()
        kg = kinv_grid.float()
        kg = torch.cat([kg, (kg * kg).sum(-1, keepdim=True)], 1).contiguous()
        img, m, d, zn = _fwd(pts, feats, kg, diam2, depth_constant)
        ctx.save_for_backward(pts, feats, kg, m, d, zn, img)
        ctx.consts = (diam2, depth_constant)
        return img

    @staticmethod
    def backward(ctx, g_img):
        pts, feats, kg, m, d, zn, img = ctx.saved_tensors
        g = g_img.float()
        # softmax correction sum_i p_ip (g_p . f_i) == g_p . img_p
        corr = (g * img).sum(-1, keepdim=True)
        pix = torch.cat([kg, m[:, None], d[:, None], zn[:, None], corr, g],
                        1).contiguous()
        dv, dn, df = _bwd(pts, feats, pix, *ctx.consts)
        return dv, dn, df, None, None, None, None


def surfel_composite(points_cam: torch.Tensor, normals_cam: torch.Tensor,
                     features: torch.Tensor, kinv_grid: torch.Tensor,
                     point_mask: torch.Tensor | None = None,
                     diam: float = 0.04, depth_constant: float = 150.0
                     ) -> torch.Tensor:
    """Fused splat_surfel(softclamp=False, add_bg=False) + prob.T @ feats:
    (N,3) points, (N,3) normals, (N,8) features, (P,3) pixel rays ->
    (P, 8). Gradients reach points, normals and features, not the rays."""
    if features.shape[-1] != NUM_FEATURES:
        raise ValueError(f"features: {features.shape[-1]} channels, "
                         f"expected {NUM_FEATURES}")
    if points_cam.device.type == "cpu":
        return splat_ops.surfel_composite_dense(
            points_cam, normals_cam, features, kinv_grid, point_mask, diam,
            depth_constant)
    mask = (torch.ones(points_cam.shape[0], device=points_cam.device)
            if point_mask is None else point_mask.detach())
    # diam^2 rounds once, as the TPU kernel's Python-float diam * diam does
    return _SurfelComposite.apply(points_cam, normals_cam, features,
                                  kinv_grid.detach(), mask,
                                  float(diam * diam),
                                  depth_constant).to(points_cam.dtype)
