"""Fused stage-2 decode kernels (4a, 4b) and their plain version.

Counterpart of sdflabel_tpu/ops/mlp2_pallas.py. Stage 2 of every refine
iteration decodes the K selected band points again, differentiably, and
takes each point's SDF gradient for its normal (ops/grid.py
``_stage2_surface``). ``stage2_fn`` does both in one launch of kernel 4a,
and the loss backward in one launch of kernel 4b, which recomputes the
forward (csrc/stage2_mlp.cu; its source note says what bounds it). It
packs the decoder as the selection kernel does (``mlp_cuda.
pack_select_mlp``) and returns None outside that packer's contract.
Kernels 4a and 4b have two designs each, chosen by shape
(``stage2_fwd_design``, ``stage2_bwd_design``): the wgmma design of
csrc/mlp_wgmma.cuh for H in {128, 256, 384, 512} when its sign bits fit in
shared memory, else the first (wmma) design of csrc/stage2_mlp.cu; each
design counts its own launches, and ``STAGE2_FWD`` and ``STAGE2_BWD``
count both of theirs.

Numerics: bf16 operands and fp32 accumulation in the hidden products, fp32
activations between layers (the plain bf16 decoder path stores bf16, so
the kernel is slightly tighter than that path). The reverse sweeps cast
the cotangent to bf16 before each transposed product, as the TPU kernels
do, and so does the plain version's backward (``_Bf16Product``); JAX's
emulate_stage2, whose autodiff rounds the product's result instead,
differs from both by up to ~0.5% of the largest gradient at 8x512.

Gradients flow to the latent (through the cvec absorption, which stays in
torch) and to the points. The normals output carries no gradient: its
cotangent is ignored, as the engine detaches the normals.
"""

from __future__ import annotations

import functools

import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import _cuda
from sdflabel_tpu_torch.ops.mlp_cuda import (CLUSTER, KS, PackedSelectMLP,
                                             _cvec, pack_select_mlp)

STAGE2_FWD_WMMA = _cuda.CudaKernel("stage2_mlp", "stage2_fwd", [
    _cuda.P] * 6 + [_cuda.I] * 4 + [_cuda.P, _cuda.P])
STAGE2_FWD_WGMMA = _cuda.CudaKernel("stage2_mlp", "stage2_fwd_wgmma", [
    _cuda.P] * 7 + [_cuda.I] * 5 + [_cuda.P, _cuda.P])
STAGE2_FWD = _cuda.KernelGroup(wgmma=STAGE2_FWD_WGMMA, wmma=STAGE2_FWD_WMMA)
STAGE2_BWD_WMMA = _cuda.CudaKernel("stage2_mlp", "stage2_bwd", [
    _cuda.P] * 7 + [_cuda.I] * 4 + [_cuda.P] * 4)
STAGE2_BWD_WGMMA = _cuda.CudaKernel("stage2_mlp", "stage2_bwd_wgmma", [
    _cuda.P] * 8 + [_cuda.I] * 5 + [_cuda.P] * 4)
STAGE2_BWD = _cuda.KernelGroup(wgmma=STAGE2_BWD_WGMMA, wmma=STAGE2_BWD_WMMA)


class _Bf16Product(torch.autograd.Function):
    """h @ w with bf16-rounded operands, products and sums in `dtype`
    (fp32 as in the kernels), the result fp32; the backward rounds the
    cotangent to bf16 before the transposed product, as the kernels'
    reverse sweeps do (mlp2_pallas.py:106-109). The weights are
    constants: they get no gradient."""

    @staticmethod
    def forward(ctx, h, w, dtype):
        ctx.save_for_backward(w)
        ctx.dtype = dtype
        return (h.to(torch.bfloat16).to(dtype) @ w.to(dtype)).float()

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        dt = ctx.dtype
        return (g.to(torch.bfloat16).to(dt) @ w.to(dt).T).float(), None, None


def stage2_plain(packed: PackedSelectMLP, cvec: torch.Tensor,
                 points: torch.Tensor,
                 sum_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(N,) sdf of the packed decoder, differentiable in cvec and points:
    the casts and the order of operations of mlp2_pallas.py:279-300, the
    backward's bf16 cotangent of the kernels. `sum_dtype` float64 sums the
    hidden products' same bf16 operands exactly, a yardstick of how far
    fp32 summation alone moves the outputs."""
    xyz = points.float()
    x = [xyz[:, k:k + 1] for k in range(3)]

    def xc(j):
        return (x[0] * packed.wx[j, 0:1, :] + x[1] * packed.wx[j, 1:2, :]
                + x[2] * packed.wx[j, 2:3, :])

    h = torch.relu(cvec[0:1, :] + xc(0))
    for j in range(packed.n_hidden):
        acc = _Bf16Product.apply(h, packed.ws[j], sum_dtype)
        h = torch.relu(acc + cvec[j + 1:j + 2, :] + xc(j + 1))
    s = (h * packed.wlast[0:1, :]).sum(1, keepdim=True)
    s = s + packed.scal[0, 0]
    s = (s + x[0] * packed.scal[0, 1] + x[1] * packed.scal[0, 2]
         + x[2] * packed.scal[0, 3])
    s = torch.tanh(s)
    if packed.use_tanh:
        s = torch.tanh(s)
    return s[:, 0]


def emulate_stage2(packed: PackedSelectMLP, latent: torch.Tensor,
                   points: torch.Tensor):
    """Plain version of kernel 4a (mlp2_pallas.py:275-304): (sdf (N,),
    raw normals (N, 3)). The sdf keeps its graph to the latent and, when
    they carry one, to the points; the normals are autograd's gradient of
    the sdf with respect to the points, detached."""
    with torch.enable_grad():
        p = points if points.requires_grad else \
            points.detach().float().requires_grad_(True)
        sdf = stage2_plain(packed, _cvec(packed, latent), p)
        (g,) = torch.autograd.grad(sdf.sum(), p, retain_graph=True)
    return sdf, g.detach()


@functools.lru_cache(maxsize=8)
def _packed_device(packed: PackedSelectMLP) -> torch.device:
    """The device of `packed`'s tensors, once they are checked. A packed
    decoder does not change, so each is checked once: the checks cost as
    much host time as a launch, and 4a and 4b run every iteration."""
    dev = packed.ws.device
    H, nh = packed.width, packed.n_hidden
    _cuda.check("ws", packed.ws, torch.bfloat16, (nh, H, H), dev)
    _cuda.check("wx", packed.wx, torch.float32, (nh + 1, 4, H), dev)
    _cuda.check("wlast", packed.wlast, torch.float32, (1, H), dev)
    _cuda.check("scal", packed.scal, torch.float32, (1, 4), dev)
    if packed.ws_tiles is not None:
        for name in ("ws_tiles", "ws_tiles_t"):
            _cuda.check(name, getattr(packed, name), torch.bfloat16,
                        (nh, H // KS, KS * H), dev)
    return dev


def _check(packed: PackedSelectMLP, cvec: torch.Tensor, xyz: torch.Tensor):
    dev = xyz.device
    _cuda.check("points", xyz, torch.float32, (-1, 3), dev)
    _cuda.check("cvec", cvec, torch.float32,
                (packed.n_hidden + 1, packed.width), dev)
    if _packed_device(packed) != dev:
        raise ValueError(f"packed decoder: on {_packed_device(packed)}, "
                         f"expected {dev}")


@functools.lru_cache(maxsize=None)
def _wgmma_fits(kernel: str, H: int, nh: int) -> bool:
    return bool(_cuda.query("stage2_mlp", f"stage2_{kernel}_wgmma_fits", H,
                            nh))


def _design(packed: PackedSelectMLP, kernel: str) -> str:
    if packed.ws_tiles is not None and _wgmma_fits(kernel, packed.width,
                                                   packed.n_hidden):
        return "wgmma"
    return "wmma"


@functools.lru_cache(maxsize=64)
def _wgmma_blocks(n: int, cluster: int) -> int:
    return _cuda.query("stage2_mlp", "stage2_wgmma_blocks", n, cluster)


def stage2_fwd_design(packed: PackedSelectMLP) -> str:
    """Kernel 4a's design for `packed`'s shape: "wgmma" or "wmma". Asks
    the library (built on first use)."""
    return _design(packed, "fwd")


def stage2_bwd_design(packed: PackedSelectMLP) -> str:
    """Kernel 4b's design for `packed`'s shape, as stage2_fwd_design."""
    return _design(packed, "bwd")


def stage2_fwd(packed: PackedSelectMLP, cvec: torch.Tensor,
               xyz: torch.Tensor) -> torch.Tensor:
    """Kernel 4a: (N, 3) points -> (N, 4) [sdf, raw normal]; the wgmma
    design shares each weight slice among CLUSTER CTAs."""
    _check(packed, cvec, xyz)
    H, nh = packed.width, packed.n_hidden
    out = torch.empty(xyz.shape[0], 4, device=xyz.device,
                      dtype=torch.float32)
    args = (_cuda.ptr(packed.wx), _cuda.ptr(cvec), _cuda.ptr(packed.wlast),
            _cuda.ptr(packed.scal), xyz.shape[0], H, nh,
            int(packed.use_tanh))
    if stage2_fwd_design(packed) == "wgmma":
        STAGE2_FWD_WGMMA(_cuda.ptr(xyz), _cuda.ptr(packed.ws_tiles),
                         _cuda.ptr(packed.ws_tiles_t), *args, CLUSTER,
                         _cuda.ptr(out), _cuda.stream(xyz))
    else:
        STAGE2_FWD_WMMA(_cuda.ptr(xyz), _cuda.ptr(packed.ws), *args,
                        _cuda.ptr(out), _cuda.stream(xyz))
    return out


def stage2_bwd(packed: PackedSelectMLP, cvec: torch.Tensor,
               xyz: torch.Tensor, ct: torch.Tensor, design: str | None = None,
               cluster: int = CLUSTER):
    """Kernel 4b: the sdf's cotangent (N,) -> (d_cvec (nh+1, H),
    d_points (N, 3)). `design` None takes stage2_bwd_design's; the wgmma
    design shares each weight slice among `cluster` CTAs."""
    _check(packed, cvec, xyz)
    n, H, nh = xyz.shape[0], packed.width, packed.n_hidden
    _cuda.check("ct", ct, torch.float32, (n,), xyz.device)
    design = design or stage2_bwd_design(packed)
    if design == "wgmma":
        blocks = _wgmma_blocks(n, cluster)
    else:
        tile = _cuda.query("stage2_mlp", "stage2_tile", H, nh)
        if tile == 0:
            raise ValueError(f"stage2: width {H} does not fit a block")
        blocks = -(-n // tile)
    partial = torch.empty(max(blocks, 1) * (nh + 1) * H, device=xyz.device,
                          dtype=torch.float32)
    dxyz = torch.empty(n, 3, device=xyz.device, dtype=torch.float32)
    dcvec = torch.empty(nh + 1, H, device=xyz.device, dtype=torch.float32)
    args = (_cuda.ptr(packed.wx), _cuda.ptr(cvec), _cuda.ptr(packed.wlast),
            _cuda.ptr(packed.scal), _cuda.ptr(ct), n, H, nh,
            int(packed.use_tanh))
    outs = (_cuda.ptr(dxyz), _cuda.ptr(dcvec), _cuda.ptr(partial),
            _cuda.stream(xyz))
    if design == "wgmma":
        STAGE2_BWD_WGMMA(_cuda.ptr(xyz), _cuda.ptr(packed.ws_tiles),
                         _cuda.ptr(packed.ws_tiles_t), *args, cluster, *outs)
    else:
        STAGE2_BWD_WMMA(_cuda.ptr(xyz), _cuda.ptr(packed.ws), *args, *outs)
    return dcvec, dxyz


def stage2_agreement(sdf, sdf_ref, grads):
    """(shares, medians) of a kernel's outputs against the plain version's.
    Shares: of sdf points within atol 2e-5 / rtol 1e-4
    (tests/test_mlp2_pallas.py:40-45), and for each (name, got, want) of
    `grads` of rows within 5e-3 of want's largest element (:90-102).
    Medians: of |got - want| over want's largest element. Shares and
    medians, not maxima: at 8x512 a last-ulp change of one fp32 sum flips a
    bf16 rounding that the next layers amplify, so summing the same bf16
    operands in fp64 instead of fp32 (``stage2_plain(sum_dtype=
    torch.float64)``, which chip_smoke.py phase 2 holds against the fp32
    plain version too) moves a few rows far while the medians stay near
    fp32 resolution."""
    shares = {"sdf": float(((sdf - sdf_ref).abs()
                            <= 2e-5 + 1e-4 * sdf_ref.abs()).float().mean())}
    medians = {"sdf": float((sdf - sdf_ref).abs().median())}
    for name, got, want in grads:
        err = (got - want).abs() / want.abs().max()
        shares[name] = float((err.reshape(err.shape[0], -1).amax(1) < 5e-3)
                             .float().mean())
        medians[name] = float(err.median())
    return shares, medians


class _Stage2(torch.autograd.Function):
    """(cvec, points) -> (sdf, raw normals) through kernels 4a and 4b.

    The normals output is not differentiable: its cotangent is ignored
    (the engine detaches the normals, optimizer.py:107)."""

    @staticmethod
    def forward(ctx, cvec, points, packed):
        xyz = points.float().contiguous()
        cvec = cvec.contiguous()
        out = stage2_fwd(packed, cvec, xyz)
        ctx.save_for_backward(cvec, xyz)
        ctx.packed = packed
        normals = out[:, 1:4].contiguous()
        ctx.mark_non_differentiable(normals)
        return out[:, 0].contiguous(), normals

    @staticmethod
    def backward(ctx, ct_sdf, _ct_normals):
        cvec, xyz = ctx.saved_tensors
        dcvec, dxyz = stage2_bwd(ctx.packed, cvec, xyz,
                                 ct_sdf.float().contiguous())
        return dcvec, dxyz if ctx.needs_input_grad[1] else None, None


def stage2_apply(packed: PackedSelectMLP, latent: torch.Tensor,
                 points: torch.Tensor):
    """(N, 3) points -> (sdf (N,), raw normals (N, 3)). CPU tensors take
    the plain version; CUDA tensors launch kernels 4a and 4b."""
    if points.device.type == "cpu":
        return emulate_stage2(packed, latent, points)
    sdf, g = _Stage2.apply(_cvec(packed, latent), points, packed)
    return sdf, g.detach()


def stage2_fn(cfg: deepsdf.DeepSDFConfig, params: dict):
    """``stage2(latent, points) -> (sdf (N,), raw normals (N, 3))`` for
    ops/grid.py's stage-2 seam (the counterpart of pallas_stage2_fn), or
    None when the architecture is outside the packer's contract."""
    packed = pack_select_mlp(cfg, params)
    if packed is None:
        return None

    def fn(latent, points):
        return stage2_apply(packed, latent, points)

    return fn
