"""Stage-1 band-selection decode kernel (kernel 3) and its plain version.

Counterpart of sdflabel_tpu/ops/mlp_pallas.py. ``pack_select_mlp`` folds a
DeepSDF decoder into the kernel's layout under the same rules as the JAX
packer (None for LayerNorm nets, widths that are not multiples of 128,
latent re-injection at the first or last layer, ...). The kernel lives in
csrc/select_mlp.cu; its source note says what bounds it on the H100.

Selection only ranks |sdf|: every selected point is decoded again exactly
in stage 2, so the kernel runs under ``torch.no_grad`` and has no VJP.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import _cuda

_MAX_WEIGHT_BYTES = 12 * 1024 * 1024  # the JAX packer's VMEM budget
# Widest hidden layer whose 16-point activation tile (bf16 + fp32
# accumulator) fits in a block's shared memory (select_mlp_tile).
_MAX_WIDTH = 2304

SELECT_MLP = _cuda.CudaKernel("select_mlp", "select_mlp", [_cuda.P] * 6 + [
    _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P])


class PackedSelectMLP(NamedTuple):
    """Folded decoder in the kernel's layout (see the JAX PackedSelectMLP).

    ws (nh, H, H) bf16 [in, out]; wx (nh+1, 4, H), wlat (nh+1, L, H),
    bias (nh+1, H), wlast (1, H), scal (1, 4) float32; zero-padded.
    """

    ws: torch.Tensor
    wx: torch.Tensor
    wlat: torch.Tensor
    bias: torch.Tensor
    wlast: torch.Tensor
    scal: torch.Tensor
    width: int
    n_hidden: int
    use_tanh: bool


def pack_select_mlp(cfg: deepsdf.DeepSDFConfig,
                    params: dict) -> PackedSelectMLP | None:
    """Pack a decoder for the kernel, or None outside its contract.

    Weight-norm folds in the parameters' own dtype, so a decoder already
    cast to bf16 (the float16 precision map) packs after that cast, as the
    JAX runtime does."""
    n_lin = cfg.num_layers - 1
    last = n_lin - 1
    nh = last - 1
    if nh < 1 or 0 in cfg.latent_in or last in cfg.latent_in:
        return None
    if (not cfg.weight_norm) and cfg.norm_layers:
        return None
    H = max(int(d) for d in cfg.layer_dims[1:-1])
    if H % 128 != 0 or H > _MAX_WIDTH:
        return None
    if nh * H * H * 2 > _MAX_WEIGHT_BYTES:
        return None
    L = cfg.latent_size
    device = params["lin0"]["b"].device
    folded = deepsdf.fold_weight_norm(params)

    def w_b(l):
        p = folded[f"lin{l}"]
        return (p["w"].float().cpu().numpy(), p["b"].float().cpu().numpy())

    def tail(l, in_dim):
        if l == 0:
            return 0, True, True
        if l in cfg.latent_in:
            return in_dim - (L + 3), True, True
        if cfg.xyz_in_all:
            return in_dim - 3, False, True
        return in_dim, False, False

    ws = np.zeros((nh, H, H), np.float32)
    wx = np.zeros((nh + 1, 4, H), np.float32)
    wlat = np.zeros((nh + 1, L, H), np.float32)
    bias = np.zeros((nh + 1, H), np.float32)
    for l in range(last):
        in_dim, out_dim = cfg.layer_io(l)
        w, b = w_b(l)
        x_part, has_lat, has_xyz = tail(l, in_dim)
        if x_part > H or out_dim > H:
            return None
        if l > 0:
            ws[l - 1, :x_part, :out_dim] = w[:x_part]
        pos = x_part
        if has_lat:
            wlat[l, :, :out_dim] = w[pos:pos + L]
            pos += L
        if has_xyz:
            wx[l, :3, :out_dim] = w[pos:pos + 3]
        bias[l, :out_dim] = b

    in_dim, out_dim = cfg.layer_io(last)
    if out_dim != 1:
        return None
    w, b = w_b(last)
    x_part, has_lat, has_xyz = tail(last, in_dim)
    if has_lat or x_part > H:
        return None
    wlast = np.zeros((1, H), np.float32)
    wlast[0, :x_part] = w[:x_part, 0]
    scal = np.zeros((1, 4), np.float32)
    scal[0, 0] = b[0]
    if has_xyz:
        scal[0, 1:4] = w[x_part:x_part + 3, 0]

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()

    return PackedSelectMLP(
        ws=dev(ws, torch.bfloat16), wx=dev(wx), wlat=dev(wlat),
        bias=dev(bias), wlast=dev(wlast), scal=dev(scal), width=H,
        n_hidden=nh, use_tanh=bool(cfg.use_tanh))


def _cvec(packed: PackedSelectMLP, latent: torch.Tensor) -> torch.Tensor:
    # per-call latent absorption c_j = b_j + latent @ Wlat_j
    return packed.bias + torch.einsum("l,jlh->jh", latent.float(),
                                      packed.wlat)


def emulate_select_mlp(packed: PackedSelectMLP, latent: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (mlp_pallas.py:275-299): same casts,
    same order of operations.

    The hidden products take bf16-rounded operands with fp32 accumulation.
    A bf16 x bf16 torch.matmul would round its result to bf16, so the
    operands are rounded to bf16 and then upcast: the fp32 product of two
    bf16 values is exact, and the sum accumulates in fp32 as on the card.
    """
    xyz = points.float()
    cvec = _cvec(packed, latent)
    x = [xyz[:, k:k + 1] for k in range(3)]

    def xc(j):
        return (x[0] * packed.wx[j, 0:1, :] + x[1] * packed.wx[j, 1:2, :]
                + x[2] * packed.wx[j, 2:3, :])

    h = torch.relu(cvec[0:1, :] + xc(0))
    for j in range(packed.n_hidden):
        acc = h.to(torch.bfloat16).float() @ packed.ws[j].float()
        h = torch.relu(acc + cvec[j + 1:j + 2, :] + xc(j + 1))
    s = (h * packed.wlast[0:1, :]).sum(1, keepdim=True)
    s = s + packed.scal[0, 0]
    s = (s + x[0] * packed.scal[0, 1] + x[1] * packed.scal[0, 2]
         + x[2] * packed.scal[0, 3])
    s = torch.tanh(s)
    if packed.use_tanh:
        s = torch.tanh(s)
    return s[:, 0]


def select_mlp_apply(packed: PackedSelectMLP, latent: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """(N, 3) points -> (N,) float32 sdf ranks. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if points.device.type == "cpu":
        return emulate_select_mlp(packed, latent, points)
    dev = points.device
    H, nh = packed.width, packed.n_hidden
    xyz = points.float().contiguous()
    cvec = _cvec(packed, latent).contiguous()
    wlast = packed.wlast.reshape(-1)
    scal = packed.scal.reshape(-1)
    n = xyz.shape[0]
    _cuda.check("points", xyz, torch.float32, (n, 3), dev)
    _cuda.check("ws", packed.ws, torch.bfloat16, (nh, H, H), dev)
    _cuda.check("wx", packed.wx, torch.float32, (nh + 1, 4, H), dev)
    _cuda.check("cvec", cvec, torch.float32, (nh + 1, H), dev)
    _cuda.check("wlast", wlast, torch.float32, (H,), dev)
    _cuda.check("scal", scal, torch.float32, (4,), dev)
    out = torch.empty(n, device=dev, dtype=torch.float32)
    SELECT_MLP(_cuda.ptr(xyz), _cuda.ptr(packed.ws), _cuda.ptr(packed.wx),
               _cuda.ptr(cvec), _cuda.ptr(wlast), _cuda.ptr(scal), n, H, nh,
               int(packed.use_tanh), _cuda.ptr(out), _cuda.stream(xyz))
    return out


def select_fn(cfg: deepsdf.DeepSDFConfig, params: dict):
    """``select_decoder(latent, points) -> (N,) float32`` backed by the
    kernel, or None when the architecture is outside its contract."""
    packed = pack_select_mlp(cfg, params)
    if packed is None:
        return None

    @torch.no_grad()
    def fn(latent, points):
        return select_mlp_apply(packed, latent, points)

    return fn
