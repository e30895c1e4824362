"""Stage-1 band-selection decode kernel (kernel 3) and its plain version.

Counterpart of sdflabel_tpu/ops/mlp_pallas.py. ``pack_select_mlp`` folds a
DeepSDF decoder into the kernel's layout under the same rules as the JAX
packer (None for LayerNorm nets, widths that are not multiples of 128,
latent re-injection at the first or last layer, ...). The kernel lives in
csrc/select_mlp.cu; its source note says what bounds it on the H100. Two
designs compute it, chosen by width: the wgmma design (csrc/mlp_wgmma.cuh)
for H <= 512, which reads the stack as pre-packed slices (``tile_stack``),
and the first, wmma design for wider layers. Each counts its own launches;
``SELECT_MLP`` counts both.

Selection only ranks |sdf|: every selected point is decoded again exactly
in stage 2, so the kernel runs under ``torch.no_grad`` and has no VJP.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import _cuda

_MAX_WEIGHT_BYTES = 12 * 1024 * 1024  # the JAX packer's VMEM budget
# Widest hidden layer whose 16-point activation tile (bf16 + fp32
# accumulator) fits in a block's shared memory (select_mlp_tile).
_MAX_WIDTH = 2304
# Widest layer of the wgmma design: H / 2 columns per warpgroup, the widest
# wgmma N (csrc/mlp_wgmma.cuh).
WGMMA_MAX_WIDTH = 512
KS = 32  # K rows of one packed slice: one 64-byte swizzle row of bf16
# CTAs that share each weight slice: 2 was the fastest of 1, 2 and 4 on
# the H100 for kernels 3 and 4a (scripts/mlp_wgmma_ablation.py, PERF.md)
CLUSTER = 2

SELECT_MLP_WMMA = _cuda.CudaKernel("select_mlp", "select_mlp", [
    _cuda.P] * 6 + [_cuda.I] * 4 + [_cuda.P, _cuda.P])
SELECT_MLP_WGMMA = _cuda.CudaKernel("select_mlp", "select_mlp_wgmma", [
    _cuda.P] * 6 + [_cuda.I] * 5 + [_cuda.P, _cuda.P])
SELECT_MLP = _cuda.KernelGroup(wgmma=SELECT_MLP_WGMMA, wmma=SELECT_MLP_WMMA)


class PackedSelectMLP(NamedTuple):
    """Folded decoder in the kernel's layout (see the JAX PackedSelectMLP).

    ws (nh, H, H) bf16 [in, out]; wx (nh+1, 4, H), wlat (nh+1, L, H),
    bias (nh+1, H), wlast (1, H), scal (1, 4) float32; zero-padded.
    ws_tiles and ws_tiles_t (nh, H / KS, KS * H) bf16: ``tile_stack`` of
    ws_j^T and of ws_j, the wgmma design's forward and reverse operands;
    None above WGMMA_MAX_WIDTH. The plain versions read ws.
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
    ws_tiles: torch.Tensor | None = None
    ws_tiles_t: torch.Tensor | None = None


def _chunk_source(n_rows: int, device) -> torch.Tensor:
    """(N, KS/8): the 16-byte chunk of row n that image chunk c holds,
    c ^ ((n >> 1) & 3): the 64-byte swizzle of a shared-memory address
    (chunk bits 4-5 XOR bits 7-8)."""
    n = torch.arange(n_rows, device=device)[:, None]
    c = torch.arange(KS // 8, device=device)[None, :]
    return c ^ ((n >> 1) & 3)


def tile_stack(mats: torch.Tensor) -> torch.Tensor:
    """(L, N, K) -> (L, K / KS, N * KS), the same dtype.

    Row n of mats[l] holds the K inputs of output n (B^T of the product
    A @ B). Slice s of the result is the shared-memory image that wgmma
    reads as its K-major B operand with the 64-byte swizzle: rows n of
    KS = 32 values (64 bytes) at n * 64 bytes, the 16-byte chunks of each
    row permuted by ``_chunk_source``. One slice is one contiguous block,
    so the kernel's ring takes it with a single bulk copy."""
    L, N, K = mats.shape
    x = mats.reshape(L, N, K // KS, KS // 8, 8).permute(0, 2, 1, 3, 4)
    rows = torch.arange(N, device=mats.device)[:, None]
    x = x[:, :, rows, _chunk_source(N, mats.device), :]
    return x.reshape(L, K // KS, N * KS).contiguous()


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

    ws_b = dev(ws, torch.bfloat16)
    tiles = tiles_t = None
    if H <= WGMMA_MAX_WIDTH:
        tiles = tile_stack(ws_b.transpose(1, 2))
        tiles_t = tile_stack(ws_b)
    return PackedSelectMLP(
        ws=ws_b, wx=dev(wx), wlat=dev(wlat), bias=dev(bias),
        wlast=dev(wlast), scal=dev(scal), width=H, n_hidden=nh,
        use_tanh=bool(cfg.use_tanh), ws_tiles=tiles, ws_tiles_t=tiles_t)


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


@functools.lru_cache(maxsize=None)
def _wgmma_fits(H: int) -> bool:
    return bool(_cuda.query("select_mlp", "select_mlp_wgmma_fits", H))


def select_design(packed: PackedSelectMLP) -> str:
    """The kernel design that computes `packed`'s width: "wgmma" or
    "wmma". Asks the library (built on first use)."""
    if packed.ws_tiles is not None and _wgmma_fits(packed.width):
        return "wgmma"
    return "wmma"


def select_fwd(packed: PackedSelectMLP, cvec: torch.Tensor,
               xyz: torch.Tensor) -> torch.Tensor:
    """Kernel 3 on CUDA tensors: (N, 3) float32 points and the absorbed
    (nh+1, H) cvec -> (N,) float32, through ``select_design``'s kernel; the
    wgmma design shares each weight slice among CLUSTER CTAs."""
    dev = xyz.device
    H, nh = packed.width, packed.n_hidden
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
    args = (_cuda.ptr(packed.wx), _cuda.ptr(cvec), _cuda.ptr(wlast),
            _cuda.ptr(scal), n, H, nh, int(packed.use_tanh))
    if select_design(packed) == "wgmma":
        _cuda.check("ws_tiles", packed.ws_tiles, torch.bfloat16,
                    (nh, H // KS, KS * H), dev)
        SELECT_MLP_WGMMA(_cuda.ptr(xyz), _cuda.ptr(packed.ws_tiles), *args,
                         CLUSTER, _cuda.ptr(out), _cuda.stream(xyz))
    else:
        SELECT_MLP_WMMA(_cuda.ptr(xyz), _cuda.ptr(packed.ws), *args,
                        _cuda.ptr(out), _cuda.stream(xyz))
    return out


def select_mlp_apply(packed: PackedSelectMLP, latent: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """(N, 3) points -> (N,) float32 sdf ranks. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``select_fwd``)."""
    if points.device.type == "cpu":
        return emulate_select_mlp(packed, latent, points)
    return select_fwd(packed, _cvec(packed, latent).contiguous(),
                      points.float().contiguous())


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
