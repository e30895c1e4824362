"""CSS network: ResNet18 encoder + 4 UNet decoder heads + spherical latent.

Counterpart of sdflabel_tpu/models/css.py (reference networks/resnet_css.py
and unet_parts.py), eval mode only. Tensors are NCHW throughout, as the
JAX module's inputs and outputs are. BatchNorm uses the running statistics
with torch semantics (eps 1e-5) in fp32. ``layer4`` is never called in the
reference forward (QUIRKS #12) and does not exist here.

Module and parameter names follow the flax variable tree (``conv1``,
``layer2_0``, ``up3_mask``, ``out_lat``, ...), so that
:func:`state_from_flax` maps the JAX package's checkpoints one leaf at a
time: HWIO kernels become OIHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdflabel_tpu_torch.utils import flax_msgpack


def _align_corners_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation matrix, align_corners=True."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        w[:, 0] = 1.0
        return w
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        frac = src - lo
        w[i, lo] += 1.0 - frac
        w[i, hi] += frac
    return w


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """NCHW 2x bilinear upsample with align_corners=True, as the JAX
    module's two interpolation matmuls (nn.Upsample semantics)."""
    _, _, h, w = x.shape
    wy = torch.as_tensor(_align_corners_weights(h, 2 * h), device=x.device)
    wx = torch.as_tensor(_align_corners_weights(w, 2 * w), device=x.device)
    x = torch.einsum("oh,nchw->ncow", wy, x)
    return torch.einsum("ow,nchw->ncho", wx, x)


def project_vecs_onto_sphere(vectors: torch.Tensor,
                             radius: float = 1.0) -> torch.Tensor:
    """Unit-sphere projection, surface_only=True (resnet_css.py:19-26)."""
    length = torch.linalg.norm(vectors, dim=-1, keepdim=True).detach()
    return vectors * (radius / (length + 1e-8))


class TorchBatchNorm(nn.Module):
    """Eval-mode BatchNorm with the flax formula
    (x - mean) * (rsqrt(var + eps) * scale) + bias, in fp32."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        mul = torch.rsqrt(self.var + 1e-5) * self.scale
        return ((x.float() - self.mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class Conv(nn.Module):
    """Square conv with 'same'-style k//2 padding (flax nn.Conv as the JAX
    module configures it). ``weight`` is OIHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = False, pad: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride
        self.pad = k // 2 if pad is None else pad

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.pad)


class BasicBlock(nn.Module):
    """ResNet basic block (resnet_css.py:29-57)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.Conv_0 = Conv(cin, planes, 3, stride)
        self.TorchBatchNorm_0 = TorchBatchNorm(planes)
        self.Conv_1 = Conv(planes, planes, 3)
        self.TorchBatchNorm_1 = TorchBatchNorm(planes)
        self.downsample = downsample
        if downsample:
            self.Conv_2 = Conv(cin, planes, 1, stride, pad=0)
            self.TorchBatchNorm_2 = TorchBatchNorm(planes)

    def forward(self, x):
        out = torch.relu(self.TorchBatchNorm_0(self.Conv_0(x)))
        out = self.TorchBatchNorm_1(self.Conv_1(out))
        residual = x
        if self.downsample:
            residual = self.TorchBatchNorm_2(self.Conv_2(x))
        return torch.relu(out + residual)


class DoubleConv(nn.Module):
    """(conv 3x3 -> BN -> ReLU) x2 (unet_parts.py:8-20)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, bias=True)
        self.TorchBatchNorm_0 = TorchBatchNorm(features)
        self.Conv_1 = Conv(features, features, 3, bias=True)
        self.TorchBatchNorm_1 = TorchBatchNorm(features)

    def forward(self, x):
        x = torch.relu(self.TorchBatchNorm_0(self.Conv_0(x)))
        return torch.relu(self.TorchBatchNorm_1(self.Conv_1(x)))


class Up(nn.Module):
    """Bilinear up + optional skip concat + double conv (unet_parts.py:43-68)."""

    def __init__(self, cin: int, features: int, add_shortcut: bool = True):
        super().__init__()
        self.add_shortcut = add_shortcut
        self.DoubleConv_0 = DoubleConv(cin, features)

    def forward(self, x1, x2):
        x1 = upsample2x_align_corners(x1)
        dh = x1.shape[2] - x2.shape[2]
        dw = x1.shape[3] - x2.shape[3]
        if dh or dw:
            x2 = F.pad(x2, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        x = torch.cat([x2, x1], dim=1) if self.add_shortcut else x1
        return self.DoubleConv_0(x)


class CSSNet(nn.Module):
    """ResNet18-FPN CSS network (resnet_css.py:104-262), eval mode.

    ``width`` scales every channel count (64 is the reference); the
    256 bins per NOCS channel never scale. Input (B, 3, 128, 128)."""

    HEADS = (("u", 256), ("v", 256), ("w", 256), ("mask", 2))

    def __init__(self, width: int = 64, latent_size: int = 3,
                 sm_hardness: float = 100.0):
        super().__init__()
        wd = width
        self.sm_hardness = sm_hardness
        self.latent_size = latent_size
        self.conv1 = Conv(3, wd, 7, 2, pad=3)
        self.bn1 = TorchBatchNorm(wd)
        self.layer1_0 = BasicBlock(wd, wd)
        self.layer1_1 = BasicBlock(wd, wd)
        self.layer2_0 = BasicBlock(wd, 2 * wd, 2, True)
        self.layer2_1 = BasicBlock(2 * wd, 2 * wd)
        self.layer3_0 = BasicBlock(2 * wd, 4 * wd, 2, True)
        self.layer3_1 = BasicBlock(4 * wd, 4 * wd)
        self.out_lat = Conv(4 * wd, latent_size, 1, bias=True)
        for name, out_ch in self.HEADS:
            setattr(self, f"up1_{name}", Up(4 * wd + 2 * wd, 2 * wd))
            setattr(self, f"up2_{name}", Up(2 * wd + wd, wd))
            setattr(self, f"up3_{name}", Up(wd + wd, wd))
            setattr(self, f"up4_{name}", Up(wd, wd, add_shortcut=False))
            setattr(self, f"out_{name}", Conv(wd, out_ch, 1, bias=True))
        self.eval()

    def forward(self, x):
        x1 = torch.relu(self.bn1(self.conv1(x)))
        x2 = F.max_pool2d(x1, 3, 2, 1)
        x3 = self.layer1_1(self.layer1_0(x2))
        x3 = self.layer2_1(self.layer2_0(x3))
        x4 = self.layer3_1(self.layer3_0(x3))

        latent = project_vecs_onto_sphere(self.out_lat(x4).mean(dim=(2, 3)))

        def head(name):
            h = getattr(self, f"up1_{name}")(x4, x3)
            h = getattr(self, f"up2_{name}")(h, x2)
            h = getattr(self, f"up3_{name}")(h, x1)
            h = getattr(self, f"up4_{name}")(h, x)
            return getattr(self, f"out_{name}")(h)

        u = torch.log_softmax(head("u"), dim=1)
        v = torch.log_softmax(head("v"), dim=1)
        w = torch.log_softmax(head("w"), dim=1)
        mask = head("mask")
        colors = torch.arange(256, device=x.device, dtype=x.dtype)

        def softmax_ftz(logits):
            # XLA flushes subnormals to zero; at hardness 100 the colour
            # probabilities reach them, and a pixel whose expected colour
            # is a subnormal product would count as non-black downstream
            # (reproject_np's filter_nocs). Flush as the JAX module does.
            prob = torch.softmax(logits * self.sm_hardness, dim=1)
            return torch.where(prob < torch.finfo(prob.dtype).tiny,
                               torch.zeros_like(prob), prob)

        def expected(logp):
            return (softmax_ftz(logp) * colors[:, None, None]).sum(
                1, keepdim=True)

        uvw_sm = torch.cat([expected(u), expected(v), expected(w)], dim=1)
        prob_mask = softmax_ftz(mask)
        mask_sm = (prob_mask * torch.arange(2, device=x.device, dtype=x.dtype)
                   [:, None, None]).sum(1, keepdim=True)
        hard_mask = torch.argmax(mask, dim=1, keepdim=True).to(x.dtype)
        return {"u": u, "v": v, "w": w, "uvw_sm": uvw_sm,
                "uvw_sm_masked": uvw_sm * hard_mask, "mask": mask,
                "mask_sm": mask_sm, "latent": latent}


def state_from_flax(variables: dict) -> dict:
    """The JAX package's CSS variables {'params', 'batch_stats'} (numpy
    leaves) -> a state dict for :class:`CSSNet`."""
    state: dict[str, torch.Tensor] = {}

    def walk(params, stats, prefix):
        for k, v in params.items():
            name = prefix + k
            if k == "BatchNorm_0":  # TorchBatchNorm's inner flax module
                bn = prefix[:-1]
                state[bn + ".scale"] = torch.as_tensor(v["scale"])
                state[bn + ".bias"] = torch.as_tensor(v["bias"])
                state[bn + ".mean"] = torch.as_tensor(stats[k]["mean"])
                state[bn + ".var"] = torch.as_tensor(stats[k]["var"])
            elif "kernel" in v:
                kernel = np.asarray(v["kernel"], np.float32)
                state[name + ".weight"] = torch.as_tensor(
                    np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
                if "bias" in v:
                    state[name + ".bias"] = torch.as_tensor(
                        np.asarray(v["bias"], np.float32))
            else:
                walk(v, stats.get(k, {}), name + ".")

    walk(variables["params"], variables["batch_stats"], "")
    return {k: t.float() for k, t in state.items()}


def params_from_jax(variables: dict, width: int, latent_size: int = 3,
                    device="cpu") -> CSSNet:
    """A :class:`CSSNet` holding the JAX package's CSS variables."""
    model = CSSNet(width=width, latent_size=latent_size)
    model.load_state_dict(state_from_flax(variables), strict=True)
    return model.to(device).eval()


def load_css(path: str, width: int, latent_size: int = 3,
             device="cuda") -> CSSNet:
    """Load a CSS checkpoint the JAX package wrote (flax msgpack)."""
    if not path.endswith(".msgpack"):
        raise ValueError(f"{path}: only flax msgpack CSS checkpoints load "
                         "in this package")
    return params_from_jax(flax_msgpack.load(path), width, latent_size,
                           device)
