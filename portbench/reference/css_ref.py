"""Plain PyTorch reference of the CSS network's training step at fp32
(sdflabel's networks/resnet_css.py + unet_parts.py, trained by
pipelines/train_css.py).

The net: a ResNet18 trunk (conv 7x7/2, BN, max-pool, layer1..layer3 of two
basic blocks each; layer4 is never called) with a 1x1 latent head
averaged over the image and put on the unit sphere, and four U-Net heads
(u, v, w of 256 bins, mask of 2) of four bilinear-upsample (align
corners) + skip + double conv 3x3 stages and a 1x1 output conv. BatchNorm
in train mode normalises with the batch mean and the biased variance
E[x^2] - E[x]^2 (flax's fast variance) and moves its running statistics
by momentum 0.9. Parameter names follow the port's flax-shaped tree, so
one state dict loads into both.

The step: the four cross-entropies (torch's mean CE on the raw logits
times the mask; the mask head's counted twice) and the latent MSE, the
gradients of every parameter but the frozen conv1 / bn1 / layer1, and
optax's Adam (lr, b1 0.9, b2 0.999, eps 1e-8) on them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FROZEN = ("conv1", "bn1", "layer1_0", "layer1_1")
HEADS = (("u", 256), ("v", 256), ("w", 256), ("mask", 2))


def _interp(n_in: int, n_out: int) -> np.ndarray:
    w = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        w[:, 0] = 1.0
        return w
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        w[i, lo] += 1.0 - (src - lo)
        w[i, hi] += src - lo
    return w


def up2(x):
    _, _, h, w = x.shape
    wy = torch.as_tensor(_interp(h, 2 * h), device=x.device)
    wx = torch.as_tensor(_interp(w, 2 * w), device=x.device)
    return torch.einsum("ow,nchw->ncho", wx,
                        torch.einsum("oh,nchw->ncow", wy, x))


class BN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        mean = x.mean((0, 2, 3))
        var = torch.clamp((x * x).mean((0, 2, 3)) - mean * mean, min=0.0)
        with torch.no_grad():
            self.mean.copy_(0.9 * self.mean + 0.1 * mean)
            self.var.copy_(0.9 * self.var + 0.1 * var)
        mul = torch.rsqrt(var + 1e-5) * self.scale
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, bias=False, pad=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.pad = stride, k // 2 if pad is None else pad

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.pad)


class Block(nn.Module):
    def __init__(self, cin, planes, stride=1, down=False):
        super().__init__()
        self.Conv_0 = Conv(cin, planes, 3, stride)
        self.TorchBatchNorm_0 = BN(planes)
        self.Conv_1 = Conv(planes, planes, 3)
        self.TorchBatchNorm_1 = BN(planes)
        self.down = down
        if down:
            self.Conv_2 = Conv(cin, planes, 1, stride, pad=0)
            self.TorchBatchNorm_2 = BN(planes)

    def forward(self, x):
        out = torch.relu(self.TorchBatchNorm_0(self.Conv_0(x)))
        out = self.TorchBatchNorm_1(self.Conv_1(out))
        res = self.TorchBatchNorm_2(self.Conv_2(x)) if self.down else x
        return torch.relu(out + res)


class Double(nn.Module):
    def __init__(self, cin, f):
        super().__init__()
        self.Conv_0 = Conv(cin, f, 3, bias=True)
        self.TorchBatchNorm_0 = BN(f)
        self.Conv_1 = Conv(f, f, 3, bias=True)
        self.TorchBatchNorm_1 = BN(f)

    def forward(self, x):
        x = torch.relu(self.TorchBatchNorm_0(self.Conv_0(x)))
        return torch.relu(self.TorchBatchNorm_1(self.Conv_1(x)))


class Up(nn.Module):
    def __init__(self, cin, f, shortcut=True):
        super().__init__()
        self.shortcut = shortcut
        self.DoubleConv_0 = Double(cin, f)

    def forward(self, x1, x2):
        x1 = up2(x1)
        return self.DoubleConv_0(torch.cat([x2, x1], 1) if self.shortcut
                                 else x1)


class CSS(nn.Module):
    def __init__(self, width=64, latent=3):
        super().__init__()
        wd = width
        self.conv1 = Conv(3, wd, 7, 2, pad=3)
        self.bn1 = BN(wd)
        self.layer1_0, self.layer1_1 = Block(wd, wd), Block(wd, wd)
        self.layer2_0 = Block(wd, 2 * wd, 2, True)
        self.layer2_1 = Block(2 * wd, 2 * wd)
        self.layer3_0 = Block(2 * wd, 4 * wd, 2, True)
        self.layer3_1 = Block(4 * wd, 4 * wd)
        self.out_lat = Conv(4 * wd, latent, 1, bias=True)
        for name, ch in HEADS:
            setattr(self, f"up1_{name}", Up(6 * wd, 2 * wd))
            setattr(self, f"up2_{name}", Up(3 * wd, wd))
            setattr(self, f"up3_{name}", Up(2 * wd, wd))
            setattr(self, f"up4_{name}", Up(wd, wd, shortcut=False))
            setattr(self, f"out_{name}", Conv(wd, ch, 1, bias=True))

    def forward(self, x):
        x1 = torch.relu(self.bn1(self.conv1(x)))
        x2 = F.max_pool2d(x1, 3, 2, 1)
        x3 = self.layer2_1(self.layer2_0(self.layer1_1(self.layer1_0(x2))))
        x4 = self.layer3_1(self.layer3_0(x3))
        lat = self.out_lat(x4).mean((2, 3))
        lat = lat / (torch.linalg.norm(lat, dim=-1, keepdim=True).detach()
                     + 1e-8)
        out = {"latent": lat}
        for name, _ in HEADS:
            h = getattr(self, f"up1_{name}")(x4, x3)
            h = getattr(self, f"up2_{name}")(h, x2)
            h = getattr(self, f"up3_{name}")(h, x1)
            h = getattr(self, f"up4_{name}")(h, x)
            out[name] = getattr(self, f"out_{name}")(h)
        return out


def trainable(name: str) -> bool:
    return name.split(".")[0] not in FROZEN


def ce(logits, target):
    logp = torch.log_softmax(logits, 1)
    return -logp.gather(1, target.long()[:, None]).mean()


def losses(out: dict, batch: dict) -> torch.Tensor:
    """train_css.py:70-80 on raw logits: the u, v, w CE of the masked logits
    against the masked targets, twice the mask CE, the latent MSE."""
    m = batch["mask"].long()
    uvw = batch["uvw"].long()
    me = m[:, None].float()
    loss = sum(ce(out[k] * me, uvw[:, i] * m)
               for i, k in enumerate(("u", "v", "w")))
    loss = loss + 2.0 * ce(out["mask"], m)
    return loss + torch.mean(torch.square(out["latent"] - batch["latent"]))


def normalize(rgb_u8):
    """uint8 (B, 3, H, W) -> ImageNet-normalised float32."""
    mean = torch.tensor([0.485, 0.456, 0.406], device=rgb_u8.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=rgb_u8.device)
    return (rgb_u8.float() / 255.0 - mean[:, None, None]) / std[:, None,
                                                                None]


def train_steps(model: CSS, batches: list, lr: float):
    """Step `model` (train mode) on each device batch; returns each step's
    loss, the first step's gradients and the parameters after, both in the
    order of the trainable named parameters."""
    names = [n for n, p in model.named_parameters() if trainable(n)]
    params = dict(model.named_parameters())
    for n, p in params.items():
        p.requires_grad_(trainable(n))
    model.train()
    mu = [torch.zeros_like(params[n]) for n in names]
    nu = [torch.zeros_like(params[n]) for n in names]
    b1, b2, eps = 0.9, 0.999, 1e-8
    out_losses, first = [], None
    for t, batch in enumerate(batches, 1):
        loss = losses(model(normalize(batch["rgb"])), batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        if first is None:
            first = [g.detach().clone() for g in grads]
        bc1 = float(np.float32(1) - np.float32(b1) ** np.int32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.int32(t))
        with torch.no_grad():
            for i, n in enumerate(names):
                mu[i] = b1 * mu[i] + (1 - b1) * grads[i]
                nu[i] = b2 * nu[i] + (1 - b2) * (grads[i] * grads[i])
                params[n] += -lr * ((mu[i] / bc1)
                                    / (torch.sqrt(nu[i] / bc2) + eps))
        out_losses.append(float(loss.detach()))
    return out_losses, first, [params[n].detach().clone() for n in names]
