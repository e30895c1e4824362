"""Fused-head CSS network: the four UNet decoder towers as grouped convs.

Counterpart of sdflabel_tpu/models/css_fused.py. The u, v, w and mask
heads of models/css.py::CSSNet each run a full UNet up-path; here they run
as one tower of grouped convolutions (``groups=4``):

- the first conv of up1 takes the shared input cat(x3, up(x4)), so the
  four heads' kernels stack along the output channels into one dense
  384 -> 4 x 128 conv;
- every other conv is per head: its kernels stack into a grouped conv,
  whose inputs lie as [skip | head_i] per group (the shared skip tiled
  across the groups, :func:`tile_skip_per_group`);
- BatchNorm is per channel, so one norm over the concatenated heads is
  the four heads' norms.

Like the JAX module it is fp32 only and fixed at the reference width 64
and latent size 3. It has CSSNet's outputs; :func:`fuse_css_state` maps a
CSSNet's weights onto it, and :func:`params_from_jax` carries the JAX
package's fused variables across (the module names follow the flax tree).
"""

from __future__ import annotations

import torch
from torch import nn

from sdflabel_tpu_torch.models import css as css_mod
from sdflabel_tpu_torch.models.css import Conv, TorchBatchNorm

HEADS = ("u", "v", "w", "mask")
G = len(HEADS)


class GroupedDoubleConv(nn.Module):
    """(grouped conv 3x3 -> BN -> ReLU) x2 over the G head groups; the
    first conv is dense over a shared input with `first_dense`."""

    def __init__(self, cin: int, features_per_group: int,
                 first_dense: bool = False):
        super().__init__()
        f = features_per_group * G
        self.Conv_0 = Conv(cin, f, 3, bias=True,
                           groups=1 if first_dense else G)
        self.TorchBatchNorm_0 = TorchBatchNorm(f)
        self.Conv_1 = Conv(f, f, 3, bias=True, groups=G)
        self.TorchBatchNorm_1 = TorchBatchNorm(f)

    def forward(self, x):
        x = torch.relu(self.TorchBatchNorm_0(self.Conv_0(x)))
        return torch.relu(self.TorchBatchNorm_1(self.Conv_1(x)))


def tile_skip_per_group(skip: torch.Tensor, per_head: torch.Tensor,
                        head_ch: int) -> torch.Tensor:
    """[skip | head_i] laid out per group for a grouped conv: skip
    (B, S, H, W) shared, per_head (B, G * head_ch, H, W) ->
    (B, G * (S + head_ch), H, W)."""
    parts = []
    for g in range(G):
        parts.append(skip)
        parts.append(per_head[:, g * head_ch:(g + 1) * head_ch])
    return torch.cat(parts, dim=1)


class CSSNetFused(nn.Module):
    """CSSNet with the four decoder heads fused (css_fused.py:70); built
    in eval mode, its weights at zero (:func:`fuse_css_state`,
    :func:`params_from_jax`)."""

    def __init__(self, sm_hardness: float = 100.0):
        super().__init__()
        self.sm_hardness = sm_hardness
        self.latent_size = 3
        self.conv1 = Conv(3, 64, 7, 2, pad=3)
        self.bn1 = TorchBatchNorm(64)
        self.layer1_0 = css_mod.BasicBlock(64, 64)
        self.layer1_1 = css_mod.BasicBlock(64, 64)
        self.layer2_0 = css_mod.BasicBlock(64, 128, 2, True)
        self.layer2_1 = css_mod.BasicBlock(128, 128)
        self.layer3_0 = css_mod.BasicBlock(128, 256, 2, True)
        self.layer3_1 = css_mod.BasicBlock(256, 256)
        self.out_lat = Conv(256, 3, 1, bias=True)
        self.up1 = GroupedDoubleConv(384, 128, first_dense=True)
        self.up2 = GroupedDoubleConv(G * (64 + 128), 64)
        self.up3 = GroupedDoubleConv(G * (64 + 64), 64)
        self.up4 = GroupedDoubleConv(G * 64, 64)
        for name in HEADS:
            setattr(self, f"out_{name}",
                    Conv(64, 2 if name == "mask" else 256, 1, bias=True))
        self.eval()

    backbone = css_mod.CSSNet.backbone

    def forward(self, x, decode: bool = True):
        """CSSNet's outputs (:meth:`models.css.CSSNet.forward`)."""
        (x1, x2, x3, x4), latent = self.backbone(x)
        up = css_mod.upsample2x_align_corners
        h = self.up1(torch.cat([x3, up(x4)], dim=1))
        h = self.up2(tile_skip_per_group(x2, up(h), 128))
        h = self.up3(tile_skip_per_group(x1, up(h), 64))
        h = self.up4(up(h))
        out = {("mask" if name == "mask" else f"{name}_raw"):
               getattr(self, f"out_{name}")(h[:, g * 64:(g + 1) * 64])
               for g, name in enumerate(HEADS)}
        out["latent"] = latent
        return (css_mod.decode_heads(out, self.sm_hardness, x.dtype)
                if decode else out)


def fuse_css_state(model: css_mod.CSSNet) -> dict:
    """A :class:`CSSNetFused` state dict holding a width-64, latent-3
    CSSNet's weights and statistics (css_fused.py::fuse_css_variables):
    the shared layers as they are, each decoder conv's and norm's four
    heads concatenated along the output channels."""
    src = model.state_dict()
    out = {k: v for k, v in src.items() if not k.startswith("up")}
    for i in (1, 2, 3, 4):
        for key in ("Conv_0.weight", "Conv_0.bias", "Conv_1.weight",
                    "Conv_1.bias"):
            out[f"up{i}.{key}"] = torch.cat(
                [src[f"up{i}_{h}.DoubleConv_0.{key}"] for h in HEADS])
        for j in (0, 1):
            for key in ("scale", "bias", "mean", "var"):
                out[f"up{i}.TorchBatchNorm_{j}.{key}"] = torch.cat(
                    [src[f"up{i}_{h}.DoubleConv_0.TorchBatchNorm_{j}.{key}"]
                     for h in HEADS])
    return out


def fused_from_css(model: css_mod.CSSNet) -> CSSNetFused:
    """A :class:`CSSNetFused` with `model`'s weights, on its device."""
    dev = next(model.parameters()).device
    fused = CSSNetFused(model.sm_hardness)
    fused.load_state_dict(fuse_css_state(model), strict=True)
    return fused.to(dev)


def params_from_jax(variables: dict, device="cpu") -> CSSNetFused:
    """A :class:`CSSNetFused` holding the JAX package's CSSNetFused
    variables {'params', 'batch_stats'} (numpy leaves)."""
    model = CSSNetFused()
    model.load_state_dict(css_mod.state_from_flax(variables), strict=True)
    return model.to(device).eval()
