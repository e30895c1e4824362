"""CSS network: ResNet18 encoder + 4 UNet decoder heads + spherical latent.

Counterpart of sdflabel_tpu/models/css.py (reference networks/resnet_css.py
and unet_parts.py). Tensors are NCHW throughout, as the JAX module's inputs
and outputs are. BatchNorm runs in fp32 with flax's formulas: in eval mode
(the default) on the running statistics, in train mode (``model.train()``,
the JAX module's ``use_running_average=False``) on the batch statistics,
which it also folds into the running ones. ``layer4`` is never called in
the reference forward (QUIRKS #12) and does not exist here.

Module and parameter names follow the flax variable tree (``conv1``,
``layer2_0``, ``up3_mask``, ``out_lat``, ...), so that
:func:`state_from_flax` maps the JAX package's checkpoints one leaf at a
time: HWIO kernels become OIHW; :func:`state_to_flax` maps them back.

``CSSNet.compute_dtype`` is the JAX module's ``dtype`` (mixed-precision
training): torch.bfloat16 runs every backbone and decoder conv in bf16 on
fp32 parameters, with the JAX module's casts (css.py:74-176): BatchNorm
takes its input as fp32 and returns fp32, the residual joins the block's
fp32 output, ``Up`` rounds its input to bf16 before the fp32 upsample,
and the latent head and the four 1x1 output convs stay fp32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdflabel_tpu_torch.parallel.mesh import all_reduce_sum
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
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) on fp32 input:
    (x - mean) * (rsqrt(var + eps) * scale) + bias.

    Train mode normalizes with the batch mean and the biased batch
    variance E[x^2] - E[x]^2 clipped at 0 (flax's use_fast_variance), and
    sets running = 0.9 running + (1 - 0.9) batch with that same variance;
    torch.nn.BatchNorm2d would keep the unbiased one. Gradients flow
    through the batch statistics, as in flax.

    ``sync`` (a process group and this rank's share of the global batch,
    set by a data-parallel step) makes the statistics those of the global
    batch, as XLA reduces them under JAX's pjit: the per-channel mean and
    E[x^2] of each rank, weighted by its share, are summed over the group
    in the forward, and their cotangents the same way in the backward."""

    MOMENTUM = 0.9

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.sync = None

    def forward(self, x):
        x = x.float()
        if self.training:
            mean = x.mean((0, 2, 3))
            ex2 = (x * x).mean((0, 2, 3))
            if self.sync is not None:
                group, share = self.sync
                mean, ex2 = all_reduce_sum(torch.stack([mean, ex2]) * share,
                                           group)
            var = torch.clamp(ex2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + 1e-5) * self.scale
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])


class Conv(nn.Module):
    """Square conv with 'same'-style k//2 padding (flax nn.Conv as the JAX
    module configures it). ``weight`` is OIHW. ``dtype`` is the compute
    dtype (flax's ``dtype``): in bf16 the input, kernel and bias are cast
    to it, and the bias is added to the rounded conv output, as flax
    does; ``mixed=False`` marks the convs that the JAX module builds
    without a dtype (fp32 always)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 bias: bool = False, pad: int | None = None,
                 groups: int = 1, mixed: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride
        self.pad = k // 2 if pad is None else pad
        self.groups = groups
        self.mixed = mixed
        self.dtype = torch.float32

    def forward(self, x):
        if self.dtype == torch.float32:
            return F.conv2d(x.float(), self.weight, self.bias, self.stride,
                            self.pad, groups=self.groups)
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                     self.stride, self.pad, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)[:, None, None]
        return y


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
        return torch.relu(out + residual.to(out.dtype))


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
        # rounded to the compute dtype, then upsampled by fp32 weights (jnp
        # promotes the JAX module's einsum to fp32)
        x1 = upsample2x_align_corners(
            x1.to(self.DoubleConv_0.Conv_0.dtype).float())
        dh = x1.shape[2] - x2.shape[2]
        dw = x1.shape[3] - x2.shape[3]
        if dh or dw:
            x2 = F.pad(x2, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
        x = torch.cat([x2.float(), x1], dim=1) if self.add_shortcut else x1
        return self.DoubleConv_0(x)


class CSSNet(nn.Module):
    """ResNet18-FPN CSS network (resnet_css.py:104-262), built in eval mode.

    ``width`` scales every channel count (64 is the reference); the
    256 bins per NOCS channel never scale. The compute dtype is set
    through :attr:`compute_dtype` (fp32 at first). Input (B, 3, 128, 128).
    The weights start at zero: :func:`init_params` draws flax's initial ones,
    :func:`state_from_flax` carries trained ones across."""

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
        self.out_lat = Conv(4 * wd, latent_size, 1, bias=True, mixed=False)
        for name, out_ch in self.HEADS:
            setattr(self, f"up1_{name}", Up(4 * wd + 2 * wd, 2 * wd))
            setattr(self, f"up2_{name}", Up(2 * wd + wd, wd))
            setattr(self, f"up3_{name}", Up(wd + wd, wd))
            setattr(self, f"up4_{name}", Up(wd, wd, add_shortcut=False))
            setattr(self, f"out_{name}", Conv(wd, out_ch, 1, bias=True,
                                              mixed=False))
        self.eval()

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.conv1.dtype

    @compute_dtype.setter
    def compute_dtype(self, dtype: torch.dtype) -> None:
        """torch.float32 or torch.bfloat16 for every conv but the fp32
        heads; the parameters stay fp32."""
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype} (float32 or bfloat16)")
        for mod in self.modules():
            if isinstance(mod, Conv) and mod.mixed:
                mod.dtype = dtype

    def backbone(self, x):
        """The ResNet trunk: (x1, x2, x3, x4) and the latent."""
        x1 = torch.relu(self.bn1(self.conv1(x)))
        x2 = F.max_pool2d(x1, 3, 2, 1)
        x3 = self.layer1_1(self.layer1_0(x2))
        x3 = self.layer2_1(self.layer2_0(x3))
        x4 = self.layer3_1(self.layer3_0(x3))
        latent = project_vecs_onto_sphere(self.out_lat(x4).mean(dim=(2, 3)))
        return (x1, x2, x3, x4), latent

    def forward(self, x, decode: bool = True):
        """Outputs as the JAX module's: the head logits ``u_raw``,
        ``v_raw``, ``w_raw``, ``mask`` and the ``latent``; with `decode`
        also their log-softmax ``u``, ``v``, ``w`` and the expected-colour
        decode ``uvw_sm``, ``uvw_sm_masked``, ``mask_sm`` (training on raw
        logits needs none of them)."""
        (x1, x2, x3, x4), latent = self.backbone(x)

        def head(name):
            h = getattr(self, f"up1_{name}")(x4, x3)
            h = getattr(self, f"up2_{name}")(h, x2)
            h = getattr(self, f"up3_{name}")(h, x1)
            h = getattr(self, f"up4_{name}")(h, x)
            return getattr(self, f"out_{name}")(h)

        u_raw, v_raw, w_raw, mask = (head(n) for n in ("u", "v", "w", "mask"))
        out = {"u_raw": u_raw, "v_raw": v_raw, "w_raw": w_raw, "mask": mask,
               "latent": latent}
        return decode_heads(out, self.sm_hardness, x.dtype) if decode else out


def decode_heads(out: dict, sm_hardness: float, dtype) -> dict:
    """`out` with the log-softmax ``u``, ``v``, ``w`` of its raw logits
    and the expected-colour decode ``uvw_sm``, ``uvw_sm_masked``,
    ``mask_sm`` (resnet_css.py:229-241) added."""
    u, v, w = (torch.log_softmax(out[k], dim=1)
               for k in ("u_raw", "v_raw", "w_raw"))
    mask = out["mask"]
    dev = mask.device
    colors = torch.arange(256, device=dev, dtype=dtype)

    def softmax_ftz(logits):
        # XLA flushes subnormals to zero; at hardness 100 the colour
        # probabilities reach them, and a pixel whose expected colour
        # is a subnormal product would count as non-black downstream
        # (reproject_np's filter_nocs). Flush as the JAX module does.
        prob = torch.softmax(logits * sm_hardness, dim=1)
        return torch.where(prob < torch.finfo(prob.dtype).tiny,
                           torch.zeros_like(prob), prob)

    def expected(logp):
        return (softmax_ftz(logp) * colors[:, None, None]).sum(
            1, keepdim=True)

    uvw_sm = torch.cat([expected(u), expected(v), expected(w)], dim=1)
    prob_mask = softmax_ftz(mask)
    mask_sm = (prob_mask * torch.arange(2, device=dev, dtype=dtype)
               [:, None, None]).sum(1, keepdim=True)
    hard_mask = torch.argmax(mask, dim=1, keepdim=True).to(dtype)
    return dict(out, u=u, v=v, w=w, uvw_sm=uvw_sm,
                uvw_sm_masked=uvw_sm * hard_mask, mask_sm=mask_sm)


FROZEN_PREFIXES = ("conv1", "bn1", "layer1_0", "layer1_1")
# resnet_css.py:156-158 freezes conv1, bn1 and layer1


def trainable_mask(model: CSSNet) -> dict[str, bool]:
    """Parameter name -> False for the frozen early layers."""
    return {name: name.split(".")[0] not in FROZEN_PREFIXES
            for name, _ in model.named_parameters()}


def init_params(model: CSSNet, generator: torch.Generator) -> CSSNet:
    """flax's initial weights, drawn from `generator`: conv kernels
    lecun_normal (normal with std 1/sqrt(fan_in) / 0.8796..., truncated at
    two of its deviations), biases 0, BatchNorm scale 1, bias 0, mean 0,
    var 1. The draws are not flax's: the same seed gives other numbers."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Conv):
                fan_in = mod.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.empty(mod.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                mod.weight.copy_(w)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, TorchBatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
    return model


def state_from_flax(variables: dict) -> dict:
    """The JAX package's CSS variables {'params', 'batch_stats'} (numpy
    leaves) -> a state dict for :class:`CSSNet`."""
    state: dict[str, torch.Tensor] = {}

    def walk(params, stats, prefix):
        for k, v in params.items():
            name = prefix + k
            if k == "BatchNorm_0":  # TorchBatchNorm's inner flax module
                bn = prefix[:-1]
                for key, tree in (("scale", v), ("bias", v),
                                  ("mean", stats[k]), ("var", stats[k])):
                    state[f"{bn}.{key}"] = _tensor(tree[key])
            elif "kernel" in v:
                state[name + ".weight"] = _tensor(
                    np.asarray(v["kernel"]).transpose(3, 2, 0, 1))
                if "bias" in v:
                    state[name + ".bias"] = _tensor(v["bias"])
            else:
                walk(v, stats.get(k, {}), name + ".")

    walk(variables["params"], variables["batch_stats"], "")
    return state


def _tensor(leaf) -> torch.Tensor:
    """A float32 tensor with its own copy of a (possibly read-only) numpy
    leaf."""
    return torch.from_numpy(np.array(leaf, np.float32, order="C"))


def state_to_flax(model: CSSNet) -> dict:
    """The reverse of :func:`state_from_flax`: {'params', 'batch_stats'}
    with numpy float32 leaves in the flax layout (OIHW kernels become
    HWIO)."""
    params: dict = {}
    stats: dict = {}

    def node(tree, path):
        for k in path:
            tree = tree.setdefault(k, {})
        return tree

    def arr(t):
        return t.detach().cpu().float().numpy().copy()

    for name, mod in model.named_modules():
        path = name.split(".") if name else []
        if isinstance(mod, TorchBatchNorm):
            node(params, path)["BatchNorm_0"] = {"scale": arr(mod.scale),
                                                 "bias": arr(mod.bias)}
            node(stats, path)["BatchNorm_0"] = {"mean": arr(mod.mean),
                                                "var": arr(mod.var)}
        elif isinstance(mod, Conv):
            leaf = node(params, path)
            leaf["kernel"] = np.ascontiguousarray(
                arr(mod.weight).transpose(2, 3, 1, 0))
            if mod.bias is not None:
                leaf["bias"] = arr(mod.bias)
    return {"params": params, "batch_stats": stats}


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
