"""Seeded weights of the DeepSDF decoder, made on the card in a few large
calls, in the parameter tree both the program and the reference read
({lin<l>: {v, g, b}} under weight norm, {w, b} otherwise, (in, out)
matrices; a three-layer scale head).

No trained decoder at the published widths is in the repository, and a
decoder with torch's default init decodes a nearly constant field (|sdf|
about 0.02 everywhere in [-1, 1]^3): no surface, so every grid point is
"on" it. ``geometric`` is the geometric initialisation of SAL (Atzmon and
Lipman, CVPR 2020): ReLU layers N(0, 2 / out) with zero biases and a last
layer of mean sqrt(pi / in), which makes the decoder a smooth distance
field; here the xyz inputs are stretched per axis so that its zero set is
a closed, car-proportioned blob, the latent's inputs are damped so that
each latent deforms it rather than replacing it, and the last bias puts
the zero set on the shell of stretched radius ``shell_radius``.
"""

from __future__ import annotations

import math

import torch

from portbench import counts


def layer_io(cfg: dict) -> list[tuple[int, int]]:
    """(in, out) of each linear layer of the decoder config."""
    spec = cfg["NetworkSpecs"]
    return counts.decoder_layer_io(cfg["CodeLength"], spec["dims"],
                                   spec["latent_in"])


def _tree(cfg: dict, ws: list, bs: list) -> dict:
    spec = cfg["NetworkSpecs"]
    params = {}
    for l, (w, b) in enumerate(zip(ws, bs)):
        if spec["weight_norm"] and l in spec["norm_layers"]:
            params[f"lin{l}"] = {"v": w, "g": torch.linalg.norm(w, dim=0),
                                 "b": b}
        else:
            params[f"lin{l}"] = {"w": w, "b": b}
    return params


def scale_head(lat: int, gen: torch.Generator, device) -> list:
    """The decoder's scale head (L -> 3 -> 3 -> 1), torch Linear's
    default bounds; no cell reads it."""
    out = []
    for di, do in ((lat, 3), (3, 3), (3, 1)):
        bound = 1.0 / math.sqrt(di)
        u = torch.rand(di * do + do, generator=gen, device=device)
        u = (u * 2 - 1) * bound
        out.append({"w": u[:di * do].reshape(di, do), "b": u[di * do:]})
    return out


def geometric(cfg: dict, seed: int, device, stretch=(1.62, 1.82, 0.65),
              latent_gain: float = 0.6, shell_radius: float = 0.6) -> dict:
    """The decoder of a closed car-like surface (see the module note)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lat = cfg["CodeLength"]
    io = layer_io(cfg)
    last = len(io) - 1
    latent_in = cfg["NetworkSpecs"]["latent_in"]
    total = sum(i * o for i, o in io)
    z = torch.randn(total, generator=gen, device=device)
    ws, bs, at = [], [], 0
    xyz_gain = torch.tensor(stretch, device=device)
    for l, (i, o) in enumerate(io):
        w = z[at:at + i * o].reshape(i, o)
        at += i * o
        if l == last:
            w = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * w
        else:
            w = w * (math.sqrt(2.0) / math.sqrt(o))
        if l == 0 or l in latent_in:
            off = 0 if l == 0 else i - (lat + 3)
            w[off:off + lat] *= latent_gain
            w[off + lat:off + lat + 3] *= xyz_gain[:, None]
        ws.append(w)
        bs.append(torch.zeros(o, device=device))
    params = _tree(cfg, ws, bs)
    params["scale_net"] = scale_head(lat, gen, device)
    # the last bias: the mean pre-activation on the stretched shell, over
    # eight seeded latents, moved to 0
    shell = torch.randn(4096, 3, generator=gen, device=device)
    shell = shell / torch.linalg.norm(shell, dim=1, keepdim=True)
    shell = shell * shell_radius / xyz_gain
    lats = torch.randn(8, lat, generator=gen, device=device)
    lats = lats / torch.linalg.norm(lats, dim=1, keepdim=True)
    sdf = _decode_fp32(params, latent_in, lats, shell)
    params[f"lin{last}"]["b"] = -torch.atanh(
        sdf.clamp(-0.999, 0.999)).mean().reshape(1)
    return params


def _decode_fp32(params, latent_in, lats, pts):
    n = sum(1 for k in params if k.startswith("lin"))
    b = lats.shape[0]
    inputs = torch.cat([lats[:, None].expand(b, pts.shape[0], lats.shape[1]),
                        pts.expand(b, *pts.shape)], -1)
    x = inputs
    for l in range(n):
        p = params[f"lin{l}"]
        w = p["v"] * (p["g"] / torch.linalg.norm(p["v"], dim=0))[None] \
            if "v" in p else p["w"]
        if l in latent_in:
            x = torch.cat([x, inputs], -1)
        x = x @ w + p["b"]
        if l < n - 1:
            x = torch.relu(x)
    return torch.tanh(x)[..., 0]


def torch_default(cfg: dict, seed: int, device) -> dict:
    """torch Linear's default U(-1/sqrt(in), 1/sqrt(in)) init, weight norm's
    g at the column norms of v (the DeepSDF trainer's start), from one
    draw on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    io = layer_io(cfg)
    u = torch.rand(sum(i * o + o for i, o in io), generator=gen,
                   device=device)
    ws, bs, at = [], [], 0
    for i, o in io:
        bound = 1.0 / math.sqrt(i)
        ws.append((u[at:at + i * o].reshape(i, o) * 2 - 1) * bound)
        at += i * o
        bs.append((u[at:at + o] * 2 - 1) * bound)
        at += o
    params = _tree(cfg, ws, bs)
    params["scale_net"] = scale_head(cfg["CodeLength"], gen, device)
    return params
