"""DeepSDF latent decoder (+ scale head) in PyTorch.

Counterpart of sdflabel_tpu/models/deepsdf.py. Parameters are a plain
dictionary with the JAX package's layout (``lin{l}`` -> ``{'w': (in, out),
'b'}`` or, under weight-norm, ``{'v', 'g', 'b'}``; ``ln{l}`` LayerNorm;
``scale_net`` list), so that trees carry across unchanged and the
selection kernel's packing (ops/mlp_cuda.py) reads the same names.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any

import numpy as np
import torch

from sdflabel_tpu_torch.ops import dropout_cuda


@dataclasses.dataclass(frozen=True)
class DeepSDFConfig:
    latent_size: int
    dims: tuple[int, ...]
    dropout: tuple[int, ...] = ()
    dropout_prob: float = 0.0
    norm_layers: tuple[int, ...] = ()
    latent_in: tuple[int, ...] = ()
    weight_norm: bool = False
    xyz_in_all: bool = False
    use_tanh: bool = False
    latent_dropout: bool = False

    @property
    def layer_dims(self) -> tuple[int, ...]:
        return (self.latent_size + 3, *self.dims, 1)

    @property
    def num_layers(self) -> int:
        return len(self.layer_dims)

    def layer_io(self, l: int) -> tuple[int, int]:
        """(in_dim, out_dim) of linear layer l (deep_sdf_decoder_scale.py
        :42-54: the concat bookkeeping lives in the previous out_dim)."""
        dims = self.layer_dims
        in_dim = dims[l]
        if l + 1 in self.latent_in:
            out_dim = dims[l + 1] - dims[0]
        else:
            out_dim = dims[l + 1]
            if self.xyz_in_all and l != self.num_layers - 2:
                out_dim -= 3
        return in_dim, out_dim

    @classmethod
    def from_specs(cls, specs: dict) -> "DeepSDFConfig":
        """Build from a DeepSDF specs.json dict (workspace.py:167-175)."""
        ns = dict(specs["NetworkSpecs"])
        return cls(
            latent_size=specs["CodeLength"],
            dims=tuple(ns.get("dims", ())),
            dropout=tuple(ns.get("dropout") or ()),
            dropout_prob=ns.get("dropout_prob", 0.0),
            norm_layers=tuple(ns.get("norm_layers") or ()),
            latent_in=tuple(ns.get("latent_in") or ()),
            weight_norm=bool(ns.get("weight_norm", False)),
            xyz_in_all=bool(ns.get("xyz_in_all", False)),
            use_tanh=bool(ns.get("use_tanh", False)),
            latent_dropout=bool(ns.get("latent_dropout", False)),
        )


def init_params(cfg: DeepSDFConfig, generator: torch.Generator,
                device="cpu", dtype=torch.float32) -> dict:
    """Seeded init with torch nn.Linear's default U(-1/sqrt(in), 1/sqrt(in))
    bounds; under weight-norm g starts at the column norms of v."""
    def dense(in_dim, out_dim):
        bound = 1.0 / math.sqrt(in_dim)
        w = (torch.rand(in_dim, out_dim, generator=generator) * 2 - 1) * bound
        b = (torch.rand(out_dim, generator=generator) * 2 - 1) * bound
        return w.to(device, dtype), b.to(device, dtype)

    params: dict[str, Any] = {}
    for l in range(cfg.num_layers - 1):
        in_dim, out_dim = cfg.layer_io(l)
        w, b = dense(in_dim, out_dim)
        if cfg.weight_norm and l in cfg.norm_layers:
            params[f"lin{l}"] = {"v": w, "g": torch.linalg.norm(w, dim=0),
                                 "b": b}
        else:
            params[f"lin{l}"] = {"w": w, "b": b}
            if (not cfg.weight_norm) and l in cfg.norm_layers:
                params[f"ln{l}"] = {
                    "scale": torch.ones(out_dim, device=device, dtype=dtype),
                    "bias": torch.zeros(out_dim, device=device, dtype=dtype),
                }
    params["scale_net"] = []
    for di, do in ((cfg.latent_size, 3), (3, 3), (3, 1)):
        w, b = dense(di, do)
        params["scale_net"].append({"w": w, "b": b})
    return params


def _weight(p: dict) -> torch.Tensor:
    if "v" in p:  # weight-norm: w = v * g / ||v|| per output column
        v = p["v"]
        return v * (p["g"] / torch.linalg.norm(v, dim=0))[None, :]
    return p["w"]


def _linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ _weight(p) + p["b"]


def _layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]


def _dropout(x: torch.Tensor, keep_p: float, generator: torch.Generator,
             rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability keep_p (a draw
    from `generator`, on x's device) and scaled by 1 / keep_p. With
    `rows` (lo, n), x is rows lo.. of an (n, ...) batch: the mask is drawn
    for the whole batch and x takes its rows of it."""
    return dropout_cuda.dropout(x, keep_p, generator, rows)


def apply_sdf(cfg: DeepSDFConfig, params: dict, inputs: torch.Tensor,
              dropout_gen: torch.Generator | None = None,
              dropout_rows: tuple[int, int] | None = None) -> torch.Tensor:
    """SDF MLP on (..., N, latent+3) inputs -> (..., N) sdf
    (deep_sdf_decoder_scale.py:78-107). `dropout_gen` None is eval mode
    (dropout off, as every refine runs it); a generator on the inputs'
    device turns on train-mode dropout at ``cfg.dropout`` layers with
    ``cfg.dropout_prob`` (and the latent dropout of :85-89 when
    ``cfg.latent_dropout``), drawn from it. JAX draws its masks with
    jax.random: the two never draw the same masks. `dropout_rows` (lo, n)
    marks (N, latent+3) inputs as rows lo.. of an n-row batch whose masks
    are drawn whole (a data-parallel rank's share). A dropout layer without
    LayerNorm on fp32 inputs runs its bias, ReLU and dropout through
    ops/dropout_cuda.py (on the card one kernel each way; the same masks
    and values as the chain below); every other layer, and every layer in
    eval mode, runs the chain."""
    x = inputs
    if (dropout_gen is not None and cfg.latent_dropout
            and inputs.shape[-1] > 3):
        x = torch.cat([_dropout(inputs[..., :-3], 0.8, dropout_gen,
                                dropout_rows), inputs[..., -3:]], dim=-1)
    last = cfg.num_layers - 2
    for l in range(cfg.num_layers - 1):
        if l in cfg.latent_in:
            x = torch.cat([x, inputs], dim=-1)
        elif l != 0 and cfg.xyz_in_all:
            x = torch.cat([x, inputs[..., -3:]], dim=-1)
        layer_norm = (not cfg.weight_norm) and l in cfg.norm_layers
        if (dropout_gen is not None and l < last and l in cfg.dropout
                and not layer_norm and x.dtype == torch.float32):
            p = params[f"lin{l}"]
            x = dropout_cuda.bias_relu_dropout(
                x @ _weight(p), p["b"], 1.0 - cfg.dropout_prob, dropout_gen,
                dropout_rows)
            continue
        x = _linear(params[f"lin{l}"], x)
        if l == last and cfg.use_tanh:
            x = torch.tanh(x)
        if l < last:
            if layer_norm:
                x = _layer_norm(params[f"ln{l}"], x)
            x = torch.relu(x)
            if dropout_gen is not None and l in cfg.dropout:
                x = _dropout(x, 1.0 - cfg.dropout_prob, dropout_gen,
                             dropout_rows)
    return torch.tanh(x)[..., 0]


def apply_scale(cfg: DeepSDFConfig, params: dict,
                latent: torch.Tensor) -> torch.Tensor:
    """Scale head on one latent (L,) -> (1,), or on (B, L) -> (B, 1)."""
    x = latent
    for i, p in enumerate(params["scale_net"]):
        x = x @ p["w"] + p["b"]
        if i < 2:
            x = torch.relu(x)
    return x


def sdf_fn(cfg: DeepSDFConfig, params: dict):
    """decoder_fn(latent, points) -> (N,) for ops.grid. (B, L) latents, one
    per crop, decode (N, 3) points shared by every crop or their own
    (B, N, 3) -> (B, N); the products stay plain matmuls, as JAX computes
    them outside any kernel."""

    def fn(latent, points):
        batch = torch.broadcast_shapes(latent.shape[:-1], points.shape[:-2])
        lat = latent[..., None, :].expand(*batch, points.shape[-2],
                                          latent.shape[-1])
        pts = points.expand(*batch, *points.shape[-2:])
        return apply_sdf(cfg, params, torch.cat([lat, pts], dim=-1))

    return fn


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    return _map_tree(lambda t: t.to(dtype), params)


def fold_weight_norm(params: dict) -> dict:
    """Replace every {'v','g','b'} linear by {'w': v * g/||v||, 'b'}, in the
    parameters' own dtype (the exact tensor _linear computes per call)."""

    def fold(p):
        if isinstance(p, dict) and "v" in p:
            v = p["v"]
            return {"w": v * (p["g"] / torch.linalg.norm(v, dim=0))[None, :],
                    "b": p["b"]}
        return p

    return {k: ([fold(p) for p in v] if isinstance(v, list) else fold(v))
            for k, v in params.items()}


def select_sdf_fn(cfg: DeepSDFConfig, params: dict,
                  dtype: torch.dtype = torch.bfloat16):
    """Low-precision decoder for the band selection only
    ([optimization] select_bf16): weight-norm folded in fp32, every
    parameter then cast to `dtype`, latent and points cast to it, so that
    the whole MLP runs in `dtype`; the sdf comes back as fp32. Selection
    needs only the ranking of |sdf|, and stage 2 decodes every selected
    point again with the exact decoder."""
    base = sdf_fn(cfg, cast_params(fold_weight_norm(
        _map_tree(lambda t: t.float(), params)), dtype))

    def fn(latent, points):
        return base(latent.to(dtype), points.to(dtype)).float()

    return fn


def params_from_jax(tree: dict, device="cpu") -> dict:
    """The JAX package's DeepSDF pytree (leaves as numpy arrays) -> the
    port's parameters. The layouts are the same; only the leaves change."""
    return _map_tree(
        lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device),
        tree)


def params_from_torch_state(cfg: DeepSDFConfig, state: dict,
                            device="cpu") -> dict:
    """Reference decoder state_dict (maybe 'module.'-prefixed) -> params.
    torch Linear keeps weight as (out, in); the port keeps (in, out)."""

    def get(name):
        for k in (name, "module." + name):
            if k in state:
                return torch.as_tensor(state[k]).detach().to(
                    device, torch.float32)
        raise KeyError(name)

    params: dict[str, Any] = {}
    for l in range(cfg.num_layers - 1):
        if cfg.weight_norm and l in cfg.norm_layers:
            params[f"lin{l}"] = {"v": get(f"lin{l}.weight_v").T.contiguous(),
                                 "g": get(f"lin{l}.weight_g").reshape(-1),
                                 "b": get(f"lin{l}.bias")}
        else:
            params[f"lin{l}"] = {"w": get(f"lin{l}.weight").T.contiguous(),
                                 "b": get(f"lin{l}.bias")}
            if (not cfg.weight_norm) and l in cfg.norm_layers:
                params[f"ln{l}"] = {"scale": get(f"bn{l}.weight"),
                                    "bias": get(f"bn{l}.bias")}
    params["scale_net"] = [
        {"w": get(f"scale_net.{i}.weight").T.contiguous(),
         "b": get(f"scale_net.{i}.bias")}
        for i in (0, 2, 4)
    ]
    return params


def torch_state_from_params(cfg: DeepSDFConfig, params: dict) -> dict:
    """Inverse of params_from_torch_state: params -> a reference-layout
    state dict of CPU float32 tensors (torch Linear's (out, in)), so that
    a decoder trained by the port (engine/deepsdf_train.py) saves as a
    ``deepsdf.pt`` that the reference loader, JAX's and the port's read."""

    def t(x):
        return x.detach().to("cpu", torch.float32).contiguous()

    state: dict[str, torch.Tensor] = {}
    for l in range(cfg.num_layers - 1):
        p = params[f"lin{l}"]
        if cfg.weight_norm and l in cfg.norm_layers:
            state[f"lin{l}.weight_v"] = t(p["v"].T)
            state[f"lin{l}.weight_g"] = t(p["g"].reshape(-1, 1))
            state[f"lin{l}.bias"] = t(p["b"])
        else:
            state[f"lin{l}.weight"] = t(p["w"].T)
            state[f"lin{l}.bias"] = t(p["b"])
            if (not cfg.weight_norm) and l in cfg.norm_layers:
                state[f"bn{l}.weight"] = t(params[f"ln{l}"]["scale"])
                state[f"bn{l}.bias"] = t(params[f"ln{l}"]["bias"])
    for i, idx in enumerate((0, 2, 4)):
        p = params["scale_net"][i]
        state[f"scale_net.{idx}.weight"] = t(p["w"].T)
        state[f"scale_net.{idx}.bias"] = t(p["b"])
    return state


def specs_from_config(cfg: DeepSDFConfig) -> dict:
    """The specs.json dict of a config (CodeLength, NetworkArch,
    NetworkSpecs), so that an exported checkpoint round-trips through
    DeepSDFConfig.from_specs; NetworkArch names the reference decoder
    class that the reference's setup_dsdf imports (workspace.py:171-174)."""
    return {
        "CodeLength": cfg.latent_size,
        "NetworkArch": "deep_sdf_decoder_scale",
        "NetworkSpecs": {
            "dims": list(cfg.dims),
            "dropout": list(cfg.dropout),
            "dropout_prob": cfg.dropout_prob,
            "norm_layers": list(cfg.norm_layers),
            "latent_in": list(cfg.latent_in),
            "weight_norm": cfg.weight_norm,
            "xyz_in_all": cfg.xyz_in_all,
            "use_tanh": cfg.use_tanh,
            "latent_dropout": cfg.latent_dropout,
        },
    }


def save_torch_checkpoint(path: str, cfg: DeepSDFConfig, params: dict,
                          epoch: int = 0) -> None:
    """Write the single-file pair <name>.pt + <name>.json in the reference
    format (workspace.py:167-188). The keys carry the 'module.' prefix: the
    reference's setup_dsdf loads through nn.DataParallel before unwrapping
    (workspace.py:175-180), as its released checkpoints are saved; the
    port's and JAX's loaders accept both spellings."""
    state = {"module." + k: v
             for k, v in torch_state_from_params(cfg, params).items()}
    torch.save({"epoch": epoch, "model_state_dict": state}, path)
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(specs_from_config(cfg), f, indent=2)


def load_torch_checkpoint(path: str, device="cuda"):
    """Reference-format pair <name>.pt + <name>.json (workspace.py:167-188)
    -> (DeepSDFConfig, params on `device`)."""
    with open(os.path.splitext(path)[0] + ".json") as f:
        cfg = DeepSDFConfig.from_specs(json.load(f))
    saved = torch.load(path, map_location="cpu", weights_only=False)
    state = saved["model_state_dict"] if "model_state_dict" in saved else saved
    return cfg, params_from_torch_state(cfg, state, device=device)
