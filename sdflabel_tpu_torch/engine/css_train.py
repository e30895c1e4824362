"""CSS network training: losses, Adam with frozen layers, the train step.

Counterpart of sdflabel_tpu/engine/css_train.py (reference
pipelines/train_css.py:29-91):

- losses (train_css.py:70-80): loss_u/v/w = CE(logits * mask, target *
  mask), loss_mask = 2 CE(mask logits, mask), loss_latent = MSE. CE is
  torch's mean cross-entropy with its internal log-softmax, which the
  reference applies to log-softmax outputs once more (QUIRKS #11);
  ``direct_ce`` feeds the raw head logits instead, the same objective
  since log-softmax is idempotent. ``fused_ce`` routes the four CE towers
  through kernel 5 (ops/ce_cuda.py) on CUDA tensors.
- Adam (optax.adam's arithmetic, in its order) over every parameter but
  the frozen conv1 / bn1 / layer1 (resnet_css.py:156-158), which get no
  update; their BatchNorm statistics still move, as flax marks every
  batch_stats mutable.

The step runs eagerly and updates the model and the optimizer in place
(the JAX step returns new arrays). A uint8 RGB batch is normalized on the
device, as the JAX step does. The model is whichever CSS network the
state holds: models/css.py::CSSNet at its compute dtype, or
models/css_fused.py::CSSNetFused.

:func:`shard_train_step` is JAX's data-parallel pjit step
(css_train.py:221-243) over a parallel/mesh.py layout: each rank takes
its contiguous share of the global batch, the BatchNorm statistics are the
global batch's, each loss term is its share of the global mean, and the
gradients are summed over the data axis before the identical Adam step on
every rank. It equals the single-device step on the global batch, as
JAX's one logical program does.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from sdflabel_tpu_torch.data.crops import normalize_rgb
from sdflabel_tpu_torch.models import css as css_mod
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.ops.ce_cuda import (  # noqa: F401 (re-exported)
    cross_entropy_with_internal_softmax, fused_cross_entropy)


def css_losses(pred: dict, batch: dict, fused_ce: bool = False,
               direct_ce: bool = False, share: float = 1.0) -> dict:
    """All training loss terms (train_css.py:70-80). `pred` holds the
    model's outputs; `batch` uint8 or integer 'mask' (B, H, W) and 'uvw'
    (B, 3, H, W) and float 'latent' (B, L). Each term is a mean over the
    batch times `share`, this batch's part of a global batch (1: the batch
    is the whole), so that the ranks' terms sum to the global means."""
    mask_gt = batch["mask"].long()
    uvw_gt = batch["uvw"].long()
    uk, vk, wk = (("u_raw", "v_raw", "w_raw") if direct_ce
                  else ("u", "v", "w"))
    mask_ext = mask_gt[:, None].to(pred[uk].dtype)
    ce = fused_cross_entropy if fused_ce else \
        cross_entropy_with_internal_softmax
    loss_u = ce(pred[uk] * mask_ext, uvw_gt[:, 0] * mask_gt) * share
    loss_v = ce(pred[vk] * mask_ext, uvw_gt[:, 1] * mask_gt) * share
    loss_w = ce(pred[wk] * mask_ext, uvw_gt[:, 2] * mask_gt) * share
    loss_uvw = loss_u + loss_v + loss_w
    loss_mask = ce(pred["mask"], mask_gt) * share * 2.0
    latent = pred["latent"]
    loss_latent = torch.mean(torch.square(
        latent - batch["latent"].to(latent.dtype))) * share
    return {"loss": loss_uvw + loss_latent + loss_mask, "loss_uvw": loss_uvw,
            "loss_mask": loss_mask, "loss_latent": loss_latent}


class Adam:
    """optax.adam(lr) with b1 0.9, b2 0.999, eps 1e-8 over the named
    parameters that require a gradient:

        mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,
        p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

    each product rounded apart, as optax computes it; the bias corrections
    in float32. Multi-tensor (``torch._foreach_*``) updates."""

    def __init__(self, named_params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.names, self.params = [], []
        for name, p in named_params:
            if p.requires_grad:
                self.names.append(name)
                self.params.append(p)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        self.count += 1
        one = np.float32(1)
        bc1 = float(one - np.float32(b1) ** np.int32(self.count))
        bc2 = float(one - np.float32(b2) ** np.int32(self.count))
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), denom)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        with torch.no_grad():
            for i, name in enumerate(self.names):
                self.mu[i].copy_(state["mu"][name])
                self.nu[i].copy_(state["nu"][name])


@dataclasses.dataclass
class TrainState:
    """The model (in train mode), its optimizer and the steps taken."""

    model: css_mod.CSSNet
    opt: Adam
    step: int = 0


def init_train_state(model: css_mod.CSSNet, lr: float) -> TrainState:
    """Freeze the early layers, switch to train mode, and set up Adam over
    the rest."""
    trainable = css_mod.trainable_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(trainable[name])
    model.train()
    return TrainState(model=model, opt=Adam(model.named_parameters(), lr))


@contextlib.contextmanager
def _synced_batch_norm(model, group, share: float):
    """The model's BatchNorms on the global batch's statistics while in
    the block (models/css.py::TorchBatchNorm.sync)."""
    bns = [m for m in model.modules() if isinstance(m, css_mod.TorchBatchNorm)]
    for m in bns:
        m.sync = (group, share)
    try:
        yield
    finally:
        for m in bns:
            m.sync = None


def make_train_step(fused_ce: bool = False, direct_ce: bool = False):
    """train_step(state, batch) -> metrics: one Adam step on a device
    batch (data/crops.py::Crops.to_device), in place. The metrics are
    0-dim tensors, so reading them is the caller's choice of sync.
    ``train_step.dp(state, batch, group, share)`` is the same step on one
    rank's share of a global batch (:func:`shard_train_step`)."""

    def dp(state: TrainState, batch: dict, group, share: float) -> dict:
        rgb = batch["rgb"]
        if rgb.dtype == torch.uint8:
            rgb = normalize_rgb(rgb)
        sync = (_synced_batch_norm(state.model, group, share)
                if group is not None else contextlib.nullcontext())
        with sync:
            # with raw-logit CE nothing needs the model's colour decode
            pred = state.model(rgb, decode=not direct_ce)
            losses = css_losses(pred, batch, fused_ce=fused_ce,
                                direct_ce=direct_ce, share=share)
            state.opt.zero_grad()
            losses["loss"].backward()
        metrics = [v.detach() for v in losses.values()]
        if group is not None:
            grads = [p.grad for p in state.opt.params if p.grad is not None]
            mesh_mod.all_reduce_(grads + metrics, group)
        state.opt.step()
        state.step += 1
        return dict(zip(losses, metrics))

    def train_step(state: TrainState, batch: dict) -> dict:
        return dp(state, batch, None, 1.0)

    train_step.dp = dp
    # inspected by shard_train_step: JAX keeps the fused CE off a mesh
    train_step.uses_fused_ce = fused_ce
    return train_step


def shard_train_step(train_step, mesh: mesh_mod.Mesh):
    """JAX's data-parallel step over `mesh`: sharded(state, batch) takes
    the global batch (every rank passes the same), steps on this rank's
    contiguous share of it, and returns the global batch's metrics.
    ``sharded.local(state, local_batch)`` takes the share already cut
    (train_css cuts the host batch before the device work).
    Refused as in JAX: the fused CE on more than one device, and a batch
    that does not divide over the data axis."""
    if getattr(train_step, "uses_fused_ce", False) and mesh.size > 1:
        raise ValueError(
            "fused_ce is not partitionable over a >1-device mesh -- build "
            "the step with make_train_step(fused_ce=False) for sharded "
            "training (the plain CE is value-identical)")

    def local(state: TrainState, batch: dict) -> dict:
        return train_step.dp(state, batch, mesh.data_group,
                             1.0 / mesh.shape["data"])

    def sharded(state: TrainState, batch: dict) -> dict:
        cut = mesh_mod.data_slice(batch["rgb"].shape[0], mesh)
        return local(state, {k: v[cut] for k, v in batch.items()})

    sharded.local = local
    return sharded
