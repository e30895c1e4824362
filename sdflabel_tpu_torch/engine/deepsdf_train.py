"""DeepSDF decoder training: the decoder and a latent code per scene,
optimized together.

Counterpart of sdflabel_tpu/engine/deepsdf_train.py, which reproduces the
external DeepSDF trainer for the sdflabel decoder (scale head included):

  * auto-decoder objective: a latent code per scene (a table) optimized
    jointly with the decoder weights;
  * clamped-L1 data term |clamp(pred, ±d) - clamp(gt, ±d)| summed over
    the step's B * S samples / (B * S);
  * code regularization lambda * min(1, (epoch + 1) / 100) * the mean over
    the step's scenes of ||z||;
  * codes initialised N(0, (CodeInitStdDev / sqrt(L))^2), projected onto
    the CodeBound ball after each step when one is set;
  * two Adam groups (decoder, codes) with a staircase decay on 1-based
    epochs, lr * factor^((epoch + 1) // interval); the decoder group alone
    clipped by its global norm (GradientNormClipping);
  * optional scale-head MSE against per-scene metric scales, NaN where
    none is known.

A step is :func:`draw` (half positive, half negative rows per scene, with
replacement, on the card from the ScenePack's tensors with a
torch.Generator) then :func:`step_on_samples`. The split lets a test feed
JAX's drawn rows to the port: jax.random and torch's generators never
draw the same rows or dropout masks. The decode is one (B*S, L+3) chain
of plain fp32 matmuls, as JAX computes it outside any kernel; TF32 stays
off for them (pipelines/train_deepsdf.py sets it). The optimizer is
written out with optax's arithmetic, as engine/refine.py::batch_step
writes it: torch.optim.Adam rounds its update another way.

:func:`shard_train_step` is JAX's data-parallel step over the scene axis
(deepsdf_train.py:264-280), whose draw is "bit-identical to the
single-device step": every rank draws the global rows and dropout masks
from the same generator and computes only its contiguous share of the
scenes; each loss term is divided by its global count; the decoder and
code-table gradients are summed over the data axis before the
decoder-only clip, and both Adam groups and the CodeBound projection then
run alike on every rank.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.parallel import mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class DeepSDFTrainConfig:
    """Training hyper-parameters (the external specs.json keys in parens)."""

    samples_per_scene: int = 16384    # SamplesPerScene
    scenes_per_batch: int = 64        # ScenesPerBatch
    clamp_dist: float = 0.1           # ClampingDistance
    code_reg: bool = True             # CodeRegularization
    code_reg_lambda: float = 1e-4     # CodeRegularizationLambda
    code_init_std: float = 1.0        # CodeInitStdDev (std = this/sqrt(L))
    code_bound: float | None = None   # CodeBound (max-norm projection)
    lr_decoder: float = 5e-4          # LearningRateSchedule[0].Initial
    lr_codes: float = 1e-3            # LearningRateSchedule[1].Initial
    lr_interval: int = 500            # [0].Interval (epochs)
    lr_factor: float = 0.5            # [0].Factor
    lr_interval_codes: int = 500      # [1].Interval (epochs)
    lr_factor_codes: float = 0.5      # [1].Factor
    scale_weight: float = 0.0         # ScaleSupervisionWeight
    grad_clip: float | None = None    # GradientNormClipping (decoder only)

    @classmethod
    def from_specs(cls, specs: dict) -> "DeepSDFTrainConfig":
        """Read the external trainer's specs.json keys (missing ->
        defaults)."""
        kw: dict[str, Any] = {}
        for key, field, cast in (
                ("SamplesPerScene", "samples_per_scene", int),
                ("ScenesPerBatch", "scenes_per_batch", int),
                ("ClampingDistance", "clamp_dist", float),
                ("CodeRegularization", "code_reg", bool),
                ("CodeRegularizationLambda", "code_reg_lambda", float),
                ("CodeInitStdDev", "code_init_std", float),
                ("ScaleSupervisionWeight", "scale_weight", float)):
            if key in specs:
                kw[field] = cast(specs[key])
        if specs.get("CodeBound") is not None:
            kw["code_bound"] = float(specs["CodeBound"])
        sched = specs.get("LearningRateSchedule")
        if sched:
            kw["lr_decoder"] = float(sched[0].get("Initial", cls.lr_decoder))
            kw["lr_interval"] = int(sched[0].get("Interval", cls.lr_interval))
            kw["lr_factor"] = float(sched[0].get("Factor", cls.lr_factor))
            if len(sched) > 1:
                kw["lr_codes"] = float(sched[1].get("Initial", cls.lr_codes))
                kw["lr_interval_codes"] = int(
                    sched[1].get("Interval", cls.lr_interval_codes))
                kw["lr_factor_codes"] = float(
                    sched[1].get("Factor", cls.lr_factor_codes))
        if specs.get("GradientNormClipping") is not None:
            kw["grad_clip"] = float(specs["GradientNormClipping"])
        return cls(**kw)


@dataclasses.dataclass
class AdamState:
    """One Adam group: the step count (a device int32 scalar) and the
    moments, trees shaped as the group's parameters."""

    count: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass
class DeepSDFTrainState:
    params: dict          # decoder tree (models/deepsdf.py layout)
    codes: torch.Tensor   # (num_scenes, L) latent table
    opt: dict             # {"dec": AdamState, "codes": AdamState}
    step: int             # global step count (drives the schedule)


class TrainTensors:
    """A ScenePack's arrays on the device: pos, neg (S, P, 4) float32,
    pos_count, neg_count (S,) int64, scales (S,) float32."""

    def __init__(self, pack, device):
        self.pos = torch.as_tensor(pack.pos, device=device)
        self.neg = torch.as_tensor(pack.neg, device=device)
        self.pos_count = torch.as_tensor(pack.pos_count, device=device).long()
        self.neg_count = torch.as_tensor(pack.neg_count, device=device).long()
        self.scales = torch.as_tensor(pack.scales, device=device)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """`tree`'s structure with the leaves of `leaves` (an iterator) in
    :func:`_leaves` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return next(leaves)


def _zeros_like(tree):
    return _rebuild(tree, iter([torch.zeros_like(x) for x in _leaves(tree)]))


def init_codes(num_scenes: int, latent_size: int, generator: torch.Generator,
               code_init_std: float = 1.0, device="cpu") -> torch.Tensor:
    """N(0, (std / sqrt(L))^2) initialization of the latent table."""
    z = torch.randn(num_scenes, latent_size, generator=generator)
    return (z * (code_init_std / np.sqrt(latent_size))).to(device)


def init_train_state(cfg: deepsdf.DeepSDFConfig, tcfg: DeepSDFTrainConfig,
                     num_scenes: int, generator: torch.Generator,
                     device="cpu") -> DeepSDFTrainState:
    params = deepsdf.init_params(cfg, generator, device=device)
    codes = init_codes(num_scenes, cfg.latent_size, generator,
                       tcfg.code_init_std, device)
    return DeepSDFTrainState(params, codes, init_opt(params, codes), 0)


def init_opt(params: dict, codes: torch.Tensor) -> dict:
    def adam(tree):
        count = torch.zeros((), dtype=torch.int32,
                            device=_leaves(tree)[0].device)
        return AdamState(count, _zeros_like(tree), _zeros_like(tree))

    return {"dec": adam(params), "codes": adam(codes)}


def learning_rates(tcfg: DeepSDFTrainConfig, step: int,
                   steps_per_epoch: int) -> tuple[float, float]:
    """(decoder lr, codes lr) of step `step` (the optimizer's count before
    it): initial * factor^(epoch_1based // interval), epoch_1based = step
    // steps_per_epoch + 1, in float32 as optax evaluates the schedule
    (the external trainer applies the decayed rate from the top of 1-based
    epoch `interval`)."""
    e1 = step // max(1, steps_per_epoch) + 1

    def lr(initial, interval, factor):
        return float(np.float32(initial) * np.power(
            np.float32(factor), np.float32(e1 // max(1, interval))))

    return (lr(tcfg.lr_decoder, tcfg.lr_interval, tcfg.lr_factor),
            lr(tcfg.lr_codes, tcfg.lr_interval_codes, tcfg.lr_factor_codes))


def clip_by_global_norm(grads: list[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    """optax.clip_by_global_norm: g unchanged while the global norm
    sqrt(sum of every leaf's sum of squares) is below max_norm, else
    g / norm * max_norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


def adam_update(state: AdamState, grads: list[torch.Tensor], lr: float
                ) -> tuple[list[torch.Tensor], AdamState]:
    """optax.adam(lr)'s update on a group's leaves (b1 0.9, b2 0.999, eps
    1e-8): the moments, the bias corrections in float32, then the scale by
    -lr."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    count = state.count + 1
    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()
    mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, _leaves(state.mu))]
    nu = [(1.0 - b2) * (g * g) + b2 * v
          for g, v in zip(grads, _leaves(state.nu))]
    updates = [(m / bc1) / (torch.sqrt(v / bc2) + eps) * -lr
               for m, v in zip(mu, nu)]
    return updates, AdamState(count, _rebuild(state.mu, iter(mu)),
                              _rebuild(state.nu, iter(nu)))


def draw(tensors: TrainTensors, scene_idx: torch.Tensor,
         samples_per_scene: int, generator: torch.Generator) -> torch.Tensor:
    """The step's rows: for each scene of `scene_idx` (B,), S // 2 rows of
    its positive set then S - S // 2 of its negative set, drawn uniformly
    with replacement from its true rows (the pack's padding repeats true
    rows, so drawing below the count is exact) -> (B, S, 4), on the pack's
    device, from `generator`."""
    half = samples_per_scene // 2

    def rows(pack_rows, counts, n_draw):
        cnt = counts[scene_idx]
        u = torch.rand(scene_idx.shape[0], n_draw, generator=generator,
                       device=pack_rows.device)
        idx = torch.minimum((u * cnt[:, None]).long(), cnt[:, None] - 1)
        flat = scene_idx[:, None] * pack_rows.shape[1] + idx
        return pack_rows.reshape(-1, 4)[flat]

    return torch.cat([rows(tensors.pos, tensors.pos_count, half),
                      rows(tensors.neg, tensors.neg_count,
                           samples_per_scene - half)], dim=1)


@dataclasses.dataclass(frozen=True)
class Shard:
    """A rank's share of a step: its scenes start at `lo` of a global
    batch of `scenes`, whose scale targets have `finite` finite ones (a
    0-dim tensor)."""

    lo: int
    scenes: int
    finite: torch.Tensor


def losses(cfg: deepsdf.DeepSDFConfig, tcfg: DeepSDFTrainConfig, params,
           codes, samples, scene_idx, scales, epoch: int,
           dropout_gen=None, shard: Shard | None = None) -> dict:
    """The step's loss terms on drawn `samples` (B, S, 4) of the scenes
    `scene_idx` (B,) (engine/deepsdf_train.py:218-251 of the JAX
    package): total, l1, reg, scale and the codes' mean norm. With a
    `shard` the rows are a rank's share, each term is divided by its
    global count, and the ranks' terms sum to the global ones."""
    b, s = samples.shape[:2]
    num = b * s
    lo, scenes = (0, b) if shard is None else (shard.lo, shard.scenes)
    d = tcfg.clamp_dist
    sdf_gt = samples[..., 3].clamp(-d, d)
    z = codes[scene_idx]
    inputs = torch.cat([z[:, None, :].expand(b, s, cfg.latent_size),
                        samples[..., :3]], -1).reshape(num, -1)
    rows = None if shard is None else (lo * s, scenes * s)
    pred = deepsdf.apply_sdf(cfg, params, inputs, dropout_gen,
                             rows).clamp(-d, d)
    l1 = (pred - sdf_gt.reshape(-1)).abs().sum() / (scenes * s)
    zero = torch.zeros((), device=samples.device)
    z_norm = torch.linalg.norm(z, dim=-1).mean() * (b / scenes)
    reg = zero
    if tcfg.code_reg:
        warm = min(1.0, float(np.float32(epoch + 1) / np.float32(100.0)))
        reg = tcfg.code_reg_lambda * warm * z_norm
    lsc = zero
    if tcfg.scale_weight > 0.0:
        tgt = scales[scene_idx]
        ok = torch.isfinite(tgt)
        # double-where: a NaN target reaches neither the residual nor the
        # backward of the outer where
        tgt_safe = torch.where(ok, tgt, zero)
        pred_sc = deepsdf.apply_scale(cfg, params, z)[:, 0]
        se = torch.where(ok, (pred_sc - tgt_safe) ** 2, zero)
        finite = ok.sum() if shard is None else shard.finite
        lsc = tcfg.scale_weight * se.sum() / finite.clamp(min=1)
    total = l1 + reg + lsc
    return {"loss": total, "loss_l1": l1, "loss_reg": reg,
            "loss_scale": lsc, "code_norm": z_norm}


def step_on_samples(cfg: deepsdf.DeepSDFConfig, tcfg: DeepSDFTrainConfig,
                    steps_per_epoch: int, state: DeepSDFTrainState,
                    samples: torch.Tensor, scene_idx: torch.Tensor,
                    scales: torch.Tensor, dropout_gen=None,
                    shard: Shard | None = None, group=None
                    ) -> tuple[DeepSDFTrainState, dict]:
    """One optimizer step on drawn rows: the losses, their gradients to
    the decoder and the codes, the clipped decoder group and both Adam
    groups, then the CodeBound projection. Returns the new state and the
    metrics (device scalars, not read back). With a `shard` and its data
    axis `group` the rows are a rank's share: the gradients and metrics
    are summed over the group before the update."""
    leaves = [x.detach().requires_grad_(True)
              for x in _leaves(state.params)]
    params = _rebuild(state.params, iter(leaves))
    codes = state.codes.detach().requires_grad_(True)
    epoch = state.step // max(1, steps_per_epoch)
    metrics = losses(cfg, tcfg, params, codes, samples, scene_idx, scales,
                     epoch, dropout_gen, shard)
    # the scale head takes no gradient without its loss: zeros, as in JAX
    grads = torch.autograd.grad(metrics["loss"], leaves + [codes],
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves + [codes], grads)]
    metrics = {k: v.detach().clone() for k, v in metrics.items()}
    if group is not None:
        mesh_mod.all_reduce_(grads + list(metrics.values()), group)
    *g_dec, g_codes = grads
    if tcfg.grad_clip is not None:
        g_dec = clip_by_global_norm(g_dec, tcfg.grad_clip)
    lr_dec, lr_codes = learning_rates(tcfg, state.step, steps_per_epoch)
    u_dec, opt_dec = adam_update(state.opt["dec"], g_dec, lr_dec)
    (u_codes,), opt_codes = adam_update(state.opt["codes"], [g_codes],
                                        lr_codes)
    new_params = _rebuild(state.params, iter(
        [p.detach() + u for p, u in zip(leaves, u_dec)]))
    new_codes = codes.detach() + u_codes
    if tcfg.code_bound is not None:
        norms = torch.linalg.norm(new_codes, dim=-1, keepdim=True)
        new_codes = new_codes * torch.clamp(
            tcfg.code_bound / norms.clamp(min=1e-12), max=1.0)
    return (DeepSDFTrainState(new_params, new_codes,
                              {"dec": opt_dec, "codes": opt_codes},
                              state.step + 1), metrics)


def train_step(cfg: deepsdf.DeepSDFConfig, tcfg: DeepSDFTrainConfig,
               steps_per_epoch: int, state: DeepSDFTrainState,
               tensors: TrainTensors, scene_idx: torch.Tensor,
               generator: torch.Generator, mesh=None
               ) -> tuple[DeepSDFTrainState, dict]:
    """:func:`draw` then :func:`step_on_samples`, the dropout masks drawn
    from the same generator after the rows (when the config has
    dropout). With a `mesh` (:func:`shard_train_step`) this rank steps on
    its share of `scene_idx`, the global batch."""
    samples = draw(tensors, scene_idx, tcfg.samples_per_scene, generator)
    use_dropout = bool(cfg.dropout) or cfg.latent_dropout
    gen = generator if use_dropout else None
    if mesh is None:
        return step_on_samples(cfg, tcfg, steps_per_epoch, state, samples,
                               scene_idx, tensors.scales, gen)
    cut = mesh_mod.data_slice(scene_idx.shape[0], mesh)
    shard = Shard(cut.start, scene_idx.shape[0],
                  torch.isfinite(tensors.scales[scene_idx]).sum())
    return step_on_samples(cfg, tcfg, steps_per_epoch, state, samples[cut],
                           scene_idx[cut], tensors.scales, gen, shard,
                           mesh.data_group)


def shard_train_step(step, mesh):
    """Data-parallel `step` (:func:`train_step`) over the scene axis of
    `mesh` (deepsdf_train.py:264-280): every rank passes the same global
    `scene_idx` and generator and holds the same state after the step."""
    return functools.partial(step, mesh=mesh)


def _adam_node(tree):
    """The first node of a JAX optimizer state that holds Adam's count and
    moments (optax's ScaleByAdamState), depth first."""
    if hasattr(tree, "mu") and hasattr(tree, "nu") and hasattr(tree,
                                                                "count"):
        return tree
    children = (tree.values() if isinstance(tree, dict) else
                tree if isinstance(tree, tuple) else ())
    for child in children:
        found = _adam_node(child)
        if found is not None:
            return found
    return None


def train_state_from_jax(jstate, device="cpu") -> DeepSDFTrainState:
    """JAX's DeepSDFTrainState with numpy leaves (params, codes, the
    multi-transform Adam state of its two groups, step) -> the port's. In
    each group's Adam state the moments are (decoder tree, codes) with the
    other group's slot masked; the group's own slot is taken."""
    inner = jstate.opt_state.inner_states

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def tree(x):
        if isinstance(x, dict):
            return {k: tree(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [tree(v) for v in x]
        return t(x)

    def group(name, slot):
        adam = _adam_node(inner[name])
        return AdamState(
            torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32,
                         device=device),
            tree(adam.mu[slot]), tree(adam.nu[slot]))

    return DeepSDFTrainState(tree(jstate.params), t(jstate.codes),
                             {"dec": group("dec", 0),
                              "codes": group("codes", 1)},
                             int(np.asarray(jstate.step)))


def state_tree(state: DeepSDFTrainState) -> dict:
    """The state as a tree of tensors and numbers (for utils/checkpoint)."""
    return {"params": state.params, "codes": state.codes, "step": state.step,
            "opt": {k: {"count": a.count, "mu": a.mu, "nu": a.nu}
                    for k, a in state.opt.items()}}


def state_from_tree(tree: dict) -> DeepSDFTrainState:
    return DeepSDFTrainState(
        tree["params"], tree["codes"],
        {k: AdamState(a["count"], a["mu"], a["nu"])
         for k, a in tree["opt"].items()}, int(tree["step"]))


def epoch_steps(num_scenes: int, scenes_per_batch: int) -> tuple[int, int]:
    """(scenes a step, steps an epoch): the batch is cut to the scene
    count, and an epoch takes the whole batches only."""
    bsz = min(scenes_per_batch, num_scenes)
    return bsz, max(1, num_scenes // bsz)
