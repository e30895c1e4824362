"""Plain PyTorch reference of DeepSDF decoder training (the auto-decoder
step of DeepSDF's train_deep_sdf.py, as sdflabel trains its decoder).

One step: draw each scene's rows (half from its positive set, half from
its negative set, uniformly with replacement), decode [code | xyz] through
the decoder with train-mode dropout, the clamped L1 over the rows plus the
code regulariser lambda * min(1, (epoch + 1) / 100) * mean ||z||, the
gradients of the decoder and of the code table, Adam (optax's arithmetic)
on each group with its staircase learning rate, then the codes projected
onto the CodeBound ball.

The rows and the dropout masks are drawn from a torch.Generator the
benchmark seeds, in the order the configuration's trainer draws them: the
positive rows' uniforms, the negative rows', then one uniform mask a
dropout layer in layer order. Drawn from a generator seeded alike, the
reference's rows and masks are the program's, so the two steps differ
only by the order and precision of their sums.
"""

from __future__ import annotations

import math

import torch


def leaves(tree) -> list:
    """The tree's tensors, dicts in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def leaf_names(tree, prefix: str = "") -> list[str]:
    """The dotted path of each of :func:`leaves`' tensors."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, it) for v in tree]
    return next(it)


def draw(pos, neg, pos_count, neg_count, scene_idx, samples: int, gen):
    half = samples // 2

    def rows(pack, counts, n):
        cnt = counts[scene_idx]
        u = torch.rand(scene_idx.shape[0], n, generator=gen,
                       device=pack.device)
        idx = torch.minimum((u * cnt[:, None]).long(), cnt[:, None] - 1)
        return pack.reshape(-1, 4)[scene_idx[:, None] * pack.shape[1] + idx]

    return torch.cat([rows(pos, pos_count, half),
                      rows(neg, neg_count, samples - half)], 1)


def decode(params: dict, spec: dict, inputs, gen):
    """The decoder on (R, L+3) rows, train mode: ReLU layers, each layer of
    spec["dropout"] followed by inverted dropout of prob
    spec["dropout_prob"] drawn from `gen`; tanh at the end."""
    n = sum(1 for k in params if k.startswith("lin"))
    x = inputs
    keep = 1.0 - spec["dropout_prob"]
    for l in range(n):
        if l in spec["latent_in"]:
            x = torch.cat([x, inputs], -1)
        p = params[f"lin{l}"]
        w = p["v"] * (p["g"] / torch.linalg.norm(p["v"], dim=0))[None] \
            if "v" in p else p["w"]
        x = x @ w + p["b"]
        if l < n - 1:
            x = torch.relu(x)
            if l in spec["dropout"]:
                m = torch.rand(x.shape, generator=gen, device=x.device) < keep
                x = torch.where(m, x / keep, torch.zeros((), device=x.device))
    return torch.tanh(x)[..., 0]


def adam(grads, state, lr):
    """optax.adam(lr) on a group: (updates, (count, mu, nu))."""
    count, mu, nu = state
    b1, b2, eps = 0.9, 0.999, 1e-8
    c = count + 1
    bc1 = 1.0 - b1 ** float(c)
    bc2 = 1.0 - b2 ** float(c)
    mu = [(1.0 - b1) * g + b1 * m for g, m in zip(grads, mu)]
    nu = [(1.0 - b2) * (g * g) + b2 * v for g, v in zip(grads, nu)]
    ups = [(m / bc1) / (torch.sqrt(v / bc2) + eps) * -lr
           for m, v in zip(mu, nu)]
    return ups, (c, mu, nu)


def step_lrs(config: dict, step: int, steps_per_epoch: int):
    """(decoder lr, codes lr): Initial * Factor ^ (1-based epoch //
    Interval), in float32."""
    e1 = step // max(1, steps_per_epoch) + 1
    out = []
    for sched in config["LearningRateSchedule"][:2]:
        f = torch.tensor(sched["Factor"], dtype=torch.float32)
        out.append(float(torch.tensor(sched["Initial"], dtype=torch.float32)
                         * f ** float(e1 // sched["Interval"])))
    return out


def train_steps(config: dict, params: dict, codes, pack, scene_batches,
                gen, steps_per_epoch: int, half_batch: bool = False):
    """Run len(scene_batches) steps from (params, codes). Returns each
    step's loss, the first step's gradients (decoder leaves, then the code
    table) and the final (params, codes). `half_batch`: the planted fault
    that steps on the first half of each batch's scenes alone, the mean
    taken over them."""
    spec = config["NetworkSpecs"]
    lat = config["CodeLength"]
    d = config["ClampingDistance"]
    samples = config["SamplesPerScene"]
    pos, neg, pos_count, neg_count = pack
    dec = [x.detach().clone() for x in leaves(params)]
    codes = codes.detach().clone()
    zeros = ([torch.zeros_like(x) for x in dec],
             [torch.zeros_like(codes)])
    st_dec = (0, zeros[0], [torch.zeros_like(x) for x in dec])
    st_codes = (0, zeros[1], [torch.zeros_like(codes)])
    losses, first = [], None
    for step, scene_idx in enumerate(scene_batches):
        rows = draw(pos, neg, pos_count, neg_count, scene_idx, samples, gen)
        lv = [x.requires_grad_(True) for x in dec]
        cv = codes.requires_grad_(True)
        p = rebuild(params, iter(lv))
        b = scene_idx.shape[0]
        z = cv[scene_idx]
        inputs = torch.cat([z[:, None, :].expand(b, samples, lat),
                            rows[..., :3]], -1).reshape(b * samples, -1)
        pred = decode(p, spec, inputs, gen).clamp(-d, d)
        err = (pred - rows[..., 3].clamp(-d, d).reshape(-1)).abs()
        if half_batch:
            keep = b // 2
            l1 = err.reshape(b, samples)[:keep].sum() / (keep * samples)
            zn = torch.linalg.norm(z[:keep], dim=-1).mean()
        else:
            l1 = err.sum() / (b * samples)
            zn = torch.linalg.norm(z, dim=-1).mean()
        epoch = step // max(1, steps_per_epoch)
        warm = min(1.0, float(torch.tensor(epoch + 1.0) / 100.0))
        loss = l1
        if config.get("CodeRegularization", True):
            loss = l1 + config["CodeRegularizationLambda"] * warm * zn
        g = torch.autograd.grad(loss, lv + [cv], allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi
             for x, gi in zip(lv + [cv], g)]
        if first is None:
            first = [x.detach().clone() for x in g]
        lr_d, lr_c = step_lrs(config, step, steps_per_epoch)
        up_d, st_dec = adam(g[:-1], st_dec, lr_d)
        (up_c,), st_codes = adam([g[-1]], st_codes, lr_c)
        dec = [x.detach() + u for x, u in zip(lv, up_d)]
        codes = cv.detach() + up_c
        bound = config.get("CodeBound")
        if bound is not None:
            nrm = torch.linalg.norm(codes, dim=-1, keepdim=True)
            codes = codes * torch.clamp(bound / nrm.clamp(min=1e-12),
                                        max=1.0)
        losses.append(float(loss.detach()))
    return losses, first, rebuild(params, iter(dec)), codes


def norm_gaps(prog: list, ref: list, skip=None) -> tuple[float, int]:
    """(the worst leaf's |norm(prog) - norm(ref)| over the larger of its
    reference norm and the median leaf's, the leaf's index); leaves in
    `skip` are left out."""
    norms = [float(torch.linalg.norm(r.float())) for r in ref]
    kept = [i for i in range(len(ref)) if not skip or i not in skip]
    med = sorted(norms[i] for i in kept)[len(kept) // 2] if kept else 0.0
    worst, at = 0.0, -1
    for i in kept:
        pn = float(torch.linalg.norm(prog[i].float()))
        den = max(norms[i], med)
        gap = abs(pn - norms[i]) / den if den > 0 else (
            0.0 if pn == 0 else math.inf)
        if not math.isfinite(pn):
            gap = math.inf
        if gap > worst or at < 0:
            worst, at = gap, i
    return worst, at
