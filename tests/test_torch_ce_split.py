"""A plain PyTorch model of the class-split cross-entropy forward and the
saved-lse backward (csrc/ce.cu, ce_fwd_split_kernel and ce_bwd_lse_kernel)
against the JAX package's fused Pallas kernel in interpret mode (as
tests/test_torch_ce.py runs it) and its jnp path
(engine/css_train.py::cross_entropy_with_internal_softmax).

The model follows the kernels' order of sums under the plan that
ops/ce_cuda.py::fwd_plan picks: each warp group takes its classes in
chunks of 16 (the chunk's max, one rescale of the running sum, then the
chunk's exps in class order, a missing class at -inf); the groups' (max,
sum) pairs merge in group order; lse = max + log(sum). The CTA partial of a tile adds
lse - x[t] over the tile's pixels i, i + 256, ... per thread, then over
each warp's 32 lanes by a butterfly (lane l adds lane l ^ 16, ^ 8, ..., ^ 1)
and then the 8 warps in order; one partial per tile in CTA order. The
backward is (exp(x - lse) - one_hot(t)) * g / n from the forward's lse. A
target outside [0, C) picks nothing.

Tolerance, as tests/test_torch_ce.py: the loss to 1e-5 relative, each
gradient element to 1e-5 relative plus 1e-6 of the largest. The two JAX
routes part at a target outside [0, C): the fused kernel, like the port's
kernels, adds lse_p to the loss and softmax * g / n to the gradient there,
while the jnp path's term is 0 and does not depend on the logits. Those
cases are held against the fused kernel.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import css_train as jtrain
from sdflabel_tpu.ops import ce_pallas
from sdflabel_tpu_torch.ops import ce_cuda

THREADS = ce_cuda.SPLIT_WARPS * 32
COT = 2.5  # upstream cotangent != 1


def _interpret_ctx():
    if jax.default_backend() == "tpu":
        return contextlib.nullcontext()
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _base(nm):
    """The running max, or 0 where it is -inf (every term then 0)."""
    return torch.where(nm == float("-inf"), torch.zeros_like(nm), nm)


def _group_ms(x, k0, k1):
    """One warp group's running (max, sum) over classes [k0, k1) of x
    (B, C, HW), chunk by chunk."""
    b, _, hw = x.shape
    m = torch.full((b, hw), float("-inf"))
    s = torch.zeros(b, hw)
    for k in range(k0, k1, ce_cuda.CHUNK):
        v = x[:, k:min(k + ce_cuda.CHUNK, k1)]
        pad = ce_cuda.CHUNK - v.shape[1]
        v = torch.cat([v, torch.full((b, pad, hw), float("-inf"))], 1)
        nm = torch.maximum(m, v.max(1).values)
        base = _base(nm)
        acc = s * torch.exp(m - base)
        for i in range(ce_cuda.CHUNK):
            acc = acc + torch.exp(v[:, i] - base)
        m, s = nm, acc
    return m, s


def split_forward(x, t, plan):
    """(partials (B * tiles,), lse (B, HW)) of the class-split forward."""
    b, c, hw = x.shape
    per = plan["per_group"]
    m, s = _group_ms(x, 0, min(c, per))
    for g in range(1, plan["groups"]):
        mg, sg = _group_ms(x, min(c, g * per), min(c, g * per + per))
        nm = torch.maximum(m, mg)
        base = _base(nm)
        s = s * torch.exp(m - base) + sg * torch.exp(mg - base)
        m = nm
    lse = m + torch.log(s)
    valid = (t >= 0) & (t < c)
    picked = x.gather(1, torch.where(valid, t, 0).long()[:, None])[:, 0]
    term = lse - torch.where(valid, picked, torch.zeros_like(picked))
    tile, tiles = plan["tile"], plan["tiles"]
    term = torch.cat([term, torch.zeros(b, tiles * tile - hw)], 1)
    term = term.reshape(b * tiles, tile)
    # thread i adds the tile's pixels i, i + 256, ... in order
    per_thread = -(-tile // THREADS)
    term = torch.cat([term, torch.zeros(b * tiles,
                                        per_thread * THREADS - tile)], 1)
    term = term.reshape(b * tiles, per_thread, THREADS)
    red = torch.zeros(b * tiles, THREADS)
    for u in range(per_thread):
        red = red + term[:, u]
    red = red.reshape(b * tiles, THREADS // 32, 32)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):  # the butterfly over a warp's lanes
        red = red + red[:, :, lanes ^ off]
    part = red[:, 0, 0]
    for w in range(1, THREADS // 32):  # the warps in order
        part = part + red[:, w, 0]
    return part, lse


def split_loss_and_grad(logits, targets, aligned=True):
    """The model's loss and d(COT * loss)/d(logits) for (B, C, H, W)
    logits and (B, H, W) targets, as numpy arrays."""
    b, c, h, w = logits.shape
    x = torch.as_tensor(logits).reshape(b, c, h * w)
    t = torch.as_tensor(targets).reshape(b, h * w)
    partial, lse = split_forward(x, t, ce_cuda.fwd_plan(c, h * w, aligned))
    loss = partial.sum() / (b * h * w)
    scale = torch.tensor(COT, dtype=torch.float32) / (b * h * w)
    one_hot = (torch.arange(c)[None, :, None] == t[:, None]).float()
    dx = (torch.exp(x - lse[:, None]) - one_hot) * scale
    return float(loss) * COT, dx.reshape(logits.shape).numpy()


def _inputs(c, shape, out_of_range, seed):
    b, h, w = shape
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, c, h, w) * 3).astype(np.float32)
    targets = rng.randint(0, c, (b, h, w)).astype(np.int32)
    if out_of_range:
        bad = rng.uniform(size=targets.shape) < 0.2
        targets[bad] = rng.choice([-1, c, c + 5, 2 ** 31 - 1], bad.sum())
    return logits, targets


def _jax_loss_and_grad(fn, logits, targets):
    loss, grad = jax.value_and_grad(
        lambda x: COT * fn(x, jnp.asarray(targets)))(jnp.asarray(logits))
    return float(loss), np.asarray(grad)


def _close(g, ref):
    np.testing.assert_allclose(g, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


CASES = [  # (C, (B, H, W), targets outside [0, C), 16-byte aligned)
    (c, shape, oob, aligned)
    for c in (2, 3, 256)
    for shape, oob, aligned in (((2, 16, 128), False, True),
                                ((2, 16, 128), True, True),
                                ((2, 16, 128), True, False),
                                ((1, 7, 9), False, True))
]


@pytest.mark.parametrize("c,shape,out_of_range,aligned", CASES)
def test_split_model_matches_jax(c, shape, out_of_range, aligned):
    logits, targets = _inputs(c, shape, out_of_range, seed=c)
    loss, grad = split_loss_and_grad(logits, targets, aligned)
    plan = ce_cuda.fwd_plan(c, shape[1] * shape[2], aligned)
    assert plan["vec"] == (4 if aligned and shape[2] % 4 == 0 else 1)

    refs = []
    if not out_of_range:
        refs.append(_jax_loss_and_grad(
            jtrain.cross_entropy_with_internal_softmax, logits, targets))
    if ce_pallas.supported(logits.shape, targets.shape):
        with _interpret_ctx():
            refs.append(_jax_loss_and_grad(ce_pallas.fused_cross_entropy,
                                           logits, targets))
    assert refs
    for jl, jg in refs:
        assert loss == pytest.approx(jl, rel=1e-5)
        _close(grad, jg)


@pytest.mark.parametrize("c,hw,want", [
    # the train towers: 8 groups of 32 classes on 128-pixel tiles; the mask
    # tower's 2 classes in one group on 1024-pixel tiles
    (256, 128 * 128, dict(groups=8, per_group=32, vec=4, tile=128,
                          tiles=128)),
    (2, 128 * 128, dict(groups=1, per_group=16, vec=4, tile=1024,
                        tiles=16)),
    (257, 63, dict(groups=8, per_group=48, vec=1, tile=32, tiles=2)),
    (40, 40 * 56, dict(groups=2, per_group=32, vec=4, tile=512, tiles=5)),
])
def test_fwd_plan(c, hw, want):
    plan = ce_cuda.fwd_plan(c, hw)
    assert plan == want
    # the groups cover every class
    assert plan["groups"] * plan["per_group"] >= c
