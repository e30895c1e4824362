"""Fused cross-entropy for the CSS training losses (kernel 5).

Counterpart of sdflabel_tpu/ops/ce_pallas.py::fused_cross_entropy: torch
``nn.CrossEntropyLoss(mean)`` over NCHW logits with its internal
log-softmax, forward and backward in csrc/ce.cu (whose source note says
what bounds them on the H100 and how the designs follow). CPU tensors
take the plain version :func:`cross_entropy_with_internal_softmax`; CUDA
tensors the kernels: the class-split forward (``CE_FWD``), which also
writes each pixel's log-sum-exp, and the backward from that saved
log-sum-exp (``CE_BWD``), one read of the logits and one write of the
gradient. The first designs (``CE_FWD_FIRST``, ``CE_BWD_FIRST``: one
thread per pixel, the backward recomputing the log-sum-exp) are kept as
yardsticks and launched only through ``design="first"``, by measurements
and tests. Targets are read as int32 or int64 as the caller holds them.

Tolerance against the plain version: the kernels' log-sum-exp and
per-block partial sums add in other orders than PyTorch's reductions, so
the loss agrees to fp32 reassociation (relative 1e-5) and each gradient
element to 1e-5 relative plus 1e-6 of the largest.
"""

from __future__ import annotations

import torch

from sdflabel_tpu_torch.ops import _cuda

CE_THREADS = 256  # pixels per block of the first forward: one partial each
SPLIT_WARPS = 8  # warps per CTA of the class-split forward
CHUNK = 16  # classes a forward thread loads before any arithmetic

_P, _I = _cuda.P, _cuda.I
CE_FWD = _cuda.CudaKernel("ce", "ce_fwd_split", [
    _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P])
CE_BWD = _cuda.CudaKernel("ce", "ce_bwd_lse", [
    _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P])
CE_FWD_FIRST = _cuda.CudaKernel("ce", "ce_fwd", [
    _P, _P, _I, _I, _I, _I, _P, _P])
CE_BWD_FIRST = _cuda.CudaKernel("ce", "ce_bwd", [
    _P, _P, _I, _P, _I, _I, _I, _I, _P, _P])


def cross_entropy_with_internal_softmax(logits: torch.Tensor,
                                        targets: torch.Tensor,
                                        class_axis: int = 1) -> torch.Tensor:
    """Plain version: torch nn.CrossEntropyLoss(mean) on raw inputs, which
    applies log_softmax even to inputs that already are log-probabilities
    (css_train.py:42-58). The pick is a gather; the JAX package's one-hot
    sum has exactly one nonzero term, so the values are the same."""
    logp = torch.log_softmax(logits, dim=class_axis)
    picked = logp.gather(class_axis, targets.long().unsqueeze(class_axis))
    return -picked.mean()


def fwd_plan(c: int, hw: int, aligned: bool = True,
             warps: int = SPLIT_WARPS, chunk: int = CHUNK) -> dict:
    """How the class-split forward cuts (B, C, H*W) logits: `groups` warp
    groups over the classes, each `per_group` classes (a multiple of
    `chunk`; the last groups may hold fewer or none), `vec` pixels a lane
    (4 where H*W % 4 == 0 and logits and targets are 16-byte aligned,
    else 1), a tile of `tile` pixels a CTA and `tiles` tiles an image.
    `warps` and `chunk` are the kernel's SPLIT_WARPS and CHUNK (other
    values only for scripts/ce_sweep.py's variants)."""
    groups = min(warps, 8)
    while groups > 1 and groups > -(-c // chunk):
        groups //= 2
    per_group = -(-(-(-c // groups)) // chunk) * chunk
    vec = 4 if hw % 4 == 0 and aligned else 1
    tile = warps // groups * 32 * vec
    return dict(groups=groups, per_group=per_group, vec=vec, tile=tile,
                tiles=-(-hw // tile))


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check(x, t):
    dev = x.device
    b, c, hw = x.shape
    _cuda.check("logits", x, torch.float32, (b, c, hw), dev)
    if t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"targets: dtype {t.dtype}, expected int32 or "
                         "int64")
    _cuda.check("targets", t, t.dtype, (b, hw), dev)
    return b, c, hw


def _fwd(x, t, design: str = "split"):
    """x (B, C, HW) float32, t (B, HW) int32 or int64 -> (per-block partial
    sums of lse - x[t], lse (B, HW) or None for the first design)."""
    b, c, hw = _check(x, t)
    dev = x.device
    if design == "first":
        partial = torch.empty(-(-b * hw // CE_THREADS), device=dev,
                              dtype=torch.float32)
        CE_FWD_FIRST(_cuda.ptr(x), _cuda.ptr(t), t.element_size(), b, c, hw,
                     _cuda.ptr(partial), _cuda.stream(x))
        return partial, None
    if design != "split":
        raise ValueError(f"design {design!r}: expected 'split' or 'first'")
    plan = fwd_plan(c, hw, _aligned(x, t))
    partial = torch.empty(b * plan["tiles"], device=dev, dtype=torch.float32)
    lse = torch.empty(b, hw, device=dev, dtype=torch.float32)
    CE_FWD(_cuda.ptr(x), _cuda.ptr(t), t.element_size(), b, c, hw,
           plan["groups"], plan["per_group"], plan["vec"], _cuda.ptr(lse),
           _cuda.ptr(partial), _cuda.stream(x))
    return partial, lse


def _bwd(x, t, lse, g, n: int, design: str = "saved_lse"):
    """dx = (softmax(x) - one_hot(t)) * g / n for x, t as `_fwd` takes
    them, `lse` from the split forward (None for the first design, which
    recomputes it) and g the upstream cotangent, a float32 scalar."""
    b, c, hw = _check(x, t)
    dev = x.device
    _cuda.check("g", g, torch.float32, (), dev)
    dx = torch.empty_like(x)
    if design == "first":
        CE_BWD_FIRST(_cuda.ptr(x), _cuda.ptr(t), t.element_size(),
                     _cuda.ptr(g), n, b, c, hw, _cuda.ptr(dx),
                     _cuda.stream(x))
        return dx
    if design != "saved_lse":
        raise ValueError(f"design {design!r}: expected 'saved_lse' or "
                         "'first'")
    _cuda.check("lse", lse, torch.float32, (b, hw), dev)
    vec = 4 if hw % 4 == 0 and _aligned(x, t, lse, dx) else 1
    CE_BWD(_cuda.ptr(x), _cuda.ptr(t), t.element_size(), _cuda.ptr(lse),
           _cuda.ptr(g), n, b, c, hw, vec, _cuda.ptr(dx), _cuda.stream(x))
    return dx


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets):
        b, c, h, w = logits.shape
        x = logits.reshape(b, c, h * w).contiguous()
        t = targets.reshape(b, h * w)
        if t.dtype not in (torch.int32, torch.int64):
            t = t.long()
        t = t.contiguous()
        partial, lse = _fwd(x, t)
        ctx.save_for_backward(x, t, lse)
        ctx.shape = logits.shape
        return partial.sum() / (b * h * w)

    @staticmethod
    def backward(ctx, g):
        x, t, lse = ctx.saved_tensors
        b, _, h, w = ctx.shape
        return _bwd(x, t, lse, g.float(), b * h * w).reshape(ctx.shape), None


def fused_cross_entropy(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """torch nn.CrossEntropyLoss(mean) over (B, C, H, W) float32 logits and
    (B, H, W) integer targets. Differentiable w.r.t. the logits only."""
    if logits.dim() != 4 or targets.shape != (logits.shape[0],
                                              *logits.shape[2:]):
        raise ValueError(f"logits {tuple(logits.shape)} and targets "
                         f"{tuple(targets.shape)}: expected (B, C, H, W) "
                         "and (B, H, W)")
    if logits.dtype != torch.float32:
        raise ValueError(f"logits: dtype {logits.dtype}, expected float32")
    if logits.device.type == "cpu":
        return cross_entropy_with_internal_softmax(logits, targets)
    return _FusedCE.apply(logits, targets)
