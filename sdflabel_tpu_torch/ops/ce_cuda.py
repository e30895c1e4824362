"""Fused cross-entropy for the CSS training losses (kernel 5).

Counterpart of sdflabel_tpu/ops/ce_pallas.py::fused_cross_entropy: torch
``nn.CrossEntropyLoss(mean)`` over NCHW logits with its internal
log-softmax, forward and backward in csrc/ce.cu (whose source note says
what bounds them on the H100). CPU tensors take the plain version
:func:`cross_entropy_with_internal_softmax`; CUDA tensors the kernels.

Tolerance against the plain version: the kernel's online log-sum-exp and
per-block partial sums add in other orders than PyTorch's reductions, so
the loss agrees to fp32 reassociation (relative 1e-5) and each gradient
element to 1e-5 relative plus 1e-6 of the largest.
"""

from __future__ import annotations

import torch

from sdflabel_tpu_torch.ops import _cuda

CE_THREADS = 256  # pixels per block of the forward kernel: one partial each

CE_FWD = _cuda.CudaKernel("ce", "ce_fwd", [
    _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P])
CE_BWD = _cuda.CudaKernel("ce", "ce_bwd", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P])


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


def _fwd(x, t):
    dev = x.device
    b, c, hw = x.shape
    _cuda.check("logits", x, torch.float32, (b, c, hw), dev)
    _cuda.check("targets", t, torch.int32, (b, hw), dev)
    partial = torch.empty(-(-b * hw // CE_THREADS), device=dev,
                          dtype=torch.float32)
    CE_FWD(_cuda.ptr(x), _cuda.ptr(t), b, c, hw, _cuda.ptr(partial),
           _cuda.stream(x))
    return partial


def _bwd(x, t, scale):
    dev = x.device
    b, c, hw = x.shape
    _cuda.check("logits", x, torch.float32, (b, c, hw), dev)
    _cuda.check("targets", t, torch.int32, (b, hw), dev)
    _cuda.check("scale", scale, torch.float32, (1,), dev)
    dx = torch.empty_like(x)
    CE_BWD(_cuda.ptr(x), _cuda.ptr(t), _cuda.ptr(scale), b, c, hw,
           _cuda.ptr(dx), _cuda.stream(x))
    return dx


class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets):
        b, c, h, w = logits.shape
        x = logits.reshape(b, c, h * w).contiguous()
        t = targets.reshape(b, h * w).to(torch.int32).contiguous()
        ctx.save_for_backward(x, t)
        ctx.shape = logits.shape
        return _fwd(x, t).sum() / (b * h * w)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        b, _, h, w = ctx.shape
        scale = (g.float() / (b * h * w)).reshape(1).contiguous()
        return _bwd(x, t, scale).reshape(ctx.shape), None


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
