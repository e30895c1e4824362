"""The DeepSDF decoder's train-mode hidden layer after its matrix product:
bias add, ReLU and inverted dropout in one pass each way.

``y = where(u < keep, relu(z + b) / keep, 0)`` for z = x @ w (rows, C),
the bias b (C) and uniforms u drawn from the dropout generator. CPU
tensors take the plain version :func:`bias_relu_dropout_plain` (the chain
as models/deepsdf.py computes it); CUDA tensors the kernels of
csrc/bias_relu_dropout.cu, whose source note says what bounds them on the
H100 and how the design follows: the forward (``BRD_FWD``), and the
backward (``BRD_BWD``) that writes the gradient of z and each CTA's column
sums of it, which ``BRD_REDUCE`` adds in CTA order into the bias's
gradient. The autograd function keeps only y, the tensor the next layer's
matrix product keeps too.

y and the gradient of z are bit-equal to PyTorch's chain on the card on
finite inputs; the bias's gradient adds the same terms in another order
than PyTorch's column sum (within fp32 round-off of it, see
:func:`sum_depth`). The uniforms are one ``torch.rand`` of the whole
batch a call (:func:`uniforms`), the draw of every dropout of the
decoder (:func:`dropout`), so that a generator gives the same masks on
either route.
"""

from __future__ import annotations

import numpy as np
import torch

from sdflabel_tpu_torch.ops import _cuda

THREADS = 256  # threads a CTA at most
MIN_ROWS = 4  # rows a thread takes at least: a full batch of its loads
TARGET_CTAS = 1024  # about a wave or two of CTAs on 132 SMs
REDUCE_WARPS = 8  # the reduction's contiguous CTA ranges (a launch argument)

_P, _I, _F = _cuda.P, _cuda.I, _cuda.F
_L = _cuda.L
BRD_FWD = _cuda.CudaKernel("bias_relu_dropout", "brd_forward", [
    _P, _P, _P, _L, _I, _I, _I, _I, _L, _I, _F, _F, _P, _P])
BRD_BWD = _cuda.CudaKernel("bias_relu_dropout", "brd_backward", [
    _P, _L, _P, _L, _I, _I, _I, _I, _L, _I, _F, _P, _P, _P])
BRD_REDUCE = _cuda.CudaKernel("bias_relu_dropout", "brd_reduce", [
    _P, _I, _I, _I, _P, _P])


def uniforms(x: torch.Tensor, generator: torch.Generator,
             rows: tuple[int, int] | None = None) -> torch.Tensor:
    """The uniforms of a dropout of x: one draw from `generator` on x's
    device shaped as x, or with `rows` (lo, n), shaped (n, ...) of which
    x's rows are rows lo.. (a data-parallel rank's share of a batch)."""
    if rows is None:
        return torch.rand(x.shape, generator=generator, device=x.device)
    u = torch.rand((rows[1],) + tuple(x.shape[1:]), generator=generator,
                   device=x.device)
    return u[rows[0]:rows[0] + x.shape[0]]


def drop(x: torch.Tensor, u: torch.Tensor, keep: float) -> torch.Tensor:
    """Inverted dropout on the uniforms u: x / keep where u < keep, else
    0."""
    return torch.where(u < keep, x / keep, torch.zeros((), device=x.device))


def dropout(x: torch.Tensor, keep: float, generator: torch.Generator,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout that keeps each element with probability `keep`,
    on :func:`uniforms` drawn from `generator`."""
    return drop(x, uniforms(x, generator, rows), keep)


def bias_relu_dropout_plain(z: torch.Tensor, b: torch.Tensor,
                            u: torch.Tensor, keep: float) -> torch.Tensor:
    """Plain version: relu(z + b) under :func:`drop` on the uniforms u."""
    return drop(torch.relu(z + b), u, keep)


def inv_keep(keep: float) -> float:
    """1 / keep in float32, as PyTorch's CUDA division by a CPU scalar
    computes the factor it multiplies by."""
    return float(np.float32(1.0) / np.float32(keep))


def plan(rows: int, cols: int, align: int = 16) -> dict:
    """How the kernels cut (rows, cols): `vec` columns a thread (4 where
    cols % 4 == 0 and every operand is 16-byte aligned, 2 where cols % 2
    == 0 and they are 8-byte aligned, else 1; `align` is the largest of
    16, 8, 4 that every address divides), a CTA of bx x by threads (bx
    covers the column groups, a warp at least; by = 256 // bx rows side
    by side), `tile` rows a CTA, `ctas` CTAs."""
    vec = (4 if cols % 4 == 0 and align % 16 == 0 else
           2 if cols % 2 == 0 and align % 8 == 0 else 1)
    groups = cols // vec
    bx = min(-(-groups // 32) * 32, THREADS)
    by = max(1, THREADS // bx)
    tile = max(by * MIN_ROWS, -(-rows // TARGET_CTAS))
    return dict(vec=vec, bx=bx, by=by, tile=tile,
                ctas=max(1, -(-rows // tile)))


def sum_depth(p: dict) -> int:
    """The most additions any column of the bias's gradient chains in
    the kernels' order (a thread's rows, the CTA's threads, the CTAs of a
    reduction warp, the warps): |gb - sum| <= depth * 2^-24 * sum |gz|."""
    rows_a_thread = -(-p["tile"] // p["by"])
    span = -(-p["ctas"] // REDUCE_WARPS)
    return rows_a_thread + p["by"] + span + REDUCE_WARPS


def _align(*addresses: int) -> int:
    """The largest of 16, 8 and 4 that divides every address (or byte
    stride)."""
    for a in (16, 8):
        if all(x % a == 0 for x in addresses):
            return a
    return 4


def _fwd(z: torch.Tensor, b: torch.Tensor, u: torch.Tensor,
         keep: float) -> torch.Tensor:
    """z, u (rows, C) contiguous float32 on one card, b (C) -> y."""
    dev = z.device
    rows, cols = z.shape
    _cuda.check("z", z, torch.float32, (rows, cols), dev)
    _cuda.check("b", b, torch.float32, (cols,), dev)
    _cuda.check("u", u, torch.float32, (rows, cols), dev)
    y = torch.empty_like(z)
    p = plan(rows, cols, _align(*map(_cuda.ptr, (z, b, u, y))))
    BRD_FWD(_cuda.ptr(z), _cuda.ptr(b), _cuda.ptr(u), rows, cols, p["vec"],
            p["bx"], p["by"], p["tile"], p["ctas"], keep, inv_keep(keep),
            _cuda.ptr(y), _cuda.stream(z))
    return y


def _bwd(g: torch.Tensor, y: torch.Tensor,
         keep: float) -> tuple[torch.Tensor, torch.Tensor]:
    """g (rows, C) float32 with unit column stride (any row stride), y
    (rows, C) contiguous -> (gz (rows, C), gb (C))."""
    dev = y.device
    rows, cols = y.shape
    _cuda.check("y", y, torch.float32, (rows, cols), dev)
    if g.shape != y.shape or g.dtype != torch.float32 or g.device != dev:
        raise ValueError(f"g: {g.dtype} {tuple(g.shape)} on {g.device}, "
                         f"expected float32 {(rows, cols)} on {dev}")
    if g.stride(1) != 1 or g.stride(0) < cols:
        g = g.contiguous()
    gz = torch.empty_like(y)
    if rows == 0:  # no CTA would write the partial sums the reduction adds
        return gz, torch.zeros(cols, device=dev, dtype=torch.float32)
    p = plan(rows, cols, _align(*map(_cuda.ptr, (g, y, gz)),
                                4 * g.stride(0)))
    partial = torch.empty(p["ctas"], cols, device=dev, dtype=torch.float32)
    gb = torch.empty(cols, device=dev, dtype=torch.float32)
    BRD_BWD(_cuda.ptr(g), g.stride(0), _cuda.ptr(y), rows, cols, p["vec"],
            p["bx"], p["by"], p["tile"], p["ctas"], inv_keep(keep),
            _cuda.ptr(gz), _cuda.ptr(partial), _cuda.stream(y))
    BRD_REDUCE(_cuda.ptr(partial), p["ctas"], cols, REDUCE_WARPS,
               _cuda.ptr(gb), _cuda.stream(y))
    return gz, gb


class _BiasReluDropout(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, b, u, keep):
        y = _fwd(z, b, u, keep)
        ctx.save_for_backward(y)
        ctx.keep = keep
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        gz, gb = _bwd(g, y, ctx.keep)
        return gz, gb, None, None


def bias_relu_dropout(z: torch.Tensor, b: torch.Tensor, keep: float,
                      generator: torch.Generator,
                      rows: tuple[int, int] | None = None) -> torch.Tensor:
    """relu(z + b) under inverted dropout that keeps each element with
    probability `keep`, for z (..., C) float32 and b (C), on
    :func:`uniforms` drawn from `generator` (with `rows`, for z's rows of
    a batch). Differentiable in z and b."""
    u = uniforms(z, generator, rows)
    if z.device.type == "cpu":
        return bias_relu_dropout_plain(z, b, u, keep)
    cols = z.shape[-1]
    y = _BiasReluDropout.apply(z.reshape(-1, cols).contiguous(), b,
                               u.reshape(-1, cols), keep)
    return y.reshape(z.shape)
