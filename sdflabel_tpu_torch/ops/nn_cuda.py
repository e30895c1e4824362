"""Streaming top-1 nearest neighbour (kernel 2).

Counterpart of sdflabel_tpu/ops/nn_pallas.py. The kernels live in
csrc/nn.cu, whose source note says what bounds them on the H100 and how
the designs follow: the split design (``NN_FWD``, every launch) splits the
data points over a cluster of up to 8 CTAs per query block and merges the
slices' first minima in rank order, and takes a crop axis (B crops in one
launch, as the TPU kernel gains a batch grid axis under vmap; each crop
equal to its launch alone); the first design (``NN_FIRST``, one
thread per query over all data) is kept as its yardstick and is launched
only by measurements and tests. Both are bit-identical to the plain
version (ops/knn.py::nearest_neighbor_plain): same per-pair arithmetic,
same first-min index. Non-differentiable: callers pass detached inputs.
"""

from __future__ import annotations

import math

import torch

from sdflabel_tpu_torch.ops import _cuda

BIG = 1e30  # masked-column sentinel of the squared distance

NN_FWD = _cuda.CudaKernel("nn", "nn_fwd", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P,
    _cuda.P, _cuda.P])
NN_FIRST = _cuda.CudaKernel("nn", "nn_first", [
    _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.P])


def split_slices(n: int, m: int) -> int:
    """CTAs (data slices) that share each query block in the split design
    for n queries against m data points, on the current card."""
    return _cuda.query("nn", "nn_slices", n, m)


def nearest_neighbor_fused(query: torch.Tensor, data: torch.Tensor,
                           data_mask: torch.Tensor | None = None,
                           kernel: _cuda.CudaKernel = NN_FWD,
                           slices: int = 0
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,3) query, (M,3) data, optional (M,) mask (nonzero: valid) on a
    CUDA device -> (squared min distance (N,) float32, index (N,) int64).
    A fully masked row gives 1e30 and index 0. `kernel` is NN_FWD (the
    split design; `slices` > 0 forces its cluster size) or NN_FIRST.
    NN_FWD also takes a crop axis: (B, N, 3) queries, (B, M, 3) data and a
    (B, M) mask give (B, N) results in one launch. Contiguous float32
    points and a bool mask are read as they are: the kernel is then the
    only launch."""
    if query.device.type != "cuda":
        raise ValueError("nearest_neighbor_fused launches a CUDA kernel; "
                         f"got a tensor on {query.device}")
    dev = query.device
    lead = tuple(query.shape[:-2])
    if lead and kernel is not NN_FWD:
        raise ValueError(f"{kernel.symbol} takes one crop, got {lead}")
    n, m = query.shape[-2], data.shape[-2]
    q = query.detach().float().contiguous()
    d = data.detach().float().contiguous()
    _cuda.check("query", q, torch.float32, (*lead, n, 3), dev)
    _cuda.check("data", d, torch.float32, (*lead, m, 3), dev)
    mask_ptr = None
    if data_mask is not None:
        mask = data_mask.detach()
        if mask.dtype != torch.bool:
            mask = mask != 0
        mask = mask.contiguous()
        _cuda.check("data_mask", mask, torch.bool, (*lead, m), dev)
        mask_ptr = _cuda.ptr(mask)
    d2 = torch.empty(*lead, n, device=dev, dtype=torch.float32)
    idx = torch.empty(*lead, n, device=dev, dtype=torch.int64)
    batch = (math.prod(lead),) if kernel is NN_FWD else ()
    extra = (slices,) if kernel is NN_FWD else ()
    kernel(_cuda.ptr(q), _cuda.ptr(d), mask_ptr, *batch, n, m, *extra,
           _cuda.ptr(d2), _cuda.ptr(idx), _cuda.stream(q))
    return d2, idx
