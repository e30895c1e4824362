"""Streaming top-1 nearest neighbour (kernel 2).

Counterpart of sdflabel_tpu/ops/nn_pallas.py. The kernel lives in
csrc/nn.cu, whose source note says what bounds it on the H100 and how the
design follows. It is bit-identical to the plain version
(ops/knn.py::nearest_neighbor_plain): same per-pair arithmetic, same
first-min index. Non-differentiable: callers pass detached inputs.
"""

from __future__ import annotations

import torch

from sdflabel_tpu_torch.ops import _cuda

BIG = 1e30  # masked-column sentinel of the squared distance

NN_FWD = _cuda.CudaKernel("nn", "nn_fwd", [
    _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.P, _cuda.P, _cuda.P])


def nearest_neighbor_fused(query: torch.Tensor, data: torch.Tensor,
                           data_mask: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,3) query, (M,3) data on a CUDA device -> (squared min distance
    (N,) float32, index (N,) int64). A fully masked row gives 1e30 and
    index 0."""
    if query.device.type != "cuda":
        raise ValueError("nearest_neighbor_fused launches a CUDA kernel; "
                         f"got a tensor on {query.device}")
    dev = query.device
    n, m = query.shape[0], data.shape[0]
    mask = (torch.ones(m, device=dev) if data_mask is None
            else data_mask.to(torch.float32))
    q = query.detach().float().contiguous()
    packed = torch.cat([data.detach().float(), mask[:, None]], 1).contiguous()
    _cuda.check("query", q, torch.float32, (n, 3), dev)
    _cuda.check("data", packed, torch.float32, (m, 4), dev)
    d2 = torch.empty(n, device=dev, dtype=torch.float32)
    idx = torch.empty(n, device=dev, dtype=torch.int32)
    NN_FWD(_cuda.ptr(q), _cuda.ptr(packed), n, m, _cuda.ptr(d2),
           _cuda.ptr(idx), _cuda.stream(q))
    return d2, idx.long()
