"""Brute-force nearest neighbour, the replacement for the reference's
KDTree calls (optimizer.py:180-181, pose.py:136-137).

Counterpart of sdflabel_tpu/ops/knn.py. CUDA tensors go through kernel 2
(ops/nn_cuda.py); CPU tensors through the plain version below, which the
kernel matches bit for bit.
"""

from __future__ import annotations

import torch

from sdflabel_tpu_torch.ops import nn_cuda

# rows of the plain version's (rows, M) distance block
_PLAIN_ROWS = 4096


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, M) squared distances via one fp32 matmul (TF32 stays off)."""
    aa = (a * a).sum(-1)[:, None]
    bb = (b * b).sum(-1)[None, :]
    return torch.clamp(aa - 2.0 * (a @ b.T) + bb, min=0.0)


def nearest_neighbor_plain(query: torch.Tensor, data: torch.Tensor,
                           data_mask: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel 2: exact fp32 (t0^2 + t1^2) + t2^2 per pair,
    masked columns at +inf, first-min index. Returns (squared distance,
    index). Works in row blocks so that no (N, M) matrix is built."""
    d2_out, idx_out = [], []
    masked = None if data_mask is None else ~data_mask.bool()[None, :]
    for r0 in range(0, max(query.shape[0], 1), _PLAIN_ROWS):
        q = query[r0:r0 + _PLAIN_ROWS]
        d2 = (q[:, None, 0] - data[None, :, 0]).square_()
        d2.add_((q[:, None, 1] - data[None, :, 1]).square_())
        d2.add_((q[:, None, 2] - data[None, :, 2]).square_())
        if masked is not None:
            d2.masked_fill_(masked, float("inf"))
        # min and argmin in one pass; the index is the first minimal one
        d2_min, idx = torch.min(d2, dim=-1)
        d2_out.append(d2_min)
        idx_out.append(idx)
    return torch.cat(d2_out), torch.cat(idx_out)


def nearest_neighbor(query: torch.Tensor, data: torch.Tensor,
                     data_mask: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-1 NN of each query point: (euclidean distance (N,), index (N,)).
    Masked data points are excluded; a row with no valid data point gets
    distance inf and index 0. Carries no gradient. With a crop axis,
    (B, N, 3) queries against (B, M, 3) data and a (B, M) mask give (B, N)
    results, crop by crop: on the card one launch for all crops."""
    query, data = query.detach(), data.detach()
    if query.device.type == "cpu":
        if query.dim() == 3:
            out = [nearest_neighbor(query[b], data[b], None if data_mask
                                    is None else data_mask[b])
                   for b in range(query.shape[0])]
            return tuple(torch.stack(t) for t in zip(*out))
        d2, idx = nearest_neighbor_plain(query, data, data_mask)
        return torch.sqrt(d2), idx
    d2, idx = nn_cuda.nearest_neighbor_fused(query, data, data_mask)
    dist = torch.sqrt(d2)
    # the kernel's masked sentinel is sqrt(1e30) ~ 1e15: map it to inf
    return torch.where(dist >= 1e14, torch.full_like(dist, float("inf")),
                       dist), idx
