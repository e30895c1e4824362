"""Rotated-box IoU, vectorised over box pairs, in torch.

Counterpart of sdflabel_tpu/ops/rotated_iou.py (reference
pipelines/rotate_iou.py: the rotated IoU :257-325, the 3D finisher
:328-355, image_box_overlap :358-379). The intersection of two rotated
rectangles is clipped Sutherland-Hodgman style over a STATIC slot layout:
every clip by one of the query box's four half-planes writes input slot
i's vertex to output slot 2i and its edge crossing to slot 2i+1, each with
a validity bit, so capacity grows 4 -> 8 -> 16 -> 32 -> 64 and nothing is
compacted (see the JAX module for why a compacted layout is fragile at
degenerate inputs). Each (box, query) pair is then a fixed amount of
straight-line arithmetic, batched over all pairs.

Boxes are (cx, cy, w, h, angle) with the reference's clockwise-rotation
corner convention. Inputs and outputs are numpy; the arithmetic runs on
`device` (the card by default): fp32 for the rotated IoU, as the JAX
package computes it, and fp64 for the 3D finisher and the image boxes, as
its numpy does.
"""

from __future__ import annotations

import numpy as np
import torch

# Pairs per batch of the rotated IoU: 64 slots x 2 coordinates x 4 bytes
# for each live tensor keeps a batch's memory near 32 MB.
_PAIRS_PER_BATCH = 65536


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the CPU")
    return device


def box_corners(box: torch.Tensor) -> torch.Tensor:
    """(..., 5) boxes -> (..., 4, 2) corners (rotate_iou.py:206-239:
    x' = c*x + s*y + cx, y' = -s*x + c*y + cy)."""
    cx, cy, w, h, angle = box.unbind(-1)
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    xs = box.new_tensor([-0.5, -0.5, 0.5, 0.5]) * w[..., None]
    ys = box.new_tensor([-0.5, 0.5, 0.5, -0.5]) * h[..., None]
    px = c * xs + s * ys + cx[..., None]
    py = -s * xs + c * ys + cy[..., None]
    return torch.stack([px, py], dim=-1)


def _next_valid(valid: torch.Tensor) -> torch.Tensor:
    """Index of the cyclically next valid slot after each slot; 0 when no
    slot is valid (callers mask those out)."""
    k = valid.shape[-1]
    idx = torch.arange(k, device=valid.device)
    fwd = (idx[None, :] - idx[:, None] - 1) % k + 1  # cyclic distance 1..k
    fwd = torch.where(valid[..., None, :], fwd, k + 1)
    return torch.argmin(fwd, dim=-1)


def _gather(verts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(verts, -2, idx[..., None].expand(*idx.shape, 2))


def _polygon_signed_area(verts: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Shoelace area of the valid slots of a cyclic vertex list."""
    nxt = _gather(verts, _next_valid(valid))
    x, y = verts[..., 0], verts[..., 1]
    terms = torch.where(valid, x * nxt[..., 1] - nxt[..., 0] * y, 0.0)
    return 0.5 * terms.sum(-1)


def _clip_halfplane(verts, valid, a, b, c):
    """Clip the polygons (verts, valid) by a*x + b*y + c >= 0 (one
    half-plane per pair), static slots: slot i emits its vertex to 2i and
    its edge's crossing to 2i+1."""
    cur = verts
    nxt = _gather(verts, _next_valid(valid))
    a, b, c = a[..., None], b[..., None], c[..., None]
    d_cur = a * cur[..., 0] + b * cur[..., 1] + c
    d_nxt = a * nxt[..., 0] + b * nxt[..., 1] + c
    cur_in = d_cur >= 0
    nxt_in = d_nxt >= 0
    denom = d_cur - d_nxt
    t = d_cur / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    inter = cur + t[..., None] * (nxt - cur)
    shape = verts.shape[:-2]
    out = torch.stack([cur, inter], dim=-2).reshape(*shape, -1, 2)
    valid_out = torch.stack([valid & cur_in, valid & (cur_in != nxt_in)],
                            dim=-1).reshape(*shape, -1)
    return out, valid_out


def _intersection_area(corners1: torch.Tensor,
                       corners2: torch.Tensor) -> torch.Tensor:
    """Area of the intersection of two convex quads per pair."""
    verts = corners1
    valid = torch.ones(corners1.shape[:-1], dtype=torch.bool,
                       device=corners1.device)
    p = corners2
    q = torch.roll(corners2, -1, dims=-2)  # corner (i + 1) % 4
    a = q[..., 1] - p[..., 1]
    b = p[..., 0] - q[..., 0]
    c = -(a * p[..., 0] + b * p[..., 1])
    # orient each half-plane so that the quad's centroid is inside
    cen = corners2.mean(dim=-2)
    sign = torch.sign(a * cen[..., 0:1] + b * cen[..., 1:2] + c)
    sign = torch.where(sign == 0, 1.0, sign)
    a, b, c = a * sign, b * sign, c * sign
    for i in range(4):
        verts, valid = _clip_halfplane(verts, valid, a[..., i], b[..., i],
                                       c[..., i])
    return _polygon_signed_area(verts, valid).abs()


def _pair_iou(box: torch.Tensor, qbox: torch.Tensor,
              criterion: int) -> torch.Tensor:
    area1 = box[..., 2] * box[..., 3]
    area2 = qbox[..., 2] * qbox[..., 3]
    inter = _intersection_area(box_corners(box), box_corners(qbox))
    inter = torch.minimum(inter, torch.minimum(area1, area2))
    if criterion == -1:
        return inter / torch.clamp(area1 + area2 - inter, min=1e-12)
    if criterion == 0:
        return inter / torch.clamp(area1, min=1e-12)
    if criterion == 1:
        return inter / torch.clamp(area2, min=1e-12)
    return inter


def rotate_iou(boxes, query_boxes, criterion: int = -1,
               device="cuda") -> np.ndarray:
    """(N, 5) x (K, 5) -> (N, K) float32 rotated IoU (rotate_iou.py:289-325);
    criterion -1 IoU, 0 over the box's area, 1 over the query's, 2 the
    intersection area."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 5)
    query_boxes = np.asarray(query_boxes, np.float32).reshape(-1, 5)
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float32)
    dev = _device(device)
    bt = torch.as_tensor(boxes, device=dev)
    qt = torch.as_tensor(query_boxes, device=dev)
    rows = max(1, _PAIRS_PER_BATCH // k)
    out = [_pair_iou(bt[i:i + rows, None, :].expand(-1, k, 5),
                     qt[None, :, :].expand(min(rows, n - i), k, 5),
                     criterion) for i in range(0, n, rows)]
    return torch.cat(out).cpu().numpy()


def d3_box_overlap(boxes, qboxes, rinc, criterion=-1, camera_coordinate=True,
                   device="cuda") -> np.ndarray:
    """3D IoU finisher from the BEV intersection areas `rinc` (N, K)
    (rotate_iou.py:328-355); boxes (N, 7) and qboxes (K, 7) as the
    reference consumes them."""
    dev = _device(device)
    boxes = torch.as_tensor(np.asarray(boxes, np.float64), device=dev)
    qboxes = torch.as_tensor(np.asarray(qboxes, np.float64), device=dev)
    rinc = torch.as_tensor(np.asarray(rinc, np.float64), device=dev)
    if camera_coordinate:
        top = torch.minimum(boxes[:, 1][:, None], qboxes[:, 1][None, :])
        bot = torch.maximum((boxes[:, 1] - boxes[:, 4])[:, None],
                            (qboxes[:, 1] - qboxes[:, 4])[None, :])
    else:
        top = torch.minimum((boxes[:, 2] + boxes[:, 5])[:, None],
                            (qboxes[:, 2] + qboxes[:, 5])[None, :])
        bot = torch.maximum(boxes[:, 2][:, None], qboxes[:, 2][None, :])
    iw = top - bot
    has_bev = rinc > 0
    pos = has_bev & (iw > 0)
    area1 = (boxes[:, 3] * boxes[:, 4] * boxes[:, 5])[:, None]
    area2 = (qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5])[None, :]
    inc = iw * rinc
    if criterion == -1:
        ua = area1 + area2 - inc
    elif criterion == 0:
        ua = area1.expand_as(inc)
    elif criterion == 1:
        ua = area2.expand_as(inc)
    else:
        ua = inc
    out = torch.where(pos, inc / ua, torch.where(has_bev, 0.0, rinc))
    return out.cpu().numpy()


def image_box_overlap(boxes, query_boxes, criterion=-1,
                      device="cuda") -> np.ndarray:
    """Axis-aligned LTRB IoU matrix (rotate_iou.py:358-379), float64."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    query_boxes = np.asarray(query_boxes, np.float64).reshape(-1, 4)
    n, k = boxes.shape[0], query_boxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k), np.float64)
    dev = _device(device)
    b = torch.as_tensor(boxes, device=dev)
    q = torch.as_tensor(query_boxes, device=dev)
    iw = torch.minimum(b[:, None, 2], q[None, :, 2]) - torch.maximum(
        b[:, None, 0], q[None, :, 0])
    ih = torch.minimum(b[:, None, 3], q[None, :, 3]) - torch.maximum(
        b[:, None, 1], q[None, :, 1])
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    area_q = (q[:, 2] - q[:, 0]) * (q[:, 3] - q[:, 1])
    if criterion == -1:
        ua = area_b[:, None] + area_q[None, :] - inter
    elif criterion == 0:
        ua = area_b[:, None].expand_as(inter)
    elif criterion == 1:
        ua = area_q[None, :].expand_as(inter)
    else:
        ua = torch.ones_like(inter)
    return torch.where(inter > 0, inter / ua, 0.0).cpu().numpy()
