"""The port's rotated IoU, 3D finisher and image-box IoU against
sdflabel_tpu.ops.rotated_iou on seeded random boxes and on identical,
touching, nested and disjoint pairs. Tolerance 1e-5: the same fp32 (rotated
IoU) and fp64 (3D, image) arithmetic, with sums in other orders."""

import numpy as np
import pytest

from sdflabel_tpu.ops import rotated_iou as jriou
from sdflabel_tpu_torch.ops import rotated_iou as triou


def _random_boxes(rng, n):
    return np.stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                     rng.uniform(0.5, 4, n), rng.uniform(0.5, 5, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def _special_boxes():
    """Identical, touching, nested and disjoint pairs (box i with box
    i + 6)."""
    a = np.array([[0, 0, 2, 4, 0.3], [0, 0, 2, 2, 0], [1, 1, 4, 4, 0.7],
                  [0, 0, 1, 1, 0], [5, 5, 1, 2, 1.2], [0, 0, 3, 1, 0]],
                 np.float32)
    b = np.array([[0, 0, 2, 4, 0.3],  # identical
                  [2, 0, 2, 2, 0],  # touching along an edge
                  [1, 1, 1, 1, 0.2],  # nested
                  [10, 10, 1, 1, 0],  # disjoint
                  [5, 5, 2, 1, 1.2 + np.pi / 2],  # the same box, turned
                  [0, 0, 1, 3, 0]], np.float32)  # a cross
    return a, b


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotate_iou_matches_jax(criterion):
    rng = np.random.RandomState(criterion + 5)
    a, b = _random_boxes(rng, 37), _random_boxes(rng, 23)
    sa, sb = _special_boxes()
    a, b = np.concatenate([a, sa]), np.concatenate([b, sb])
    want = jriou.rotate_iou(a, b, criterion)
    got = triou.rotate_iou(a, b, criterion, device="cpu")
    assert got.dtype == np.float32 and got.shape == want.shape == (43, 29)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want > 0).sum() > 20  # overlapping pairs are exercised
    d = np.diag(got[37:, 23:])
    if criterion == -1:
        np.testing.assert_allclose(d[[0, 1, 3, 4]], [1, 0, 0, 1], atol=1e-5)
        np.testing.assert_allclose(d[2], 1 / 16, atol=1e-5)


def test_rotate_iou_batches_and_empty_inputs(monkeypatch):
    rng = np.random.RandomState(1)
    a, b = _random_boxes(rng, 50), _random_boxes(rng, 40)
    whole = triou.rotate_iou(a, b, device="cpu")
    monkeypatch.setattr(triou, "_PAIRS_PER_BATCH", 7 * 40)
    np.testing.assert_array_equal(triou.rotate_iou(a, b, device="cpu"),
                                  whole)
    assert triou.rotate_iou(a[:0], b, device="cpu").shape == (0, 40)
    assert triou.rotate_iou(a, b[:0], device="cpu").shape == (50, 0)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
@pytest.mark.parametrize("camera", [True, False])
def test_d3_box_overlap_matches_jax(criterion, camera):
    rng = np.random.RandomState(3)
    n, k = 19, 17
    boxes = np.concatenate([rng.uniform(-3, 3, (n, 3)),
                            rng.uniform(1, 4, (n, 3)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    qboxes = np.concatenate([rng.uniform(-3, 3, (k, 3)),
                             rng.uniform(1, 4, (k, 3)),
                             rng.uniform(-np.pi, np.pi, (k, 1))], 1)
    qboxes[0] = boxes[0]
    cols = [0, 2, 3, 5, 6] if camera else [0, 1, 3, 4, 6]
    rinc = jriou.rotate_iou(boxes[:, cols], qboxes[:, cols], 2)
    want = jriou.d3_box_overlap(boxes, qboxes, rinc, criterion, camera)
    got = triou.d3_box_overlap(boxes, qboxes, rinc, criterion, camera,
                               device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (want > 0).any()


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_image_box_overlap_matches_jax(criterion):
    rng = np.random.RandomState(4)
    lt = rng.uniform(0, 100, (30, 2))
    a = np.concatenate([lt, lt + rng.uniform(5, 60, (30, 2))], 1)
    lt = rng.uniform(0, 100, (25, 2))
    b = np.concatenate([lt, lt + rng.uniform(5, 60, (25, 2))], 1)
    b[:3] = [a[0], a[1] + [10, 0, 10, 0], [500, 500, 510, 510]]
    want = jriou.image_box_overlap(a, b, criterion)
    got = triou.image_box_overlap(a, b, criterion, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert triou.image_box_overlap(a[:0], b, device="cpu").shape == (0, 25)
