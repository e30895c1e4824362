"""The yardstick's work counts against hand counts at tiny shapes."""

from __future__ import annotations

import itertools
import math

import torch

from portbench import counts
from portbench.reference import refine_ref


def test_decoder_macs_by_hand():
    # widths (4, 8, 8, 1), latent 1, latent_in (1,): layer 0 is 4 -> 4
    # (its output is concatenated with the 4 inputs), 1 is 8 -> 8, 2 is
    # 8 -> 1
    assert counts.decoder_layer_io(1, [8, 8], [1]) == [(4, 4), (8, 8),
                                                       (8, 1)]
    assert counts.decoder_macs(1, [8, 8], [1]) == 16 + 64 + 8
    # absorbed: the latent column leaves layers 0 and 1
    assert counts.decoder_macs(1, [8, 8], [1], absorb_latent=True) == \
        12 + 56 + 8


def test_decoder_macs_8x512():
    # 6x512 + 2 x 512x512 + 512x506 + 4 x 512x512 + 512x1
    full = 6 * 512 + 2 * 512 * 512 + 512 * 506 + 4 * 512 * 512 + 512
    assert counts.decoder_macs(3, [512] * 8, [4]) == full == 1835520
    assert counts.decoder_macs(3, [512] * 8, [4], absorb_latent=True) == \
        full - 3 * 512 - 3 * 512


def test_select_work_by_hand():
    flops, nbytes = counts.select_mlp_work(10, 1, [8, 8], [1])
    assert flops == 2 * 10 * 76
    weights = (4 * 4 + 4) + (8 * 8 + 8) + (8 * 1 + 1)
    assert nbytes == 10 * 16 + 2 * weights


def test_least_time_takes_the_larger_bound():
    assert counts.least_time_s(flops=989e12, nbytes=1.0) == 1.0
    assert counts.least_time_s(nbytes=3.35e12) == 1.0
    assert math.isclose(counts.least_time_s(sfu=counts.SFU_OPS_PER_S * 2),
                        2.0)
    assert math.isclose(counts.SFU_OPS_PER_S, 4.18176e12)


def test_splat_work_by_hand():
    sfu, nbytes = counts.splat_fwd_work(5, 2, 3)
    assert sfu == 10
    assert nbytes == 4 * (2 * 14 + 3 * 11)


def test_footprint_pairs_by_hand():
    """The reference's footprint pair count against a loop over every
    point-pixel pair of a tiny render."""
    K = torch.tensor([[20.0, 0, 2], [0, 20.0, 2], [0, 0, 1]])
    pts = torch.tensor([[0.0, 0.0, 1.0], [0.02, 0.01, 1.2],
                        [0.5, 0.5, 1.0]])
    nrm = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.6, -0.8],
                        [0.0, 0.0, -1.0]])
    mask = torch.tensor([True, True, False])
    rays = refine_ref.pixel_rays(K, 4, 4)
    _, pairs = refine_ref.surfel_prob(rays, pts, nrm, mask, diam=0.04)
    want = 0
    for i, p in itertools.product(range(3), range(16)):
        if not mask[i]:
            continue
        r = rays[p]
        den = float(nrm[i] @ r)
        if abs(den) < 0.01:
            den = torch.finfo(torch.float32).eps
        z = float(nrm[i] @ pts[i]) / den
        if float(torch.linalg.norm(pts[i] - r * z)) < 0.04:
            want += 1
    assert pairs == want > 0
