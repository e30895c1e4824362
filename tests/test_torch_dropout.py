"""The train-mode hidden layer's bias, ReLU and dropout (ops/dropout_cuda.py)
on the CPU: the plain version the wrapper takes there equals the chain of
models/deepsdf.py bit for bit (forward, autograd backward, a data-parallel
rank's rows), the kernels' launch plan covers every row and column, and
the decoder's route reaches no kernel on the CPU. The kernels themselves
are held against the chain on the card (tests/test_torch_dropout_cuda.py).
"""

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import dropout_cuda


def _chain(z, b, keep, gen, rows=None):
    """models/deepsdf.py's chain: the bias added by _linear, relu, then
    _dropout."""
    return deepsdf._dropout(torch.relu(z + b), keep, gen, rows)


def _inputs(r, c, seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn(r, c, generator=g)
    b = torch.randn(c, generator=g) * 0.3
    up = torch.randn(r, c, generator=g)
    return z, b, up


@pytest.mark.parametrize("r, c", [(257, 512), (300, 506), (33, 7)])
def test_plain_equals_the_chain_forward_and_backward(r, c):
    z, b, up = _inputs(r, c)
    got, want = [], []
    for fn, out in ((lambda z_, b_: dropout_cuda.bias_relu_dropout(
            z_, b_, 0.8, torch.Generator().manual_seed(5)), got),
                    (lambda z_, b_: _chain(
                        z_, b_, 0.8, torch.Generator().manual_seed(5)), want)):
        zz, bb = z.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = fn(zz, bb)
        gz, gb = torch.autograd.grad(y, (zz, bb), up)
        out += [y, gz, gb]
    for a, w in zip(got, want):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
    y = got[0]
    assert 0.25 < float((y != 0).float().mean()) < 0.55
    assert torch.equal(got[1] != 0, y > 0)


def test_plain_equals_the_chain_on_a_ranks_rows():
    # rows (lo, n): the uniforms drawn for the whole n-row batch, z rows
    # lo.. of it; the two ranks' rows together equal the whole batch's
    z, b, _ = _inputs(600, 64, seed=1)
    whole = dropout_cuda.bias_relu_dropout(
        z, b, 0.8, torch.Generator().manual_seed(9))
    parts = []
    for lo, hi in ((0, 250), (250, 600)):
        got = dropout_cuda.bias_relu_dropout(
            z[lo:hi], b, 0.8, torch.Generator().manual_seed(9), (lo, 600))
        want = _chain(z[lo:hi], b, 0.8, torch.Generator().manual_seed(9),
                      (lo, 600))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        parts.append(got)
    assert torch.equal(torch.cat(parts), whole)


def test_plain_draws_the_masks_the_decoder_draws():
    # one draw a layer shaped as the layer's output: leading axes flatten
    # to the same uniforms
    z, b, _ = _inputs(96, 40, seed=2)
    flat = dropout_cuda.bias_relu_dropout(
        z, b, 0.8, torch.Generator().manual_seed(3))
    shaped = dropout_cuda.bias_relu_dropout(
        z.reshape(4, 24, 40), b, 0.8, torch.Generator().manual_seed(3))
    assert torch.equal(shaped.reshape(96, 40), flat)


def test_every_unit_kept_or_dropped():
    z, b, _ = _inputs(64, 32, seed=4)
    kept = dropout_cuda.bias_relu_dropout_plain(z, b, torch.zeros_like(z),
                                                1.0)
    assert torch.equal(kept, torch.relu(z + b))
    dropped = dropout_cuda.bias_relu_dropout_plain(z, b, torch.ones_like(z),
                                                   0.8)
    assert torch.equal(dropped, torch.zeros_like(z))


def test_inv_keep_is_the_float32_reciprocal():
    assert dropout_cuda.inv_keep(0.8) == 1.25
    assert dropout_cuda.inv_keep(1.0) == 1.0
    for keep in (0.3, 0.7, 0.95):
        assert dropout_cuda.inv_keep(keep) == float(
            np.float32(1) / np.float32(keep))


@pytest.mark.parametrize("rows", [1, 1000, 16384 + 37, 1 << 20])
@pytest.mark.parametrize("cols, align, vec", [
    (512, 16, 4), (506, 16, 2), (506, 8, 2), (512, 8, 2), (512, 4, 1),
    (7, 16, 1), (3000, 16, 4)])
def test_plan_covers_every_row_and_column(rows, cols, align, vec):
    p = dropout_cuda.plan(rows, cols, align)
    assert p["vec"] == vec and cols % p["vec"] == 0
    assert p["bx"] % 32 == 0 and p["bx"] * p["by"] <= dropout_cuda.THREADS
    # the column loop (bx lanes a pass) reaches every column group
    assert p["bx"] >= min(cols // vec, dropout_cuda.THREADS)
    assert p["ctas"] * p["tile"] >= rows > (p["ctas"] - 1) * p["tile"]
    assert p["ctas"] <= dropout_cuda.TARGET_CTAS
    assert dropout_cuda.sum_depth(p) < 4096


def test_plan_at_the_training_shape():
    # 64 scenes x 16384 rows: float4 lanes, two rows side by side, 1024
    # CTAs of 1024 rows; C = 506 (the layer before latent_in) on float2
    p = dropout_cuda.plan(1 << 20, 512)
    assert p == dict(vec=4, bx=128, by=2, tile=1024, ctas=1024)
    p = dropout_cuda.plan(1 << 20, 506)
    assert p == dict(vec=2, bx=256, by=1, tile=1024, ctas=1024)


def test_decoder_on_the_cpu_launches_no_kernel():
    # train mode on the CPU takes the plain version: the kernels' counters
    # stay put, and two draws from one seed are equal
    spec = dict(latent_size=3, dims=(32,) * 4, dropout=(0, 1, 2, 3),
                dropout_prob=0.2, norm_layers=(0, 1, 2, 3), latent_in=(2,),
                weight_norm=True)
    cfg = deepsdf.DeepSDFConfig(**spec)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(50, 6, generator=torch.Generator().manual_seed(1))
    kernels = (dropout_cuda.BRD_FWD, dropout_cuda.BRD_BWD,
               dropout_cuda.BRD_REDUCE)
    before = [k.launches for k in kernels]
    a = deepsdf.apply_sdf(cfg, params, x, torch.Generator().manual_seed(2))
    b = deepsdf.apply_sdf(cfg, params, x, torch.Generator().manual_seed(2))
    assert torch.equal(a, b)
    assert [k.launches for k in kernels] == before


def test_decoder_route_equals_the_chain_on_the_cpu():
    # the route through the plain version against the layer chain written
    # out (matrix product and bias, relu, dropout), forward and gradients
    cfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(24,) * 4,
                                dropout=(0, 1, 2, 3), dropout_prob=0.2,
                                norm_layers=(0, 1, 2, 3), latent_in=(2,),
                                weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(40, 6, generator=torch.Generator().manual_seed(1))

    def chain(prm):
        gen = torch.Generator().manual_seed(2)
        h = x
        for l in range(cfg.num_layers - 1):
            if l in cfg.latent_in:
                h = torch.cat([h, x], dim=-1)
            h = deepsdf._linear(prm[f"lin{l}"], h)
            if l < cfg.num_layers - 2:
                h = deepsdf._dropout(torch.relu(h), 0.8, gen)
        return torch.tanh(h)[..., 0]

    out = []
    for fn in (lambda prm: deepsdf.apply_sdf(
            cfg, prm, x, torch.Generator().manual_seed(2)), chain):
        prm = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()}
               for k, v in params.items() if k.startswith("lin")}
        y = fn(prm)
        leaves = [t for v in prm.values() for t in v.values()]
        out.append([y] + list(torch.autograd.grad(y.sum(), leaves)))
    for a, w in zip(*out):
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
