"""The train-mode hidden layer's bias, ReLU and dropout kernels
(csrc/bias_relu_dropout.cu through ops/dropout_cuda.py) against PyTorch's
chain on the card.

y and the gradient of z must equal the chain's bit for bit (the same masks
from the same generator, the same fp32 arithmetic); the bias's gradient
adds the same terms as PyTorch's column sum in another order, so it is
held to the fp32 round-off bound of its order: |gb - sum| <= depth *
2^-24 * sum |gz|, depth the longest chain of additions
(dropout_cuda.sum_depth), against the sum in float64.

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_dropout_cuda.py --noconftest \
      -o addopts="" -p no:cacheprovider
"""

import types

import pytest
import torch

from sdflabel_tpu_torch.engine import deepsdf_train, refine
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import dropout_cuda, grid
from sdflabel_tpu_torch.renderer.rasterer import calibration_matrix
from sdflabel_tpu_torch.tools import quality_suite

pytestmark = pytest.mark.cuda

KERNELS = (dropout_cuda.BRD_FWD, dropout_cuda.BRD_BWD,
           dropout_cuda.BRD_REDUCE)
# DeepSDF's published decoder as the training cell runs it
STOCK = dict(latent_size=3, dims=(512,) * 8, dropout=tuple(range(8)),
             dropout_prob=0.2, norm_layers=tuple(range(8)), latent_in=(4,),
             weight_norm=True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _inputs(dev, r, c, seed=0, g_cols=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn(r, c, generator=gen, device=dev)
    b = torch.randn(c, generator=gen, device=dev) * 0.3
    # the upstream gradient; with g_cols a column slice of a wider one, as
    # the latent_in concatenation's backward hands it on
    g = torch.randn(r, g_cols or c, generator=gen, device=dev)[:, :c]
    return z, b, g


def _run(fn, z, b, g):
    zz, bb = z.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y = fn(zz, bb)
    gz, gb = torch.autograd.grad(y, (zz, bb), g)
    return y.detach(), gz, gb


def _fused(keep, seed, rows=None):
    return lambda z, b: dropout_cuda.bias_relu_dropout(
        z, b, keep, torch.Generator(device=z.device).manual_seed(seed), rows)


def _chain(keep, seed, rows=None):
    return lambda z, b: deepsdf._dropout(
        torch.relu(z + b), keep,
        torch.Generator(device=z.device).manual_seed(seed), rows)


def _assert_bias_grad(gb, gz, rows, cols):
    depth = max(dropout_cuda.sum_depth(dropout_cuda.plan(rows, cols, a))
                for a in (16, 8, 4))
    exact = gz.double().sum(0)
    bound = depth * 2.0 ** -24 * gz.double().abs().sum(0)
    assert torch.all((gb.double() - exact).abs() <= bound)


def _assert_fused_equals_chain(z, b, g, keep=0.8, rows=None):
    before = [k.launches for k in KERNELS]
    y, gz, gb = _run(_fused(keep, 5, rows), z, b, g)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(KERNELS, before)] == [1, 1, 1]
    y_c, gz_c, _ = _run(_chain(keep, 5, rows), z, b, g)
    assert torch.equal(_bits(y), _bits(y_c))
    assert torch.equal(_bits(gz), _bits(gz_c))
    _assert_bias_grad(gb, gz, *z.shape)
    return y, gz, gb


@pytest.mark.parametrize("c, g_cols", [(512, None), (506, None), (506, 512),
                                       (7, None)])
@pytest.mark.parametrize("r", [1000, 16384 + 37])
def test_fused_equals_the_chain(dev, r, c, g_cols):
    z, b, g = _inputs(dev, r, c, g_cols=g_cols)
    y, _, _ = _assert_fused_equals_chain(z, b, g)
    share = float((y != 0).float().mean())
    assert 0.3 < share < 0.5  # 0.8 kept of about half above zero


@pytest.mark.parametrize("c", [512, 506])
def test_fused_equals_the_chain_on_a_ranks_rows(dev, c):
    # rows lo.. of a batch of 3 r rows whose uniforms are drawn whole
    r = 16384 + 37
    z, b, g = _inputs(dev, r, c, seed=1)
    _assert_fused_equals_chain(z, b, g, rows=(r, 3 * r))


def test_every_unit_kept_or_dropped(dev):
    z, b, g = _inputs(dev, 4099, 512, seed=2)
    # dropout 0: every unit kept, y = relu(z + b)
    y, _, _ = _assert_fused_equals_chain(z, b, g, keep=1.0)
    assert torch.equal(y, torch.relu(z + b))
    # uniforms of 1 drop every unit: y and both gradients are 0
    u = torch.ones_like(z)
    zz, bb = z.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y = dropout_cuda._BiasReluDropout.apply(zz, bb, u, 0.8)
    gz, gb = torch.autograd.grad(y, (zz, bb), g)
    zp, bp = z.clone().requires_grad_(True), b.clone().requires_grad_(True)
    y_p = dropout_cuda.bias_relu_dropout_plain(zp, bp, u, 0.8)
    gz_p, gb_p = torch.autograd.grad(y_p, (zp, bp), g)
    for a, w in ((y, y_p), (gz, gz_p), (gb, gb_p)):
        assert torch.equal(_bits(a), _bits(w)) and not bool(a.any())


def test_two_runs_are_bit_equal(dev):
    z, b, g = _inputs(dev, 16384 + 37, 506, seed=3, g_cols=512)
    first = _run(_fused(0.8, 7), z, b, g)
    second = _run(_fused(0.8, 7), z, b, g)
    for a, w in zip(first, second):
        assert torch.equal(_bits(a), _bits(w))


def _stock_step(dev):
    cfg = deepsdf.DeepSDFConfig(**STOCK)
    tcfg = deepsdf_train.DeepSDFTrainConfig(samples_per_scene=256,
                                            scenes_per_batch=4,
                                            code_bound=1.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pos = torch.rand(8, 512, 4, generator=gen, device=dev) - 0.5
    neg = torch.rand(8, 512, 4, generator=gen, device=dev) - 0.5
    count = torch.full((8,), 512, device=dev)
    tensors = deepsdf_train.TrainTensors(types.SimpleNamespace(
        pos=pos, neg=neg, pos_count=count, neg_count=count,
        scales=torch.full((8,), float("nan"), device=dev)), dev)
    state = deepsdf_train.init_train_state(
        cfg, tcfg, 8, torch.Generator().manual_seed(1), device=dev)
    idx = torch.arange(4, device=dev)
    return deepsdf_train.train_step(cfg, tcfg, 2, state, tensors, idx, gen)


def test_a_stock_train_step_launches_each_kernel_once_a_layer(dev):
    for k in KERNELS:
        k.launches = 0
    state, metrics = _stock_step(dev)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert [k.launches for k in KERNELS] == [8, 8, 8]


def test_the_suite_fit_and_a_refine_iteration_launch_none(dev):
    # eval-mode decoders (a refine) and decoders without dropout (the
    # quality suite's fit, the demo's) take the chain
    for k in KERNELS:
        k.launches = 0
    fit = quality_suite.init_fit(dev)
    draw = quality_suite.fit_draw(torch.Generator(device=dev).manual_seed(0),
                                  dev)
    quality_suite.fit_step(fit, *draw)
    cfg = deepsdf.DeepSDFConfig(**STOCK)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    hw = (24, 24)
    K = torch.as_tensor(calibration_matrix((hw[1], hw[0])), device=dev)
    run = refine.make_refine_fn(
        deepsdf.sdf_fn(cfg, params),
        refine.RefineConfig(iters=1, surface_capacity=1024),
        grid.generate_point_grid(24, device=dev), K, hw, device=dev)
    frustum = torch.rand(256, 3, generator=torch.Generator().manual_seed(1))
    frustum[:, 2] += 4.0
    run(refine.init_refine_params(0.3, [0.0, 0.0, 4.0], 1.0, [1.0, 0, 0]),
        torch.zeros(3, *hw), frustum, torch.ones(256, dtype=torch.bool))
    torch.cuda.synchronize()
    assert [k.launches for k in KERNELS] == [0, 0, 0]
