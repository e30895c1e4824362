"""bf16 CSS training and the fused-head net on the card, against the same
steps on the CPU (no JAX: the CPU tests hold the CPU side against JAX).

- A bf16 step (cuDNN bf16 convolutions, the CE kernels) lies within twice
  the CPU's own bf16-vs-fp32 gap of the CPU's bf16 step (oneDNN, the
  plain CE): the rule of tests/test_torch_css_bf16.py with the port's CPU
  gap where JAX's stands there. So that a card run in fp32 fails, the
  card's bf16 forward lies nearer (RMS) the CPU's bf16 forward than its
  fp32 one and parts from the card's own fp32 forward by at least half
  the CPU's gap, and the step's BatchNorm statistics part from the card's
  fp32 step's by at least half the CPU's gap.
- Both augmentation chains of data/crops.py (``fast`` True and False)
  give on the card what they give on the CPU, to the tolerance each
  chain's CPU test holds it to against the JAX package.
- The fused-head net's outputs on the card lie within 2e-4 of each
  output's scale of the unfused net's, and its step with the CE kernels
  within 1e-4 relative of the CPU's loss.

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_train_cuda.py --noconftest \\
      -o addopts="" -p no:cacheprovider
"""

import json
import os

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.data import crops as crops_data
from sdflabel_tpu_torch.engine import css_train
from sdflabel_tpu_torch.models import css as css_mod
from sdflabel_tpu_torch.models import css_fused
from sdflabel_tpu_torch.utils import png

pytestmark = pytest.mark.cuda
LR = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(seed, b=2, px=64):
    rng = np.random.RandomState(seed)
    mask = (rng.uniform(size=(b, px, px)) > 0.4).astype(np.uint8)
    uvw = (rng.randint(1, 256, (b, 3, px, px)) * mask[:, None]).astype(
        np.uint8)
    lat = rng.randn(b, 3).astype(np.float32)
    return {"rgb": rng.randint(0, 256, (b, 3, px, px)).astype(np.uint8),
            "uvw": uvw, "mask": mask,
            "latent": lat / np.linalg.norm(lat, axis=1, keepdims=True)}


def _step(model, batch, dev, dtype, fused_ce):
    model = model.to(dev)
    if isinstance(model, css_mod.CSSNet):
        model.compute_dtype = dtype
    state = css_train.init_train_state(model, LR)
    m = css_train.make_train_step(fused_ce=fused_ce, direct_ce=True)(
        state, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    params = torch.cat([p.detach().cpu().reshape(-1)
                        for p in state.model.parameters()])
    stats = [b.cpu() for b in state.model.buffers()]
    return float(m["loss"]), params, stats


def _gaps(a, b):
    (la, pa, sa), (lb, pb, sb) = a, b
    rel = max(float((x - y).abs().max() / y.abs().max())
              for x, y in zip(sa, sb))
    return np.array([abs(la - lb), float((pa - pb).norm()), rel])


def _net(width, seed=0):
    return css_mod.init_params(css_mod.CSSNet(width=width),
                               torch.Generator().manual_seed(seed))


def _forward(width, x, dev, dtype):
    model = _net(width).to(dev).train()
    model.compute_dtype = dtype
    with torch.no_grad():
        out = model(torch.as_tensor(x, device=dev))
    return {k: v.float().cpu() for k, v in out.items()}


def _rms(a, b):
    return float((a - b).pow(2).mean().sqrt())


@pytest.mark.parametrize("width", [8, 64])
def test_bf16_step_on_card_within_twice_cpu_gap(dev, width):
    cpu = torch.device("cpu")
    x = np.random.RandomState(0).randn(4, 3, 64, 64).astype(np.float32)
    out = {(d.type, dt): _forward(width, x, d, dt) for d in (cpu, dev)
           for dt in (torch.float32, torch.bfloat16)}
    card = out["cuda", torch.bfloat16]
    for k in ("u_raw", "v_raw", "w_raw", "mask", "latent"):
        ref = _rms(out["cpu", torch.bfloat16][k], out["cpu", torch.float32][k])
        assert _rms(card[k], out["cpu", torch.bfloat16][k]) \
            < _rms(card[k], out["cpu", torch.float32][k]), k
        assert _rms(card[k], out["cuda", torch.float32][k]) >= 0.5 * ref, k
    gap, ref, own = np.zeros(3), np.zeros(3), np.zeros(3)
    for seed in (10, 11):
        b = _batch(seed)
        f32 = _step(_net(width), b, cpu, torch.float32, False)
        bf = _step(_net(width), b, cpu, torch.bfloat16, False)
        card = _step(_net(width), b, dev, torch.bfloat16, True)
        card_f32 = _step(_net(width), b, dev, torch.float32, True)
        ref = np.maximum(ref, _gaps(bf, f32))
        gap = np.maximum(gap, _gaps(card, bf))
        own = np.maximum(own, _gaps(card, card_f32))
    assert (gap <= 2 * ref).all(), (gap, ref)
    assert own[2] >= 0.5 * ref[2], (own, ref)


@pytest.fixture(scope="module")
def crops_dir(tmp_path_factory):
    """Six crops with a disc of UVW labels, at 128 px and at 96 px."""
    root = tmp_path_factory.mktemp("card_crops")
    rng = np.random.RandomState(3)
    gt = {}
    for i in range(6):
        px = 128 if i % 2 == 0 else 96
        yy, xx = np.mgrid[0:px, 0:px].astype(np.float32) / px
        rgb = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * xx + i), yy,
                        0.5 + 0.5 * np.cos(3 * np.pi * yy)], -1)
        disc = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.12
        uvw = np.stack([xx * 200 + 30, yy * 200 + 30,
                        np.full_like(xx, 128.0)], -1) * disc[..., None]
        png.write(os.path.join(root, f"{i:05d}_rgb.png"),
                  (rgb * 255).astype(np.uint8))
        png.write(os.path.join(root, f"{i:05d}_uvw.png"), uvw.astype(np.uint8))
        lat = rng.randn(3)
        gt[str(i)] = [{"latent": (lat / np.linalg.norm(lat)).tolist(),
                       "extrinsics": np.eye(4).ravel().tolist(),
                       "intrinsics": np.eye(3).ravel().tolist()}]
    with open(os.path.join(root, "crops.json"), "w") as f:
        json.dump(gt, f)
    return str(root)


@pytest.mark.parametrize("fast", [True, False])
def test_input_chain_on_card_equals_cpu(dev, crops_dir, fast):
    # the fast chain's tolerance (tests/test_torch_crops.py): RGB within 2
    # LSB, >= 99.9% equal; the PIL chain's (tests/test_torch_crops_pil.py):
    # within 1 LSB, >= 99.5% equal; UVW and mask >= 99.5% equal in both
    lsb, share = (2, 0.999) if fast else (1, 0.995)
    ds = crops_data.Crops(crops_dir, seed=7, fast=fast, stage="uint8")
    for epoch in range(3):
        ds.set_epoch(epoch)
        host = crops_data.collate([ds[i] for i in range(len(ds))])
        card, cpu = ds.to_device(host, dev), ds.to_device(host, "cpu")
        for k in ("rgb", "uvw", "mask"):
            a, b = card[k].cpu(), cpu[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            equal = float((a == b).float().mean())
            assert equal >= (share if k == "rgb" else 0.995), (k, equal)
        diff = (card["rgb"].cpu().int() - cpu["rgb"].int()).abs().max()
        assert int(diff) <= lsb


def test_fused_net_on_card(dev):
    model = _net(64, seed=3)
    x = torch.as_tensor(_batch(4)["rgb"], device=dev).float() / 255.0
    fused = css_fused.fused_from_css(model.to(dev))
    with torch.no_grad():
        a, b = model(x), fused(x)
    for k in a:
        scale = max(float(a[k].abs().max()), 1.0)
        assert float((b[k] - a[k]).abs().max()) <= 2e-4 * scale, k
    batch = _batch(5)
    card = _step(css_fused.fused_from_css(_net(64, seed=3)), batch, dev,
                 None, True)
    cpu = _step(css_fused.fused_from_css(_net(64, seed=3)), batch,
                torch.device("cpu"), None, False)
    assert card[0] == pytest.approx(cpu[0], rel=1e-4)
