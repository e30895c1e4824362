"""The wgmma design's packed weight slices (ops/mlp_cuda.py tile_stack)
against the shared-memory layout that the kernel's B descriptor reads,
written out from the address formula, and the per-design launch counts.
CPU only."""

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import _cuda, mlp2_cuda, mlp_cuda

WIDTHS = (128, 256, 384, 512)


def _image_to_matrix(tiles: np.ndarray, n_rows: int) -> np.ndarray:
    """(L, S, N * 32) slice images -> (L, N, S * 32), element by element
    from the byte address: row n at n * 64 bytes; value k of the row in
    16-byte chunk (k // 8) ^ ((n >> 1) & 3), at (k % 8) * 2 bytes in it
    (the 64-byte swizzle: address bits 4-5 XOR bits 7-8)."""
    L, S, _ = tiles.shape
    n = np.arange(n_rows)[:, None]
    k = np.arange(S * 32)[None, :]
    s, kk = k // 32, k % 32
    addr = n * 64 + (((kk // 8) ^ ((n >> 1) & 3)) * 16) + (kk % 8) * 2
    assert ((addr >> 4) & 3 == ((kk // 8) ^ ((addr >> 7) & 3))).all()
    return tiles[:, s, addr // 2]


def _decoder(width, layers=8, seed=0):
    cfg = deepsdf.DeepSDFConfig(
        latent_size=3, dims=(width,) * layers,
        norm_layers=tuple(range(layers)), latent_in=(layers // 2,),
        weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(seed))
    return cfg, deepsdf.cast_params(params, torch.bfloat16)


@pytest.mark.parametrize("width", WIDTHS)
def test_tiles_untile_to_the_stack(width):
    packed = mlp_cuda.pack_select_mlp(*_decoder(width))
    nh, H = packed.n_hidden, packed.width
    assert packed.ws_tiles.shape == packed.ws_tiles_t.shape == (
        nh, H // 32, 32 * H)
    ws = packed.ws.view(torch.int16).numpy()
    fwd = _image_to_matrix(packed.ws_tiles.view(torch.int16).numpy(), H)
    rev = _image_to_matrix(packed.ws_tiles_t.view(torch.int16).numpy(), H)
    # forward: B = ws_j, stored K-major as ws_j^T; reverse: B = ws_j^T,
    # stored as ws_j
    np.testing.assert_array_equal(fwd, ws.transpose(0, 2, 1))
    np.testing.assert_array_equal(rev, ws)


def test_wide_layers_pack_no_tiles():
    # beyond H = 512 the wmma design runs: no slices are packed
    packed = mlp_cuda.pack_select_mlp(*_decoder(1024, layers=3))
    assert packed.width == 1024 and packed.n_hidden == 2
    assert packed.ws_tiles is None and packed.ws_tiles_t is None


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    cfg, params = _decoder(128)
    packed = mlp_cuda.pack_select_mlp(cfg, params)
    pts = torch.as_tensor(np.random.RandomState(0).uniform(
        -1, 1, (50, 3)).astype(np.float32))
    lat = torch.tensor([0.3, -0.5, 0.8])
    mlp_cuda.SELECT_MLP.launches = 0
    mlp2_cuda.STAGE2_FWD.launches = 0
    out = mlp_cuda.select_mlp_apply(packed, lat, pts)
    sdf, _ = mlp2_cuda.stage2_apply(packed, lat, pts)
    torch.testing.assert_close(out, mlp_cuda.emulate_select_mlp(
        packed, lat, pts))
    torch.testing.assert_close(sdf.detach(), out, atol=2e-3, rtol=0)
    assert mlp_cuda.SELECT_MLP.launches == 0
    assert mlp2_cuda.STAGE2_FWD.launches == 0


def test_kernel_group_counts_each_design():
    a = _cuda.CudaKernel("lib", "a", [])
    b = _cuda.CudaKernel("lib", "b", [])
    group = _cuda.KernelGroup(wgmma=a, wmma=b)
    a.launches, b.launches = 3, 2
    assert group.launches == 5
    group.launches = 0
    assert a.launches == b.launches == group.launches == 0
