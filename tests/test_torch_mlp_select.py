"""The selection MLP (kernel 3's packing and plain version) against
sdflabel_tpu.ops.mlp_pallas: emulate_select_mlp and the Pallas kernel in
interpret mode, on an 8x128 net and a small-batch 8x512 net."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import mlp_pallas
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import mlp_cuda
from torch_parity_util import jax_tree_to_numpy


def _assert_same_pack(tp, jp, ulps=1, f32_rtol=1e-6):
    # weight-norm folds on both sides with last-ulp differences that may
    # round a bf16 weight the other way: `ulps` bf16 ulps (2^-7 relative)
    for f in ("ws", "wx", "wlat", "bias", "wlast", "scal"):
        want = np.asarray(getattr(jp, f), np.float32)
        got = getattr(tp, f).float().numpy()
        tol = ulps * 2.0 ** -7 if f == "ws" else f32_rtol
        np.testing.assert_allclose(got, want, rtol=tol, atol=1e-7,
                                   err_msg=f)
    assert (tp.width, tp.n_hidden, tp.use_tanh) == (jp.width, jp.n_hidden,
                                                    jp.use_tanh)


def _net(width, **kw):
    spec = dict(latent_size=3, dims=(width,) * 8, norm_layers=tuple(range(8)),
                latent_in=(4,), weight_norm=True)
    spec.update(kw)
    jcfg = jds.DeepSDFConfig(**spec)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(width))
    return (jcfg, jparams, tds.DeepSDFConfig(**spec),
            tds.params_from_jax(jax_tree_to_numpy(jparams)))


@pytest.mark.parametrize("width,n", [(128, 700), (512, 300)])
def test_select_plain_matches_jax_emulation_and_kernel(width, n):
    jcfg, jparams, tcfg, tparams = _net(width)
    jp = mlp_pallas.pack_select_mlp(jcfg, jparams)
    _assert_same_pack(mlp_cuda.pack_select_mlp(tcfg, tparams), jp)
    # the arithmetic on one pack: the JAX package's, carried across
    tp = mlp_cuda.PackedSelectMLP(
        *(torch.as_tensor(np.asarray(getattr(jp, f), np.float32)).to(
            torch.bfloat16 if f == "ws" else torch.float32)
          for f in ("ws", "wx", "wlat", "bias", "wlast", "scal")),
        width=jp.width, n_hidden=jp.n_hidden, use_tanh=jp.use_tanh)
    assert (tp.width, tp.n_hidden, tp.use_tanh) == (jp.width, jp.n_hidden,
                                                    jp.use_tanh)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    lat = np.array([0.6, -0.48, 0.64], np.float32)
    want = np.asarray(mlp_pallas.emulate_select_mlp(jp, jnp.asarray(lat),
                                                    jnp.asarray(pts)))
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(mlp_pallas.select_mlp_apply(
            jp, jnp.asarray(lat), jnp.asarray(pts), block=256))
    got = mlp_cuda.select_mlp_apply(tp, torch.as_tensor(lat),
                                    torch.as_tensor(pts)).numpy()
    # same bf16 operands and fp32 accumulation, sums in another order: a
    # last-ulp difference may flip one activation's bf16 rounding (2^-8
    # relative), so max 1e-3 and median 1e-5
    for ref in (want, kern):
        err = np.abs(got - ref)
        assert err.max() < 1e-3 and np.median(err) < 1e-5, (err.max(),
                                                             np.median(err))
    # and a rank-only stand-in for the exact fp32 decoder
    exact = tds.sdf_fn(tcfg, tparams)(torch.as_tensor(lat),
                                      torch.as_tensor(pts)).detach().numpy()
    assert np.corrcoef(got, exact)[0, 1] > 0.99


def test_pack_refuses_what_the_jax_packer_refuses():
    for width, kw in ((64, {}), (96, {}),
                      (128, dict(weight_norm=False)),  # LayerNorm net
                      (128, dict(latent_in=(0,)))):
        jcfg, jparams, tcfg, tparams = _net(width, **kw)
        assert mlp_pallas.pack_select_mlp(jcfg, jparams) is None
        assert mlp_cuda.pack_select_mlp(tcfg, tparams) is None
        assert mlp_cuda.select_fn(tcfg, tparams) is None


def test_select_fn_packs_after_the_bf16_cast():
    # under precision = float16 the runtime casts the decoder to bf16
    # first and packs that (refine_css.py:114-118, :150)
    jcfg, jparams, tcfg, tparams = _net(128)
    jp = mlp_pallas.pack_select_mlp(jcfg, jds.cast_params(jparams))
    fn = mlp_cuda.select_fn(tcfg, tds.cast_params(tparams, torch.bfloat16))
    tp = mlp_cuda.pack_select_mlp(tcfg, tds.cast_params(tparams,
                                                        torch.bfloat16))
    # the fold itself runs in bf16 here (XLA and torch round its norm
    # differently): 2 bf16 ulps on every packed weight
    _assert_same_pack(tp, jp, ulps=2, f32_rtol=2.0 ** -6)
    fp32_pack = mlp_cuda.pack_select_mlp(tcfg, tparams)
    assert not torch.equal(tp.ws, fp32_pack.ws)
    pts = torch.rand(500, 3, generator=torch.Generator().manual_seed(0))
    pts = pts * 2 - 1
    lat = torch.tensor([0.0, 0.6, 0.8])
    out = fn(lat, pts)
    assert not out.requires_grad and out.shape == (500,)
    want = np.asarray(mlp_pallas.emulate_select_mlp(
        jp, jnp.asarray(lat.numpy()), jnp.asarray(pts.numpy())))
    # a ranking: the two orders agree
    assert np.corrcoef(np.argsort(np.argsort(out.numpy())),
                       np.argsort(np.argsort(want)))[0, 1] > 0.999
