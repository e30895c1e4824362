"""The port's flax msgpack reader and CSSNet against flax and
sdflabel_tpu.models.css, on the bundled css_demo.msgpack."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sdflabel_tpu.models import css as jcss
from sdflabel_tpu.pipelines.train_css import setup_css
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.utils import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "data", "optimization", "css_demo.msgpack")


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def test_msgpack_reader_matches_flax():
    raw = open(DEMO, "rb").read()
    _same_tree(serialization.msgpack_restore(raw),
               flax_msgpack.msgpack_restore(raw))
    # every value type the reader handles, through flax's own writer
    tree = {"i": 7, "neg": -3, "big": 2 ** 40, "f": 0.25, "s": "x" * 40,
            "t": True, "none": None, "b": b"\x00\x01" * 200,
            "nest": {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
                     "h": np.ones((3,), np.float16),
                     "d": np.linspace(0, 1, 70000)},
            "scalar": np.float32(1.5)}
    _same_tree(serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)),
        flax_msgpack.msgpack_restore(serialization.msgpack_serialize(tree)))


def test_css_forward_matches_flax():
    variables = setup_css(DEMO, width=8, latent_size=3)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 128, 128).astype(np.float32)
    jout = jcss.CSSNet(use_running_average=True, width=8,
                       latent_size=3).apply(variables, jnp.asarray(x))
    model = tcss.load_css(DEMO, width=8, device="cpu")
    with torch.no_grad():
        tout = model(torch.as_tensor(x))
    # fp32 convolutions summed in other orders: log-probabilities to 1e-4;
    # the expected colour (0..255, softmax hardness 100) to 1e-2
    for k, tol in (("u", 1e-4), ("v", 1e-4), ("w", 1e-4), ("mask", 1e-4),
                   ("latent", 1e-6), ("mask_sm", 1e-3), ("uvw_sm", 1e-2),
                   ("uvw_sm_masked", 1e-2)):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   atol=tol, err_msg=k)
    # black stays black: pixels the JAX network decodes to exactly 0
    # (flushed subnormals) are exactly 0 here too
    jz = np.asarray(jout["uvw_sm_masked"]) == 0
    assert np.array_equal(tout["uvw_sm_masked"].numpy() == 0, jz)


def test_css_helpers_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 6, 7).astype(np.float32)  # NCHW
    want = np.asarray(jcss.upsample2x_align_corners(
        jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    got = tcss.upsample2x_align_corners(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    v = rng.randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(
        tcss.project_vecs_onto_sphere(torch.as_tensor(v)).numpy(),
        np.asarray(jcss.project_vecs_onto_sphere(jnp.asarray(v))), atol=1e-7)


def test_state_from_flax_covers_every_parameter():
    variables = serialization.msgpack_restore(open(DEMO, "rb").read())
    model = tcss.params_from_jax(variables, width=8)
    state = tcss.state_from_flax(variables)
    assert set(state) == set(model.state_dict())
    with pytest.raises(ValueError):
        tcss.load_css("data/nets/css.pt", width=64, device="cpu")
