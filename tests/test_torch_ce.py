"""The port's plain cross-entropy (ops/ce_cuda.py), the plain version of
kernel 5, against the JAX package's fused Pallas kernel (interpret mode,
as tests/test_ce_pallas.py runs it) and its jnp path.

Tolerance: fp32 sums in other orders, so the loss agrees to 1e-5 relative
and every gradient element to 1e-5 relative plus 1e-6 of the largest (an
ulp of the log-sum-exp moves every softmax term by ~1e-6 relative).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import css_train as jtrain
from sdflabel_tpu.ops import ce_pallas
from sdflabel_tpu_torch.ops import ce_cuda


def _interpret_ctx():
    if jax.default_backend() == "tpu":
        return contextlib.nullcontext()
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("c", [2, 256])
def test_plain_ce_matches_jax_fused_and_jnp(c):
    rng = np.random.RandomState(c)
    b, h, w = 2, 16, 128
    logits = (rng.randn(b, c, h, w) * 3).astype(np.float32)
    targets = rng.randint(0, c, (b, h, w)).astype(np.int32)
    cot = 2.5  # upstream cotangent != 1

    def jloss(fn):
        return jax.value_and_grad(
            lambda x: cot * fn(x, jnp.asarray(targets)))(jnp.asarray(logits))

    with _interpret_ctx():
        jl_fused, jg_fused = jloss(ce_pallas.fused_cross_entropy)
    jl_jnp, jg_jnp = jloss(jtrain.cross_entropy_with_internal_softmax)

    x = torch.tensor(logits, requires_grad=True)
    # the CPU wrapper takes the plain version
    loss = ce_cuda.fused_cross_entropy(x, torch.as_tensor(targets)) * cot
    (g,) = torch.autograd.grad(loss, x)
    plain = ce_cuda.cross_entropy_with_internal_softmax(
        torch.as_tensor(logits), torch.as_tensor(targets).long())
    assert plain.item() * cot == pytest.approx(loss.item(), rel=1e-7)

    for jl, jg in ((jl_fused, jg_fused), (jl_jnp, jg_jnp)):
        assert loss.item() == pytest.approx(float(jl), rel=1e-5)
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5,
                                   atol=1e-6 * np.abs(jg).max())


def test_fused_ce_refuses_other_shapes_and_types():
    x = torch.zeros(2, 4, 8, 8)
    with pytest.raises(ValueError):
        ce_cuda.fused_cross_entropy(x, torch.zeros(2, 8, 9, dtype=torch.long))
    with pytest.raises(ValueError):
        ce_cuda.fused_cross_entropy(x.double(),
                                    torch.zeros(2, 8, 8, dtype=torch.long))
