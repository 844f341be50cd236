"""The port's SR-attention (`semisupervisedobjectdetection_torch/ops/
sr_attention.py`) against the JAX package's: the Pallas kernel run in
interpret mode and the XLA einsum attention, on the same numpy inputs.

On the CPU the wrapper computes the plain version; the CUDA kernel itself is
held against that plain version by the `cuda`-marked tests of
tests/test_torch_cuda.py and by chip_smoke.py on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from semisupervisedobjectdetection_tpu.models.segformer import xla_attention
from semisupervisedobjectdetection_tpu.ops.sr_attention import (
    sr_attention as jax_sr_attention,
)
from semisupervisedobjectdetection_torch.ops.sr_attention import (
    sr_attention,
    sr_attention_reference,
)
from test_torch_segformer import one_torch_thread  # noqa: F401 (autouse)

# the shapes of tests/test_sr_attention.py: square attention, a stage-1-like
# query stream with a 10-token prompt prefix (nk=266), multi-head with an
# unaligned nk
SHAPES = [(2, 256, 256, 64, 1), (1, 1024, 266, 64, 1), (2, 128, 96, 128, 2)]


def _inputs(b, nq, nk, c, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, n, c)).astype(np.float32)
            for n in (nq, nk, nk)]


@pytest.mark.parametrize("b,nq,nk,c,h", SHAPES)
def test_plain_matches_jax_pallas_and_xla_f32(b, nq, nk, c, h):
    q, k, v = _inputs(b, nq, nk, c)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_sr_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), h))
    xla = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), h, 0.0, True, None))
    got = sr_attention(*(torch.from_numpy(a) for a in (q, k, v)), h).numpy()
    # float32: the same products summed in another order
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, xla, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("b,nq,nk,c,h", [SHAPES[1], SHAPES[2]])
def test_plain_matches_jax_pallas_bf16(b, nq, nk, c, h):
    """bfloat16 in: both round p to bf16 after a float32 softmax and cast
    the float32 sum to bf16, so they differ by one or two bf16 ulps (2**-7
    relative) where a sum lands on the other side of a rounding step."""
    q, k, v = (a.astype(jnp.bfloat16) for a in _inputs(b, nq, nk, c, 1))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_sr_attention(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), h), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32))
                  .to(torch.bfloat16) for a in (q, k, v))
    got = sr_attention(tq, tk, tv, h)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), pallas, rtol=2e-2,
                               atol=1e-2)


@pytest.mark.parametrize("b,nq,nk,c,h", [
    (1, 48, 300, 64, 1),      # Nk 300: a 44-token prefix at stage 1
    (1, 40, 356, 64, 2),      # Nk 356: 100 prompt tokens at 512x512
    (1, 24, 1024, 32, 1),     # Nk 1024: stage 1 at 1024x1024, head width 32
])
def test_plain_matches_jax_pallas_past_the_bf16_limit(b, nq, nk, c, h):
    """At the Nk the float32 kernels take past the bfloat16 limit (288),
    the plain forward and backward the kernels are held to on the card
    agree with the JAX package's Pallas kernels (interpret mode), which
    have no Nk limit."""
    from semisupervisedobjectdetection_tpu.ops.sr_attention import (
        _backward as jax_backward,
    )
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention_backward_reference,
    )

    q, k, v = _inputs(b, nq, nk, c, 2)
    g = np.random.default_rng(3).normal(size=(b, nq, c)).astype(np.float32)
    ja = [jnp.asarray(a) for a in (q, k, v, g)]
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jax_sr_attention(*ja[:3], h))
        pallas_bwd = jax_backward(*ja, h)
    ta = [torch.from_numpy(a) for a in (q, k, v, g)]
    got = sr_attention(*ta[:3], h).numpy()
    np.testing.assert_allclose(got, pallas, atol=2e-5, rtol=1e-4)
    for name, a, p in zip(("dq", "dk", "dv"),
                          sr_attention_backward_reference(*ta, h),
                          pallas_bwd):
        np.testing.assert_allclose(a.numpy(), np.asarray(p), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_cpu_call_is_plain_and_not_counted():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 9, 32))
    before = sr_attention.launches
    out = sr_attention(q, k, v, 2)
    assert sr_attention.launches == before
    torch.testing.assert_close(out, sr_attention_reference(q, k, v, 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shapes,heads", [
    (((1, 8, 16), (1, 4, 16), (1, 5, 16)), 2),   # k/v disagree
    (((1, 8, 16), (1, 4, 8), (1, 4, 8)), 2),     # C disagrees
    (((1, 8, 15), (1, 4, 15), (1, 4, 15)), 2),   # C not divisible
    (((1, 8, 16), (1, 0, 16), (1, 0, 16)), 2),   # no keys
])
def test_rejects_bad_shapes(shapes, heads):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        sr_attention(q, k, v, heads)
