"""The port's SR-attention backward (`sr_attention_bwd`, `SRAttention` in
`semisupervisedobjectdetection_torch/ops/sr_attention.py`) against the JAX
package's: the Pallas backward `_backward` run in interpret mode and the
XLA-einsum VJP `_xla_vjp_bwd`, on the same numpy inputs.

On the CPU the wrapper computes the plain version; the CUDA kernel itself is
held against that plain version by the `cuda`-marked tests of
tests/test_torch_cuda.py and by chip_smoke.py on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from semisupervisedobjectdetection_tpu.ops.sr_attention import (
    _backward as jax_backward,
    _xla_vjp_bwd,
)
from semisupervisedobjectdetection_torch.ops.sr_attention import (
    BWD_MMA_KEYS_PER_BLOCK,
    BWD_MMA_ROW_TILE,
    BWD_MMA_TARGET_BLOCKS,
    BWD_ROW_TILE,
    BWD_TARGET_BLOCKS,
    SRAttention,
    bwd_key_splits,
    sr_attention,
    sr_attention_backward_reference,
    sr_attention_bwd,
    sr_attention_reference,
)
from test_torch_segformer import one_torch_thread  # noqa: F401 (autouse)

# tests/test_sr_attention.py's backward shape: nq=520 over several query
# blocks with a ragged tail, nk=200 (padded to 256 by the Pallas kernel),
# four heads of width 16
B, NQ, NK, C, H = 2, 520, 200, 64, 4


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    q, g = (rng.normal(size=(B, NQ, C)).astype(np.float32) for _ in "qg")
    k, v = (rng.normal(size=(B, NK, C)).astype(np.float32) for _ in "kv")
    return q, k, v, g


def _jax_and_torch(arrays, dtype):
    ja = [jnp.asarray(a).astype(dtype) for a in arrays]
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32)))
          .to(getattr(torch, dtype)) for a in ja]
    return ja, ta


def test_backward_matches_jax_pallas_and_xla_f32():
    """float32: the same products summed in another order; the gradients
    (magnitude ~1) agree to ~1e-6."""
    ja, ta = _jax_and_torch(_inputs(), "float32")
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_backward(*ja, H)
    xla = _xla_vjp_bwd(*ja, H)
    got = sr_attention_bwd(*ta, H)
    for name, a, p, x in zip(("dq", "dk", "dv"), got, pallas, xla):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(p), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(x), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_backward_matches_jax_pallas_bf16():
    """bfloat16 in: both round ds to bf16 before dq and dk and cast the
    float32 sums to bf16, so they differ by one or two bf16 ulps (2**-7
    relative) where a sum lands on the other side of a rounding step. (The
    XLA VJP of the bf16 forward rounds p itself and is not this function.)"""
    ja, ta = _jax_and_torch(_inputs(6), "bfloat16")
    with pltpu.force_tpu_interpret_mode():
        pallas = jax_backward(*ja, H)
    got = sr_attention_bwd(*ta, H)
    for name, a, p in zip(("dq", "dk", "dv"), got, pallas):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(p, np.float32), atol=1e-2,
                                   rtol=2e-2, err_msg=name)


@pytest.mark.parametrize("b,nq,nk,c,h", [(2, 40, 9, 64, 2),
                                         (1, 33, 17, 64, 1)])
def test_sr_attention_gradients_match_autograd_of_plain(b, nq, nk, c, h):
    """`sr_attention` (through `SRAttention`) gives autograd's gradients
    of the plain forward on the CPU, in float32 (rounding-level)."""
    rng = np.random.default_rng(1)
    arrays = [rng.normal(size=(b, n, c)).astype(np.float32)
              for n in (nq, nk, nk)]
    g = torch.from_numpy(rng.normal(size=(b, nq, c)).astype(np.float32))
    ours = [torch.from_numpy(a).requires_grad_() for a in arrays]
    plain = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = sr_attention(*ours, h)
    assert out.grad_fn is not None and "SRAttention" in type(
        out.grad_fn).__name__
    out.backward(g)
    sr_attention_reference(*plain, h).backward(g)
    for a, p in zip(ours, plain):
        torch.testing.assert_close(a.grad, p.grad, atol=1e-5, rtol=1e-5)


def test_cpu_calls_are_plain_and_not_counted():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs())
    before = (sr_attention.launches, sr_attention_bwd.launches)
    got = sr_attention_bwd(q, k, v, g, H)
    ref = sr_attention_backward_reference(q, k, v, g, H)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    qq = q.clone().requires_grad_()
    SRAttention.apply(qq, k, v, H).sum().backward()
    assert (sr_attention.launches, sr_attention_bwd.launches) == before


@pytest.mark.parametrize("g_shape", [(1, 8, 32), (1, 9, 16)])
def test_backward_rejects_bad_shapes(g_shape):
    q = torch.zeros(1, 8, 16)
    k = v = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError):
        sr_attention_bwd(q, k, v, torch.zeros(g_shape), 2)


@pytest.mark.parametrize("b,nq,nk,h,want", [
    (16, 16384, 256, 1, 5),    # B5 stage 1 at batch 16: 128 blocks alone
    (16, 4096, 256, 2, 3),     # stage 2: 256 blocks
    (16, 1024, 256, 5, 1),     # stage 3: 640 blocks fill the card
    (16, 256, 256, 8, 1),      # stage 4
    (2, 300, 5, 1, 10),        # few keys: splits down to one row tile
])
def test_key_pass_splits_fill_the_card(b, nq, nk, h, want):
    """The backward kernel's key pass splits its query rows so that about
    `BWD_TARGET_BLOCKS` blocks run, each split at least one row tile, and
    no split is empty once the kernel rounds the rows per split to tiles."""
    splits = bwd_key_splits(b, nq, nk, h)
    assert splits == want
    rows = -(-(-(-nq // splits)) // BWD_ROW_TILE) * BWD_ROW_TILE
    assert (splits - 1) * rows < nq <= splits * rows
    blocks = -(-nk // 32) * b * h
    assert splits == 1 or (splits - 1) * blocks < BWD_TARGET_BLOCKS


@pytest.mark.parametrize("b,nq,nk,h,want", [
    (16, 16384, 256, 1, 5),    # B5 stage 1 at batch 16: 4 * 16 blocks alone
    (16, 4096, 256, 2, 3),     # stage 2: 128 blocks
    (16, 1024, 256, 5, 1),     # stage 3: 320 blocks fill the card
    (16, 256, 256, 8, 1),      # stage 4
    (16, 16394, 266, 1, 4),    # stage 1 with a 10-token prompt: 5 key blocks
    (2, 300, 5, 1, 5),         # few keys: splits down to one 64-row tile
])
def test_mma_key_pass_splits_fill_the_card(b, nq, nk, h, want):
    """bfloat16 (the tensor-core key pass): blocks of 64 keys, 64-row tiles,
    about `BWD_MMA_TARGET_BLOCKS` blocks, no empty split."""
    splits = bwd_key_splits(b, nq, nk, h, torch.bfloat16)
    assert splits == want
    tile = BWD_MMA_ROW_TILE
    rows = -(-(-(-nq // splits)) // tile) * tile
    assert (splits - 1) * rows < nq <= splits * rows
    blocks = -(-nk // BWD_MMA_KEYS_PER_BLOCK) * b * h
    assert splits == 1 or (splits - 1) * blocks < BWD_MMA_TARGET_BLOCKS
