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
    BWD_WGMMA_ROW_TILE,
    F32_KEY_BLOCK,
    F32_KEY_PASS_ROWS,
    F32_ROW_TILE,
    H100_SMS,
    SRAttention,
    bwd_f32_key_work,
    bwd_f32_plan,
    bwd_launch_plan,
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
    (16, 16384, 256, 1, 4),    # B5 stage 1 at batch 16: 16 pairs x 2 groups
    (16, 4096, 256, 2, 2),     # stage 2: 64 CTAs a split
    (16, 1024, 256, 5, 1),     # stage 3: 160 CTAs fill the card alone
    (16, 256, 256, 8, 1),      # stage 4
    (2, 300, 5, 1, 10),        # few keys: splits down to one row tile
    (2, 16385, 257, 1, 22),    # few-shot stage 1: 2 pairs x 3 groups
    (2, 1124, 356, 5, 4),      # stage 3 with 100 prompt tokens (Nk 356)
    (1, 65536, 1024, 1, 16),   # stage 1 at 1024x1024 (Nk 1024)
])
def test_key_pass_splits_fill_the_card(b, nq, nk, h, want):
    """The float32 backward's launch plan: the key pass splits each
    (batch, head)'s 32-row query tiles into as many contiguous ranges as
    fill the SMs once with (batch, head) x key group x split CTAs, and
    covers every (query tile, 64-key block) pair of every (batch, head)
    exactly once, the ranges of a key block in split order (the order the
    split sum adds them); the row pass gives every 64-row tile to exactly
    one CTA; the workspaces and kernels follow the split count."""
    c = 64 * h
    plan = bwd_f32_plan(b, nq, nk, c, h)
    pairs, tiles = b * h, -(-nq // F32_KEY_PASS_ROWS)
    blocks = -(-nk // F32_KEY_BLOCK)
    assert plan["splits"] == want
    assert plan["key_grid"] == pairs * plan["key_groups"] * want
    assert plan["key_grid"] <= H100_SMS or want == 1
    assert want == tiles or (pairs * plan["key_groups"] * (want + 1)
                             > H100_SMS)
    work = bwd_f32_key_work(plan, pairs)
    seen = {}
    for pair, kb, first, last in work:
        assert first <= last
        seen.setdefault((pair, kb), []).append((first, last))
    assert sorted(seen) == [(p, kb) for p in range(pairs)
                            for kb in range(blocks)]
    for ranges in seen.values():
        # contiguous, in split order, no tile twice, every tile once
        assert ranges[0][0] == 0 and ranges[-1][1] == tiles - 1
        assert all(r[1] + 1 == n[0] for r, n in zip(ranges, ranges[1:]))
        assert len(ranges) == want
    assert plan["workspace_floats"] == (want * 2 * b * nk * c
                                        if want > 1 else 0)
    assert plan["stats_floats"] == pairs * nq * 4
    assert plan["kernels"] == ("sr_attention_bwd_f32_rows_kernel",
                               "sr_attention_bwd_f32_keys_kernel") + (
        ("sr_attention_bwd_f32_sum_kernel",) if want > 1 else ())
    row_tiles, n = -(-nq // F32_ROW_TILE), plan["row_ctas_per_pair"]
    runs = [(j + 1) * row_tiles // n - j * row_tiles // n for j in range(n)]
    assert plan["row_grid"] == pairs * n and sum(runs) == row_tiles
    assert min(runs) >= 1


@pytest.mark.parametrize("b,nq,nk,c,h,grid,split", [
    (16, 16384, 256, 64, 1, 132, True),    # B5 stage 1 at batch 16: 16 pairs
    (16, 4096, 256, 128, 2, 132, True),    # stage 2: 32 pairs
    (16, 1024, 256, 320, 5, 132, True),    # stage 3: 80 pairs of 16 tiles
    (16, 256, 256, 512, 8, 128, False),    # stage 4: 128 pairs of 4 tiles
    (16, 16394, 266, 64, 1, 132, True),    # stage 1, 10-token prompt
    (2, 16385, 257, 64, 1, 132, True),     # few-shot stage 1: 2 pairs
    (2, 4097, 257, 128, 2, 132, True),     # few-shot stage 2
    (2, 1025, 257, 320, 5, 132, True),     # few-shot stage 3
    (2, 257, 257, 512, 8, 80, True),       # few-shot stage 4: 80 tiles
    (1, 1, 1, 32, 1, 1, False),            # tiny: one tile
    (200, 100, 64, 64, 1, 200, False),     # more pairs than SMs: one a CTA
])
def test_wgmma_launch_plan_fills_the_card(b, nq, nk, c, h, grid, split):
    """bfloat16 (the wgmma kernel): the grid gives every SM work where there
    are as many 64-row query tiles as SMs, unless cutting (batch, head)s
    over CTAs would not shorten the longest CTA (then one whole (batch,
    head) a CTA); every CTA a non-empty contiguous range of tiles, the
    workspace two float32 dk/dv slots per CTA exactly where a (batch, head)
    is split, and the split sum as a second launch only then."""
    plan = bwd_launch_plan(b, nq, nk, c, h)
    tiles = -(-nq // BWD_WGMMA_ROW_TILE)
    total = b * h * tiles
    assert (plan["grid"], plan["split"]) == (grid, split)
    assert plan["tiles"] == total and plan["tiles_per_pair"] == tiles
    longest_cut = -(-total // min(total, H100_SMS))
    if plan["grid"] == b * h:
        assert -(-b * h // H100_SMS) * tiles <= longest_cut
    else:
        assert min(plan["grid"], H100_SMS) == min(total, H100_SMS)
    cta = plan["cta_tiles"]
    assert len(cta) == plan["grid"] and sum(cta) == total
    assert min(cta) >= 1 and max(cta) - min(cta) <= 1
    assert plan["workspace_floats"] == (
        plan["grid"] * 2 * 2 * nk * (c // h) if split else 0)
    assert plan["kernels"] == ("sr_attention_bwd_wgmma_kernel",) + (
        ("sr_attention_bwd_split_sum_kernel",) if split else ())
    # a pair is cut exactly where some CTA boundary falls inside it
    bounds = np.cumsum([0] + cta)
    assert split == bool(np.any(bounds[1:-1] % tiles))
