"""Card-only tests of the port's CUDA kernels: `sr_attention_fwd` (its
scalar and tensor-core kernels) and `sr_attention_bwd` against their plain
versions on the card, gradients through `sr_attention` on CUDA, and the
launch counts of a small EMA step.
Marked `cuda`; each skips without a CUDA device (decided in a fixture, not
at import). On a machine with a card and no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from semisupervisedobjectdetection_torch.ops.sr_attention import (
    sr_attention,
    sr_attention_backward_reference,
    sr_attention_bwd,
    sr_attention_reference,
)

pytestmark = pytest.mark.cuda

# bfloat16: one or two output ulps where a sum rounds the other way
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


# Backward, as a share of the largest gradient magnitude: float32 sums in
# another order; bfloat16 outputs one or two ulps (2**-7 relative) apart.
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SHAPES = [
    (2, 256, 256, 64, 1),      # square, aligned
    (1, 1030, 266, 64, 1),     # prompt prefix, ragged query tail
    (2, 131, 96, 128, 2),      # multi-head, unaligned nk
    (2, 77, 257, 320, 5),      # CLS prefix, B1-B5 stage-3 heads
    (2, 300, 5, 32, 1),        # B0 head width, tiny key stream
]


# Edge shapes of the bfloat16 tensor-core kernels (16-row warp tiles,
# 16-key tiles, 64-key and 64-row key-pass blocks): one query row, a ragged
# 17 rows, Nk at the 288 cap and at one 16-key tile, the B0 head width with
# five keys, and MiT-B5's stage 3 (40 of its 52 layers).
MMA_EDGE_SHAPES = [
    (2, 1, 256, 64, 1),
    (2, 17, 96, 128, 2),
    (1, 300, 288, 64, 1),
    (2, 131, 16, 64, 1),
    (2, 300, 5, 32, 1),
    (2, 1024, 256, 320, 5),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, b, nq, nk, c, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, n, c, device=cuda, generator=g).to(dtype)
            for n in (nq, nk, nk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,c,h", SHAPES)
def test_kernel_matches_plain(cuda, dtype, b, nq, nk, c, h):
    q, k, v = _qkv(cuda, b, nq, nk, c, dtype)
    before = sr_attention.launches
    out = sr_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert sr_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = sr_attention_reference(q, k, v, h)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("mma", [False, True])
@pytest.mark.parametrize("b,nq,nk,c,h", SHAPES)
def test_bf16_forward_kernels_match_plain(cuda, mma, b, nq, nk, c, h):
    """Both bfloat16 forward kernels: the scalar one (serving's) and the
    tensor-core one (the default)."""
    q, k, v = _qkv(cuda, b, nq, nk, c, torch.bfloat16)
    before = sr_attention.launches, sr_attention.mma_launches
    out = sr_attention(q, k, v, h, mma=mma)
    torch.cuda.synchronize()
    assert (sr_attention.launches, sr_attention.mma_launches) == (
        before[0] + 1, before[1] + mma)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = sr_attention_reference(q, k, v, h)
    assert (out.float() - ref.float()).abs().max().item() <= \
        TOL[torch.bfloat16]


@pytest.mark.parametrize("b,nq,nk,c,h", MMA_EDGE_SHAPES)
def test_mma_kernels_at_edge_shapes(cuda, b, nq, nk, c, h):
    """bfloat16: the tensor-core forward and backward agree with their
    plain versions, and two backward launches give the same bits."""
    dtype = torch.bfloat16
    q, k, v = _qkv(cuda, b, nq, nk, c, dtype)
    g = _qkv(cuda, b, nq, nk, c, dtype, seed=1)[0]
    out = sr_attention(q, k, v, h, mma=True)
    got = sr_attention_bwd(q, k, v, g, h)
    again = sr_attention_bwd(q, k, v, g, h)
    torch.cuda.synchronize()
    ref = sr_attention_reference(q, k, v, h)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for a, a2, r, x in zip(got, again,
                           sr_attention_backward_reference(q, k, v, g, h),
                           (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape
        assert torch.equal(a, a2)
        assert _rel_err(a, r) <= BWD_TOL[dtype]


def test_kernel_rejects_what_it_cannot_run(cuda):
    q, k, v = _qkv(cuda, 1, 16, 8, 48, torch.float32)
    with pytest.raises(ValueError, match="head width"):
        sr_attention(q, k, v, 1)                      # d = 48
    q, k, v = _qkv(cuda, 1, 16, 300, 64, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        sr_attention(q, k, v, 1)                      # nk = 300
    q, k, v = _qkv(cuda, 1, 16, 300, 64, torch.bfloat16)
    for mma in (False, True):
        with pytest.raises(ValueError, match="shared memory"):
            sr_attention(q, k, v, 1, mma=mma)         # nk = 300
    q, k, v = _qkv(cuda, 1, 16, 8, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sr_attention(q, k, v, 1)
    q, k, v = _qkv(cuda, 1, 16, 8, 128, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        sr_attention(q[..., :64], k[..., :64], v[..., :64], 1)


def _rel_err(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,c,h", SHAPES)
def test_bwd_kernel_matches_plain_and_is_deterministic(cuda, dtype, b, nq,
                                                       nk, c, h):
    q, k, v = _qkv(cuda, b, nq, nk, c, dtype)
    g = _qkv(cuda, b, nq, nk, c, dtype, seed=1)[0]
    before = sr_attention_bwd.launches
    got = sr_attention_bwd(q, k, v, g, h)
    again = sr_attention_bwd(q, k, v, g, h)
    torch.cuda.synchronize()
    assert sr_attention_bwd.launches == before + 2
    ref = sr_attention_backward_reference(q, k, v, g, h)
    for a, a2, r, x in zip(got, again, ref, (q, k, v)):
        assert a.dtype == dtype and a.shape == x.shape
        assert torch.equal(a, a2)
        assert _rel_err(a, r) <= BWD_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_through_sr_attention_on_cuda(cuda, dtype):
    """A backward through `sr_attention` on the card reaches q, k and v,
    through the kernel, with the plain version's gradients."""
    q, k, v = (t.requires_grad_() for t in _qkv(cuda, 2, 131, 96, 128,
                                                 dtype))
    g = _qkv(cuda, 2, 131, 96, 128, dtype, seed=1)[0]
    before = sr_attention_bwd.launches
    out = sr_attention(q, k, v, 2)
    assert out.requires_grad
    out.backward(g)
    torch.cuda.synchronize()
    assert sr_attention_bwd.launches == before + 1
    ref = sr_attention_backward_reference(q.detach(), k.detach(), v.detach(),
                                          g, 2)
    for x, r in zip((q, k, v), ref):
        assert x.grad is not None
        assert _rel_err(x.grad, r) <= BWD_TOL[dtype]


def test_bwd_kernel_rejects_what_it_cannot_run(cuda):
    q, k, v = _qkv(cuda, 1, 16, 8, 48, torch.float32)
    with pytest.raises(ValueError, match="head width"):
        sr_attention_bwd(q, k, v, q, 1)               # d = 48
    q, k, v = _qkv(cuda, 1, 16, 300, 64, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        sr_attention_bwd(q, k, v, q, 1)               # nk = 300
    q, k, v = _qkv(cuda, 1, 16, 8, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sr_attention_bwd(q, k, v, q, 1)


def test_ema_step_launches_both_kernels(cuda):
    """A small EMA step on the card (MiT-B0 widths, head width 32, one layer
    per stage, 64x64, accum 2, the tensor-core forward by default): per
    microbatch the forward kernel runs in the teacher forward, the student
    forward and the student's recompute, and the backward kernel once per
    layer."""
    import copy

    from semisupervisedobjectdetection_torch.core.config import (
        TrainConfig,
        mit_b0,
    )
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.ema import ema_semi_step
    from semisupervisedobjectdetection_torch.train.state import TrainState

    cfg = mit_b0(depths=(1, 1, 1, 1), dtype="bfloat16")
    model = init_weights(SegFormer(cfg), torch.Generator().manual_seed(0))
    teacher = TrainState.create(copy.deepcopy(model).to(cuda), TrainConfig())
    student = TrainState.create(model.to(cuda), TrainConfig(), lr=3e-5)
    g = torch.Generator(device=cuda).manual_seed(0)
    imgs, unl = (torch.rand(4, 64, 64, 3, device=cuda, generator=g)
                 for _ in "iu")
    gt = (torch.rand(4, 64, 64, device=cuda, generator=g) > 0.7).float()
    f0, b0 = sr_attention.launches, sr_attention_bwd.launches
    m0 = sr_attention.mma_launches
    out = ema_semi_step(teacher, student, unl, imgs, gt, 0.8, 0.999,
                        accum=2)
    torch.cuda.synchronize()
    assert sr_attention.launches - f0 == 2 * 3 * 4
    assert sr_attention.mma_launches - m0 == 2 * 3 * 4
    assert sr_attention_bwd.launches - b0 == 2 * 4
    assert torch.isfinite(out.student_loss_total).item()
    assert int(student.count) == 1
