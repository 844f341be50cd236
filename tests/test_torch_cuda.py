"""Card-only tests of the port's CUDA kernels: `sr_attention_fwd` (its
bfloat16 wgmma + TMA kernel, also at every main-path shape, and its float32
3xTF32 kernel) and `sr_attention_bwd` (its bfloat16 wgmma + TMA kernel,
also at its edge shapes, and its float32 3xTF32 row pass, key pass and
split sum), each launching only its design's kernels, against their plain
versions on the card (also at the few-shot step's shapes, and in float32
past the bfloat16 limit up to Nk 1024, bit-identical on a rerun),
gradients
through `sr_attention` on CUDA, the launch counts of a small EMA step, a
train-mode gradient through the kernels, and the augmentation on the card
against the CPU.
Marked `cuda`; each skips without a CUDA device (decided in a fixture, not
at import). On a machine with a card and no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from semisupervisedobjectdetection_torch.ops.sr_attention import (
    FWD_KERNELS,
    bwd_f32_plan,
    bwd_launch_plan,
    sr_attention,
    sr_attention_backward_reference,
    sr_attention_bwd,
    sr_attention_reference,
)
from semisupervisedobjectdetection_torch.utils.profile_forward import (
    kernels_launched,
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


@pytest.mark.parametrize("b,nq,nk,c,h", SHAPES)
def test_bf16_forward_kernels_match_plain(cuda, b, nq, nk, c, h):
    """The bfloat16 forward kernel (wgmma, every bf16 path's), counted in
    both counters."""
    q, k, v = _qkv(cuda, b, nq, nk, c, torch.bfloat16)
    before = sr_attention.launches, sr_attention.mma_launches
    out = sr_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert (sr_attention.launches, sr_attention.mma_launches) == (
        before[0] + 1, before[1] + 1)
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
    out = sr_attention(q, k, v, h)
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


# The Hopper forward's main-path shapes (B, Nq, Nk, C, heads): MiT-B5's four
# stages at 512x512 at the serving, student and teacher batches; a 10-token
# prompt prefix (stage 1, Nq 16394 / Nk 266) and a CLS token (stage 3, Nq
# 1025 / Nk 257); Nk at its 288 cap; MiT-B0's head width 32; query counts
# that are not a multiple of the 64-row tile; the few-shot batch of 2.
B5_STAGES = [(16384, 256, 64, 1), (4096, 256, 128, 2), (1024, 256, 320, 5),
             (256, 256, 512, 8)]
HOPPER_SHAPES = [(b,) + s for b in (8, 16, 32) for s in B5_STAGES] + [
    (8, 16394, 266, 64, 1),
    (8, 1025, 257, 320, 5),
    (4, 1000, 288, 128, 2),
    (8, 4096, 256, 32, 1),       # B0 stage 1
    (8, 1024, 256, 64, 2),       # B0 stage 2
    (3, 4097, 200, 256, 8),      # d 32, ragged Nq, Nk under 256
    (2, 16385, 257, 64, 1),      # few-shot stage 1
    (2, 257, 257, 512, 8),       # few-shot stage 4
]


@pytest.mark.parametrize("b,nq,nk,c,h", HOPPER_SHAPES)
def test_hopper_forward_at_main_path_shapes(cuda, b, nq, nk, c, h):
    """The wgmma forward against the plain version at KERNEL_TOL bf16,
    bit-identical on a rerun, one launch of it per call."""
    q, k, v = _qkv(cuda, b, nq, nk, c, torch.bfloat16)
    before = sr_attention.launches, sr_attention.mma_launches
    out = sr_attention(q, k, v, h)
    again = sr_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert (sr_attention.launches, sr_attention.mma_launches) == (
        before[0] + 2, before[1] + 2)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert torch.equal(out, again)
    ref = sr_attention_reference(q, k, v, h)
    assert (out.float() - ref.float()).abs().max().item() <= \
        TOL[torch.bfloat16]


def test_hopper_forward_refuses_what_it_cannot_run(cuda):
    """Nk 289 (one key past the cap) and a non-contiguous input raise
    before any launch."""
    before = sr_attention.launches, sr_attention.mma_launches
    q, k, v = _qkv(cuda, 1, 64, 289, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        sr_attention(q, k, v, 1)
    q, k, v = _qkv(cuda, 1, 64, 96, 128, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        sr_attention(q[..., :64], k[..., :64], v[..., :64], 1)
    with pytest.raises(ValueError, match="contiguous"):
        sr_attention(torch.cat([q, q], 1)[:, ::2], k, v, 2)
    assert (sr_attention.launches, sr_attention.mma_launches) == before


def test_kernel_rejects_what_it_cannot_run(cuda):
    q, k, v = _qkv(cuda, 1, 16, 8, 48, torch.float32)
    with pytest.raises(ValueError, match="head width"):
        sr_attention(q, k, v, 1)                      # d = 48
    q, k, v = _qkv(cuda, 1, 16, 300, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="Nk <= 288"):
        sr_attention(q, k, v, 1)                      # bf16 nk = 300
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


# The few-shot step's shapes at 512x512 (batch 2, one CLS token per stage:
# Nq = H*W + 1, Nk = 256 + 1) and K2's tolerance at them: dk and dv sum up
# to 16385 query rows, which the kernel takes in splits and the plain
# version in one sequence (float32 ~sqrt(16k) * 2**-24 apart; chip_smoke's
# KERNEL_BWD_TOL).
FEWSHOT_SHAPES = [(2, 16385, 257, 64, 1), (2, 4097, 257, 128, 2),
                  (2, 1025, 257, 320, 5), (2, 257, 257, 512, 8)]
FEWSHOT_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,c,h", FEWSHOT_SHAPES)
def test_kernels_at_fewshot_shapes(cuda, dtype, b, nq, nk, c, h):
    """K1 and K2 (the bfloat16 wgmma kernels, the float32 3xTF32 ones)
    against their plain versions at the few-shot shapes; two K2 launches
    give the same bits."""
    q, k, v = _qkv(cuda, b, nq, nk, c, dtype)
    g = _qkv(cuda, b, nq, nk, c, dtype, seed=1)[0]
    out = sr_attention(q, k, v, h)
    got = sr_attention_bwd(q, k, v, g, h)
    again = sr_attention_bwd(q, k, v, g, h)
    torch.cuda.synchronize()
    ref = sr_attention_reference(q, k, v, h)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]
    for a, a2, r in zip(got, again,
                        sr_attention_backward_reference(q, k, v, g, h)):
        assert torch.equal(a, a2)
        assert _rel_err(a, r) <= FEWSHOT_BWD_TOL[dtype]


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


# Edges of the bfloat16 wgmma backward (64-row query tiles, 64-key M-tiles,
# 32-key statistics chunks, the fifth M-tile past 256 keys, a grid that
# splits (batch, head)s over CTAs or holds one a CTA): Nk 1, 63, 64, 65 and
# 288; Nq off the 64-row tile; head width 32; B * heads of 1 and of 200.
WGMMA_BWD_EDGES = [
    (2, 100, 1, 64, 1),
    (2, 100, 63, 64, 1),
    (2, 100, 64, 64, 1),
    (2, 100, 65, 64, 1),
    (2, 333, 288, 64, 1),
    (1, 1000, 200, 64, 1),       # B * heads 1, Nq 1000
    (4, 77, 130, 128, 4),        # head width 32, Nq 77
    (2, 4097, 257, 64, 2),       # head width 32, Nk 257
    (200, 130, 96, 64, 1),       # B * heads 200: one a CTA, in waves
    (25, 70, 266, 512, 8),       # B * heads 200, five M-tiles
]


@pytest.mark.parametrize("b,nq,nk,c,h", WGMMA_BWD_EDGES)
def test_wgmma_bwd_at_edge_shapes(cuda, b, nq, nk, c, h):
    """The bfloat16 backward (the wgmma kernel) against the plain version
    at BWD_TOL, the same bits on a rerun, each call counted once and
    launching the wgmma kernel (as the profiler saw the rerun)."""
    q, k, v = _qkv(cuda, b, nq, nk, c, torch.bfloat16)
    g = _qkv(cuda, b, nq, nk, c, torch.bfloat16, seed=1)[0]
    before = sr_attention_bwd.launches
    got = sr_attention_bwd(q, k, v, g, h)
    again, ran = kernels_launched(lambda: sr_attention_bwd(q, k, v, g, h),
                                  "sr_attention_bwd")
    assert sr_attention_bwd.launches == before + 2
    assert ran[0] == "sr_attention_bwd_wgmma_kernel"
    assert len(ran) == sr_attention_bwd.last_launches
    ref = sr_attention_backward_reference(q, k, v, g, h)
    for a, a2, r, x in zip(got, again, ref, (q, k, v)):
        assert a.dtype == torch.bfloat16 and a.shape == x.shape
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, a2)
        assert _rel_err(a, r) <= BWD_TOL[torch.bfloat16]


@pytest.mark.parametrize("b,nq,nk,c,h", [
    (16, 1024, 256, 320, 5),     # B5 stage 3: split over CTAs, two launches
    (16, 256, 256, 512, 8),      # B5 stage 4: one (batch, head) a CTA
    (1, 64, 64, 64, 1),          # one tile
])
def test_bf16_bwd_launches_only_the_wgmma_design(cuda, b, nq, nk, c, h):
    """A bfloat16 call launches the kernels of its launch plan (the wgmma
    kernel, and the split sum where the grid splits a (batch, head)) and
    none of an earlier design; a float32 call those of its plan (the row
    pass, the key pass, and the split sum where the key pass splits). The
    kernels are those the profiler saw run on the card, and their number
    is the launch count the wrapper recorded from the C launcher."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = bwd_launch_plan(b, nq, nk, c, h, sms)
    q, k, v = _qkv(cuda, b, nq, nk, c, torch.bfloat16)
    _, ran = kernels_launched(lambda: sr_attention_bwd(q, k, v, q, h),
                              "sr_attention_bwd")
    assert tuple(ran) == plan["kernels"]
    assert sr_attention_bwd.last_launches == len(ran) == 1 + plan["split"]
    assert set(ran) <= {"sr_attention_bwd_wgmma_kernel",
                        "sr_attention_bwd_split_sum_kernel"}
    q, k, v = (t.float() for t in (q, k, v))
    _, ran = kernels_launched(lambda: sr_attention_bwd(q, k, v, q, h),
                              "sr_attention_bwd")
    assert tuple(ran) == bwd_f32_plan(b, nq, nk, c, h, sms)["kernels"]
    assert sr_attention_bwd.last_launches == len(ran)


def test_bwd_kernel_rejects_what_it_cannot_run(cuda):
    q, k, v = _qkv(cuda, 1, 16, 8, 48, torch.float32)
    with pytest.raises(ValueError, match="head width"):
        sr_attention_bwd(q, k, v, q, 1)               # d = 48
    q, k, v = _qkv(cuda, 1, 16, 300, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="Nk <= 288"):
        sr_attention_bwd(q, k, v, q, 1)               # bf16 nk = 300
    q, k, v = _qkv(cuda, 1, 16, 8, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sr_attention_bwd(q, k, v, q, 1)


# The float32 kernels (3xTF32, K/V streamed) past the bfloat16 limit and at
# their edges: Nk 1 (one key: dq and dk exactly zero), 257, 288, 300, 356
# (100 prompt tokens at 512x512) and 1024 (stage 1 at 1024x1024); head
# widths 32 and 64; ragged Nq; B * heads of 1 and of 200.
F32_SHAPES = [
    (2, 100, 1, 64, 1),
    (1, 1000, 257, 64, 1),       # B * heads 1
    (2, 333, 288, 32, 1),        # head width 32
    (2, 150, 300, 64, 1),
    (2, 1124, 356, 320, 5),      # stage 3, 100 prompt tokens
    (1, 4096, 1024, 64, 1),      # Nk 1024
    (200, 77, 65, 32, 1),        # B * heads 200, head width 32
    (25, 70, 356, 512, 8),       # B * heads 200, Nk 356
]


@pytest.mark.parametrize("b,nq,nk,c,h", F32_SHAPES)
def test_f32_kernels_match_plain_at_any_nk(cuda, b, nq, nk, c, h):
    """The float32 forward and backward against their plain versions
    (forward at KERNEL_TOL f32 2e-5, backward at KERNEL_BWD_TOL f32 1e-4 of
    the largest gradient, exactly zero where the plain version's is),
    bit-identical on a rerun, launching the kernels of their design as the
    profiler saw them, counted once a call."""
    q, k, v = _qkv(cuda, b, nq, nk, c, torch.float32)
    g = _qkv(cuda, b, nq, nk, c, torch.float32, seed=1)[0]
    before = (sr_attention.launches, sr_attention.mma_launches,
              sr_attention_bwd.launches)
    out = sr_attention(q, k, v, h)
    again, ran = kernels_launched(lambda: sr_attention(q, k, v, h),
                                  "sr_attention_fwd")
    assert ran == [FWD_KERNELS[torch.float32]]
    got = sr_attention_bwd(q, k, v, g, h)
    again_bwd, ran = kernels_launched(
        lambda: sr_attention_bwd(q, k, v, g, h), "sr_attention_bwd")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tuple(ran) == bwd_f32_plan(b, nq, nk, c, h, sms)["kernels"]
    assert sr_attention_bwd.last_launches == len(ran)
    assert (sr_attention.launches, sr_attention.mma_launches,
            sr_attention_bwd.launches) == (before[0] + 2, before[1],
                                           before[2] + 2)
    assert torch.equal(out, again)
    ref = sr_attention_reference(q, k, v, h)
    assert (out - ref).abs().max().item() <= TOL[torch.float32]
    for a, a2, r, x in zip(got, again_bwd,
                           sr_attention_backward_reference(q, k, v, g, h),
                           (q, k, v)):
        assert a.dtype == torch.float32 and a.shape == x.shape
        assert torch.equal(a, a2)
        if r.abs().max().item() == 0.0:
            assert a.abs().max().item() == 0.0
        else:
            assert _rel_err(a, r) <= FEWSHOT_BWD_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_launches_the_kernel_of_its_dtype(cuda, dtype):
    """A forward call runs the kernel of its dtype alone, as the profiler
    saw it on the card."""
    q, k, v = _qkv(cuda, 2, 1025, 257, 320, dtype)
    _, ran = kernels_launched(lambda: sr_attention(q, k, v, 5),
                              "sr_attention_fwd")
    assert ran == [FWD_KERNELS[dtype]]


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


def test_train_mode_gradients_through_the_kernels(cuda):
    """A train-mode forward and backward (drop-path 0.3, classifier dropout
    0.1, BatchNorm on batch statistics) of a float32 MiT-B0 with one layer
    per stage at 64x64, through the kernels and through the plain path with
    the same masks (one generator seed): every parameter gradient agrees to
    1e-4 of the largest, the new BatchNorm statistics to 1e-5."""
    from semisupervisedobjectdetection_torch import losses
    from semisupervisedobjectdetection_torch.core.config import mit_b0
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.common import (
        forward_masks,
        grads_of,
    )

    cfg = mit_b0(depths=(1, 1, 1, 1), drop_path_rate=0.3,
                 classifier_dropout=0.1)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.rand(3, 64, 64, 3, device=cuda, generator=g)
    gt = (torch.rand(3, 64, 64, device=cuda, generator=g) > 0.6).float()
    got = {}
    for impl in ("kernel", "plain"):
        model = init_weights(SegFormer(cfg.replace(attn_impl=impl)),
                             torch.Generator().manual_seed(0)).to(cuda)
        b0 = sr_attention_bwd.launches
        m, _, stats = forward_masks(
            model, x, train_mode=True,
            generator=torch.Generator(device=cuda).manual_seed(5))
        grads = grads_of(losses.dice_loss(m, gt),
                         dict(model.named_parameters()))
        torch.cuda.synchronize()
        got[impl] = (grads, stats, sr_attention_bwd.launches - b0)
    assert got["kernel"][2] == 4 and got["plain"][2] == 0
    scale = max(g.abs().max().item() for g in got["plain"][0].values())
    for n, gk in got["kernel"][0].items():
        assert (gk - got["plain"][0][n]).abs().max().item() <= 1e-4 * scale
    for n, s in got["kernel"][1].items():
        torch.testing.assert_close(s, got["plain"][1][n], rtol=1e-5,
                                   atol=1e-5)


def test_augmentation_on_the_card_equals_the_cpu(cuda):
    """`augment_batch` with fixed choices and `eval_batch` (grow, shrink)
    give on the card what they give on the CPU: images to 1e-5, masks
    exactly."""
    from semisupervisedobjectdetection_torch.data.augment import (
        augment_batch,
        draw_choices,
        eval_batch,
    )

    g = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (8, 96, 96, 3), dtype=torch.uint8,
                         generator=g)
    masks = (torch.rand(8, 96, 96, generator=g) > 0.5).to(torch.uint8) * 255
    choices = draw_choices(8, 96, 96, 90, 0.75, g)
    cpu = augment_batch(imgs, masks, crop=90, out_h=96, out_w=96,
                        choices=choices)
    card = augment_batch(imgs.to(cuda), masks.to(cuda), crop=90, out_h=96,
                         out_w=96, choices=choices)
    for out in (96, 128, 48):
        pairs = [(cpu, card)] if out == 96 else []
        pairs.append((eval_batch(imgs, masks, out_h=out, out_w=out),
                      eval_batch(imgs.to(cuda), masks.to(cuda), out_h=out,
                                 out_w=out)))
        for (ci, cm), (gi, gm) in pairs:
            torch.testing.assert_close(gi.cpu(), ci, rtol=0, atol=1e-5)
            assert torch.equal(gm.cpu(), cm)
