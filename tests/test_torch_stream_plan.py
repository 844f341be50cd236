"""The bfloat16 streaming kernels' launch plans past 288 keys, on the CPU
(`fwd_stream_plan`, which K1's kernels and K2's row pass share, and the key
pass of `bwd_launch_plan`'s stream plan, in
`semisupervisedobjectdetection_torch/ops/sr_attention.py`): every 64-row
query tile and every (query tile, 64-key M-tile) pair covered once, in
order; every SM working in the first wave at MiT-B5's Nk-356 shapes at
batch 16, at Nk 300 and at Nk 1024, the longest CTA within 1.1x the mean;
K1's split kernel (K/V whole in shared memory) up to 576 keys and its
two-sweep kernel past them, K2's split row pass up to 384; and the float32
and on-chip bfloat16 plans as they were before the streaming plans
changed. No JAX and no card: each
case takes milliseconds. (The kernels' shared memory against the card's
is checked where they are built: chip_smoke.py's build phase.)"""

import hashlib
import json

import pytest

from semisupervisedobjectdetection_torch.ops.sr_attention import (
    BWD_SPLIT_ROWS_NK,
    BWD_WGMMA_ROW_TILE,
    F32_KEY_BLOCK,
    FWD_SPLIT_KERNEL,
    FWD_SPLIT_NK,
    FWD_STREAM_KERNEL,
    H100_SMS,
    bwd_f32_plan,
    bwd_launch_plan,
    fwd_stream_plan,
    stream_key_work,
    stream_segments,
)

# (B, Nq, Nk, C, heads): MiT-B5's four stage shapes at 512x512 with 100
# prompt tokens per stage (Nk 356) at the student batch, stage 1 with a
# 44-token prefix (Nk 300) at batch 2, stage 1 at 1024x1024 (Nk 1024)
FILL_SHAPES = [
    (16, 16484, 356, 64, 1),
    (16, 4196, 356, 128, 2),
    (16, 1124, 356, 320, 5),
    (16, 356, 356, 512, 8),
    (2, 16428, 300, 64, 1),
    (1, 65536, 1024, 64, 1),
]
# and a few small ones: a ragged tail, more heads, fewer tiles than SMs
COVER_SHAPES = FILL_SHAPES + [
    (3, 129, 289, 64, 2),
    (2, 1000, 577, 64, 1),
    (1, 64, 1665, 64, 2),
]


@pytest.mark.parametrize("b,nq,nk,c,h", COVER_SHAPES)
def test_row_plan_covers_each_tile_once_in_order(b, nq, nk, c, h):
    """K1's streaming grid and K2's row pass: CTA by CTA, the segments
    walk every (batch, head)'s 64-row query tiles once, in (batch, head,
    tile) order, each CTA a non-empty contiguous run, none more than one
    tile over another."""
    plan = fwd_stream_plan(b, nq, nk, c, h)
    tiles = -(-nq // BWD_WGMMA_ROW_TILE)
    assert plan["tiles_per_pair"] == tiles
    assert plan["tiles"] == b * h * tiles
    assert plan["grid"] == min(plan["tiles"], H100_SMS)
    walked = [(pair, t) for segs in stream_segments(
                  plan["tiles"], plan["grid"], tiles)
              for pair, first, last in segs
              for t in range(first, last + 1)]
    assert walked == [(p, t) for p in range(b * h) for t in range(tiles)]
    cta = plan["cta_tiles"]
    assert len(cta) == plan["grid"] and sum(cta) == plan["tiles"]
    assert min(cta) >= 1 and max(cta) - min(cta) <= 1


@pytest.mark.parametrize("b,nq,nk,c,h", FILL_SHAPES)
def test_plans_fill_every_sm_in_the_first_wave(b, nq, nk, c, h):
    """At the named shapes both grids put one CTA on each of the 132 SMs,
    each with work, and the longest CTA holds at most 1.1x the mean work
    per SM (query tiles for the row plan, (query tile, key group) units
    for the key pass)."""
    plan = fwd_stream_plan(b, nq, nk, c, h)
    assert plan["grid"] == H100_SMS
    assert max(plan["cta_tiles"]) <= 1.1 * plan["tiles"] / H100_SMS
    bwd = bwd_launch_plan(b, nq, nk, c, h)
    assert bwd["row_grid"] == H100_SMS and bwd["key_grid"] == H100_SMS
    per_cta = [sum(last - first + 1 for _, first, last in segs)
               for segs in stream_segments(bwd["key_total"], H100_SMS,
                                           bwd["q_tiles"],
                                           bwd["key_granule"])]
    assert min(per_cta) >= 1 and sum(per_cta) == bwd["key_total"]
    assert max(per_cta) <= 1.1 * bwd["key_total"] / H100_SMS


@pytest.mark.parametrize("d", [32, 64])
def test_split_kernels_hold_the_row_up_to_their_last_key(d):
    """K1 runs its split kernel (the score row over both consumers, K and V
    whole in shared memory) from 289 keys up to `FWD_SPLIT_NK` (576, twice
    the on-chip row) and its two-sweep kernel (K and V streamed) past them;
    K2's row pass runs its split kernel up to `BWD_SPLIT_ROWS_NK` (384: 12
    key tiles a consumer beside dp and dq in registers) and two sweeps past
    them; at head width 32 and 64 alike (registers, not shared memory, set
    the limits)."""
    assert (FWD_SPLIT_NK, BWD_SPLIT_ROWS_NK) == (576, 384)
    c = 2 * d
    for nk in (289, BWD_SPLIT_ROWS_NK, BWD_SPLIT_ROWS_NK + 1, FWD_SPLIT_NK,
               FWD_SPLIT_NK + 1, 1665):
        plan = fwd_stream_plan(2, 1000, nk, c, 2)
        assert plan["split"] == (nk <= FWD_SPLIT_NK)
        assert plan["kernel"] == (FWD_SPLIT_KERNEL if plan["split"]
                                  else FWD_STREAM_KERNEL)
        bwd = bwd_launch_plan(2, 1000, nk, c, 2)
        assert bwd["split_rows"] == (nk <= BWD_SPLIT_ROWS_NK)
        assert bwd["kernels"][:2] == (
            "sr_attention_bwd_wgmma_split_rows_kernel" if bwd["split_rows"]
            else "sr_attention_bwd_wgmma_rows_kernel",
            "sr_attention_bwd_wgmma_keys_kernel")


@pytest.mark.parametrize("b,nq,nk,c,h", COVER_SHAPES)
def test_key_pass_work_covers_each_tile_and_m_tile_once(b, nq, nk, c, h):
    """The streaming key pass's work list, CTA by CTA: every (query tile,
    64-key M-tile) pair of every (batch, head) exactly once, each M-tile's
    query tiles in order across the CTAs that share it (the order the
    split sum adds their slots); the split sum and its workspace exactly
    where a key group spans CTAs."""
    plan = bwd_launch_plan(b, nq, nk, c, h)
    tiles = -(-nq // BWD_WGMMA_ROW_TILE)
    blocks = -(-nk // F32_KEY_BLOCK)
    seen = {}
    for pair, kb, first, last in stream_key_work(plan):
        seen.setdefault((pair, kb), []).extend(range(first, last + 1))
    assert sorted(seen) == [(p, kb) for p in range(b * h)
                            for kb in range(blocks)]
    assert all(v == list(range(tiles)) for v in seen.values())
    split = plan["splits"] > 1
    assert plan["workspace_floats"] == (
        plan["key_grid"] * 2 * 2 * 128 * (c // h) if split else 0)
    assert plan["kernels"][2:] == (
        ("sr_attention_bwd_split_sum_kernel",) if split else ())


# sha256 (first 16 hex digits) of each plan's dict as JSON with sorted keys,
# as the float32 and on-chip bfloat16 plans gave it before the streaming
# plans were redesigned, at the shapes tests/test_torch_sr_attention_bwd.py
# uses
F32_PLAN_DIGESTS = {
    (16, 16384, 256, 64, 1): "6e73e170fd2fd841",
    (16, 4096, 256, 128, 2): "92f11c8e9616fd81",
    (16, 1024, 256, 320, 5): "1be14c17fff0aba8",
    (16, 256, 256, 512, 8): "170dead8af6a50d4",
    (2, 300, 5, 64, 1): "1a40964fabbba877",
    (2, 16385, 257, 64, 1): "b413836537238ab1",
    (2, 1124, 356, 320, 5): "2201a60af471ce18",
    (1, 65536, 1024, 64, 1): "acbfab7901dd08bd",
}
ON_CHIP_PLAN_DIGESTS = {
    (16, 16384, 256, 64, 1): "ed58d03a3a5468b8",
    (16, 4096, 256, 128, 2): "1a1ac3acecdb08c8",
    (16, 1024, 256, 320, 5): "2fbde503e0f23ed5",
    (16, 256, 256, 512, 8): "5ba699524893a6a4",
    (16, 16394, 266, 64, 1): "49f9f083cc0f5db7",
    (2, 16385, 257, 64, 1): "d491fc285121404b",
    (2, 4097, 257, 128, 2): "4f888712d2b11991",
    (2, 1025, 257, 320, 5): "07bad95e029e2ff4",
    (2, 257, 257, 512, 8): "03089ab4548de3eb",
    (1, 1, 1, 32, 1): "534be6138a1a27ef",
    (200, 100, 64, 64, 1): "940cf1e3474f2846",
}


def _digest(plan: dict) -> str:
    return hashlib.sha256(
        json.dumps(plan, sort_keys=True).encode()).hexdigest()[:16]


@pytest.mark.parametrize("plan_fn,shape,digest",
                         [(bwd_f32_plan, s, d)
                          for s, d in F32_PLAN_DIGESTS.items()]
                         + [(bwd_launch_plan, s, d)
                            for s, d in ON_CHIP_PLAN_DIGESTS.items()])
def test_float32_and_on_chip_plans_are_unchanged(plan_fn, shape, digest):
    """`bwd_f32_plan` and the on-chip `bwd_launch_plan` (Nk <= 288) give
    exactly the dicts they gave before."""
    assert _digest(plan_fn(*shape)) == digest
