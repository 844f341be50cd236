"""Sequence-reduction (SR) attention: the hand-written CUDA kernels and their
plain PyTorch versions, registered as `torch.library` operators.

SegFormer's SR-attention has a long query stream (H*W tokens plus the
prompt/CLS prefix: 16k at stage 1 of a 512x512 input) attending to a short
reduced key/value stream (256 tokens plus the prefix at every stage of a
512x512 input). The forward is the operator `ssod::sr_attention_fwd` and the
backward `ssod::sr_attention_bwd`, both defined with `torch.library.Library`
and a kernel for the CPU and CUDA dispatch keys; the forward's autograd
kernel calls the backward operator for its gradient, the counterpart of the
JAX package's `custom_vjp`. Each operator has a fake
implementation giving its outputs' shapes and dtypes, so `torch.export`
traces a model through them (`checkpoint/serving_export.py`). On a CUDA
tensor an operator's body launches `csrc/sr_attention_fwd.cu` or
`csrc/sr_attention_bwd.cu` through ctypes; on a CPU tensor it runs the plain
version (`sr_attention_reference`, `sr_attention_backward_reference`).

Training, serving and the exported artifact all go through the operators:
the op an artifact calls is the op that the training steps and the card's
checks hold. The launch counters are kept inside the bodies, so a launch
made from an exported program is counted like any other. The dispatcher
adds host time to every call (measured on the card against the autograd
function the operators replaced by `scripts/op_dispatch_ab.py`, PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from semisupervisedobjectdetection_torch.ops import _build

_SOURCE = "sr_attention_fwd.cu"
_BWD_SOURCE = "sr_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
# The most keys the on-chip bfloat16 kernels hold (`kMaxNkBf16` in both
# sources): one (batch, head)'s K and V sit on chip and the score row of a
# query tile sits in registers (the forward's 64-row tile: 18 tiles of 16
# keys). Past them the bfloat16 kernels of `fwd_stream_plan` and
# `bwd_launch_plan`'s stream plan run: every kernel family takes any Nk.
BF16_ON_CHIP_NK = 288
# The streaming key pass's key group: two 64-key M-tiles, one per consumer.
STREAM_UNIT_KEYS = 128
# Up to this many keys K2's row pass runs in one sweep with the score row
# split over the two consumer warpgroups (12 16-key tiles each).
BWD_SPLIT_ROWS_NK = 384
# The bfloat16 backward (the wgmma kernel) walks 64-row query tiles, one
# CTA an SM; the H100's SM count is the CPU's stand-in for the card's.
BWD_WGMMA_ROW_TILE = 64
H100_SMS = 132
# The float32 kernels' tiles as their launch plans count them: 64-row query
# tiles (the forward and the backward's row pass), 64-key blocks (the key
# pass's M, two per CTA) and 32-row query tiles (the key pass's ranges).
F32_ROW_TILE = 64
F32_KEY_BLOCK = 64
F32_KEY_PASS_ROWS = 32
# Opt-in shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
# The kernel a forward call of each dtype launches (`csrc/sr_attention_fwd.cu`)
# up to `BF16_ON_CHIP_NK` keys; past them bfloat16 launches the kernel
# `fwd_stream_plan` names: `FWD_SPLIT_KERNEL` up to `FWD_SPLIT_NK` keys,
# `FWD_STREAM_KERNEL` past them.
FWD_KERNELS = {torch.bfloat16: "sr_attention_fwd_wgmma_kernel",
               torch.float32: "sr_attention_fwd_f32_kernel"}
FWD_STREAM_KERNEL = "sr_attention_fwd_wgmma_stream_kernel"
FWD_SPLIT_KERNEL = "sr_attention_fwd_wgmma_split_kernel"
FWD_SPLIT_NK = 2 * BF16_ON_CHIP_NK


def streams_bf16(dtype: torch.dtype, nk: int) -> bool:
    """Whether a bfloat16 call at `nk` keys runs the streaming kernels (the
    forward's two sweeps, the backward's row and key passes)."""
    return dtype == torch.bfloat16 and nk > BF16_ON_CHIP_NK


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, C) -> float32 (B, N, heads, d)."""
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).float()


def sr_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Plain version: q (B,Nq,C) x k,v (B,Nk,C) -> (B,Nq,C).

    Scores and softmax in float32, probabilities rounded to v's dtype
    before P.V, float32 accumulation, output in q's dtype - the arithmetic
    of the kernel and of the TPU kernel it replaces.
    """
    b, nq, c = q.shape
    d = c // num_heads
    s = torch.einsum("bqhd,bkhd->bhqk", _split(q, num_heads),
                     _split(k, num_heads)) * (1.0 / math.sqrt(d))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), _split(v, num_heads))
    return o.reshape(b, nq, c).to(q.dtype)


def sr_attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, g: torch.Tensor,
                                    num_heads: int
                                    ) -> Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """Plain version of the backward: (dq, dk, dv) of `sr_attention` at
    (q, k, v) for the output gradient g (B,Nq,C).

    The arithmetic of the TPU kernel `_bwd_kernel` and of
    `csrc/sr_attention_bwd.cu`: p recomputed in float32 (not rounded);
    dv = p^T g and dp = g v^T in float32; ds = p * (dp - rowsum(dp * p)) *
    scale; ds rounded to k's dtype for dq = ds k and to q's dtype for
    dk = ds^T q, both summed in float32; dq in q's dtype, dk and dv cast
    from float32 to k's and v's.
    """
    b, nq, c = q.shape
    nk = k.shape[1]
    scale = 1.0 / math.sqrt(c // num_heads)
    qh, kh, vh, gh = (_split(t, num_heads) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale,
                      dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qh)
    return (dq.reshape(b, nq, c).to(q.dtype),
            dk.reshape(b, nk, c).to(k.dtype),
            dv.reshape(b, nk, c).to(v.dtype))


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built forward kernel library with its C signatures declared."""
    return declare_fwd(_build.load_library(_SOURCE))


def declare_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib`, a build of `csrc/sr_attention_fwd.cu`, with the C signatures
    of its exports declared."""
    lib.sr_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.sr_attention_fwd.restype = ctypes.c_int
    if hasattr(lib, "sr_attention_fwd_stream"):  # absent before it
        lib.sr_attention_fwd_stream.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.sr_attention_fwd_stream.restype = ctypes.c_int
    lib.sr_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sr_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.sr_attention_fwd_wgmma_ctas_per_sm.argtypes = [ctypes.c_int] * 2
    lib.sr_attention_fwd_wgmma_ctas_per_sm.restype = ctypes.c_int
    lib.sr_attention_fwd_error_string.argtypes = [ctypes.c_int]
    lib.sr_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The built backward kernel library with its C signatures declared."""
    return declare_bwd(_build.load_library(_BWD_SOURCE))


def declare_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib`, a build of `csrc/sr_attention_bwd.cu`, with the C signatures
    of its exports declared."""
    launched = ctypes.POINTER(ctypes.c_int)
    lib.sr_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
        + [launched, ctypes.c_void_p])
    lib.sr_attention_bwd.restype = ctypes.c_int
    lib.sr_attention_bwd_wgmma.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
        + [launched, ctypes.c_void_p])
    lib.sr_attention_bwd_wgmma.restype = ctypes.c_int
    if hasattr(lib, "sr_attention_bwd_stream"):  # absent before it
        lib.sr_attention_bwd_stream.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
            + [launched, ctypes.c_void_p])
        lib.sr_attention_bwd_stream.restype = ctypes.c_int
    lib.sr_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sr_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.sr_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.sr_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_limits(nk: int, d: int, elem: int) -> int:
    """Shared-memory bytes per block of the forward kernel for `elem`-byte
    inputs at `nk` keys."""
    return _lib().sr_attention_fwd_smem_bytes(nk, d, elem)


@functools.lru_cache(maxsize=None)
def _bwd_limits(nk: int, d: int, elem: int) -> int:
    """Shared-memory bytes per block of the backward kernels for
    `elem`-byte inputs at `nk` keys."""
    return _bwd_lib().sr_attention_bwd_smem_bytes(nk, d, elem)


def _launch(fn, device: torch.device, *args) -> int:
    """Call the C launcher `fn` with `args` and `device`'s current stream,
    with `device` current; returns its cudaError_t."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(device):
        return fn(*args, stream)


def _check(q, k, v, num_heads: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("sr_attention takes q (B,Nq,C), k and v (B,Nk,C)")
    b, _, c = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != c:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"C={c} is not a multiple of num_heads={num_heads}")
    if k.shape[1] < 1:
        raise ValueError("sr_attention needs at least one key")


def _check_kernel_inputs(name: str, tensors, num_heads: int,
                         smem: int) -> None:
    """Raise for what a kernel does not take: the dtype, the head width,
    the device, the layout, and a block's shared memory beyond the card's
    (no kernel's grows with Nk)."""
    q = tensors[0][1]
    nk = tensors[1][1].shape[1]
    d = q.shape[2] // num_heads
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for _, t in tensors):
        raise ValueError(f"{name} kernel takes float32 or bfloat16 inputs of "
                         f"one dtype, got "
                         f"{', '.join(str(t.dtype) for _, t in tensors)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head width {HEAD_DIMS}, "
                         f"got {d}")
    for tname, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{tname} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{tname} must be contiguous and 16-byte "
                             "aligned")
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name} kernel: Nk={nk} keys at head width {d} ({q.dtype}) "
            f"need {smem} bytes of shared memory per block, more than "
            f"{MAX_SMEM_BYTES}")


def f32_ctas_per_pair(b: int, nq: int, num_heads: int,
                      sms: int = H100_SMS) -> int:
    """CTAs per (batch, head) of the float32 forward and of the float32
    backward's row pass: each takes a contiguous run of the (batch, head)'s
    64-row query tiles, and as many as fill the SMs once (at least one,
    at most one per tile)."""
    tiles = -(-nq // F32_ROW_TILE)
    return max(1, min(tiles, sms // (b * num_heads)))


def _pass_plan(b: int, nq: int, nk: int, c: int, num_heads: int, sms: int,
               key_rows: int, kernels: tuple) -> dict:
    """A row pass / key pass / split sum launch: the row pass's CTAs per
    (batch, head) (`f32_ctas_per_pair`); the key pass's grid of (batch,
    head) x key group (two 64-key blocks, one per consumer) x split (a
    contiguous range of the pair's `key_rows`-row query tiles), with as
    many splits as fill the SMs once (at least one, at most one per tile);
    the float32 workspaces (row statistics; the splits' dk and dv slots,
    summed in split order by a third kernel where splits > 1) and the
    kernels one call launches (`kernels`: row pass, key pass, sum)."""
    pairs = b * num_heads
    key_blocks = -(-nk // F32_KEY_BLOCK)
    groups = -(-key_blocks // 2)
    q_tiles = -(-nq // key_rows)
    splits = max(1, min(q_tiles, sms // (pairs * groups)))
    cpp = f32_ctas_per_pair(b, nq, num_heads, sms)
    return {"row_ctas_per_pair": cpp, "row_grid": pairs * cpp,
            "key_blocks": key_blocks, "key_groups": groups,
            "q_tiles": q_tiles, "splits": splits,
            "key_grid": pairs * groups * splits,
            "stats_floats": pairs * nq * 4,
            "workspace_floats": splits * 2 * b * nk * c if splits > 1 else 0,
            "kernels": kernels[:2] + (kernels[2:] if splits > 1 else ())}


@functools.lru_cache(maxsize=None)
def bwd_f32_plan(b: int, nq: int, nk: int, c: int, num_heads: int,
                 sms: int = H100_SMS) -> dict:
    """The float32 backward's launch (`sr_attention_bwd` in
    `csrc/sr_attention_bwd.cu`), which takes it as given: `_pass_plan` over
    32-row key-pass query tiles. Cached per shape; callers do not modify
    the dict."""
    return _pass_plan(b, nq, nk, c, num_heads, sms, F32_KEY_PASS_ROWS,
                      ("sr_attention_bwd_f32_rows_kernel",
                       "sr_attention_bwd_f32_keys_kernel",
                       "sr_attention_bwd_f32_sum_kernel"))


def bwd_f32_key_work(plan: dict, pairs: int):
    """The key pass's work, CTA by CTA in launch order, as the kernel
    reads it from the plan: (pair, key block, first and last query tile)
    for each consumer that holds a key block."""
    groups, splits, tiles = plan["key_groups"], plan["splits"], \
        plan["q_tiles"]
    work = []
    for x in range(pairs * groups * splits):
        split, grp = x % splits, (x // splits) % groups
        pair = x // (splits * groups)
        first, end = split * tiles // splits, (split + 1) * tiles // splits
        for kb in (2 * grp, 2 * grp + 1):
            if kb < plan["key_blocks"]:
                work.append((pair, kb, first, end - 1))
    return work


@functools.lru_cache(maxsize=None)
def bwd_launch_plan(b: int, nq: int, nk: int, c: int, num_heads: int,
                    sms: int = H100_SMS) -> dict:
    """The bfloat16 backward's launch (`sr_attention_bwd_wgmma` in
    `csrc/sr_attention_bwd.cu`): its grid, the query-tile range of each CTA,
    whether a (batch, head) is split over CTAs, the float32 workspace and
    the kernels one call launches.

    The kernel walks the T = B * heads * ceil(Nq / 64) query tiles in
    (batch, head, tile) order; CTA x takes tiles [x T / G, (x + 1) T / G).
    Where cutting the (batch, head)s over CTAs shortens the longest CTA
    (MiT-B5 at batch 16: 16 pairs of 256 tiles at stage 1, 80 of 16 at
    stage 3) G = min(T, sms), so every SM gets work and a (batch, head)
    spans several CTAs; else (stage 4: 128 pairs of 4 tiles, which 132 CTAs
    would also leave at 4 tiles the longest) G = B * heads, one (batch,
    head) a CTA, in waves where there are more of them than SMs.
    Where a CTA range cuts a (batch, head), each CTA writes float32 dk and
    dv of its part to its own slot (two per CTA: its first and last
    segment, nk * d values each for dk and dv) and a second kernel sums a
    (batch, head)'s slots in CTA order; else the one kernel writes dk and
    dv. The launcher takes the plan's grid and launches that second kernel
    where the plan gives it a workspace: this function is the one place
    that decides both. Cached per shape (a training step asks for the same
    few shapes every step); callers do not modify the dict.

    Past `BF16_ON_CHIP_NK` keys (`"stream": True`) the call runs the
    streaming kernels (`sr_attention_bwd_stream`) over `_stream_bwd_plan`'s
    grids."""
    if nk > BF16_ON_CHIP_NK:
        return _stream_bwd_plan(b, nq, nk, c, num_heads, sms)
    tiles = -(-nq // BWD_WGMMA_ROW_TILE)
    pairs = b * num_heads
    total = pairs * tiles
    grid = min(total, sms)
    if -(-pairs // sms) * tiles <= -(-total // grid):
        grid = pairs
    bounds = [x * total // grid for x in range(grid + 1)]
    split = any(x % tiles for x in bounds[1:-1])
    return {"stream": False, "grid": grid, "tiles_per_pair": tiles,
            "tiles": total,
            "cta_tiles": [e - s for s, e in zip(bounds, bounds[1:])],
            "split": split,
            "workspace_floats": grid * 2 * 2 * nk * (c // num_heads)
            if split else 0,
            "kernels": ("sr_attention_bwd_wgmma_kernel",)
            + (("sr_attention_bwd_split_sum_kernel",) if split else ())}


def _ranges(total: int, grid: int, granule: int = 1):
    """CTA x of `grid` takes work items [x total / grid, (x + 1) total /
    grid), counted in granules of `granule` items: the bounds, grid + 1 of
    them."""
    return [x * (total // granule) // grid * granule
            for x in range(grid + 1)]


@functools.lru_cache(maxsize=None)
def fwd_stream_plan(b: int, nq: int, nk: int, c: int, num_heads: int,
                    sms: int = H100_SMS) -> dict:
    """The launch of K1's bfloat16 streaming kernel past
    `BF16_ON_CHIP_NK` keys (`sr_attention_fwd_stream`), which K2's row
    pass shares: persistent CTAs over the T = B * heads * ceil(Nq / 64)
    query tiles in (batch, head, tile) order, G = min(T, sms), CTA x
    taking [x T / G, (x + 1) T / G), so every SM works and no CTA holds
    more than one tile over another (a (batch, head) may span CTAs: each
    loads its K and V); and K1's kernel: up to `FWD_SPLIT_NK` keys the
    split kernel (one sweep, the score row split over the two consumers,
    K and V whole in shared memory), past them the two-sweep kernel (K and
    V streamed). Cached per shape; callers do not modify the dict."""
    tiles = -(-nq // BWD_WGMMA_ROW_TILE)
    total = b * num_heads * tiles
    grid = min(total, sms)
    bounds = _ranges(total, grid)
    split = nk <= FWD_SPLIT_NK
    return {"grid": grid, "tiles_per_pair": tiles, "tiles": total,
            "cta_tiles": [e - s for s, e in zip(bounds, bounds[1:])],
            "split": split,
            "kernel": FWD_SPLIT_KERNEL if split else FWD_STREAM_KERNEL}


def stream_segments(total: int, grid: int, per: int, granule: int = 1):
    """CTA by CTA, the segments of a persistent grid of `grid` CTAs over
    `total` work items in units of `per` consecutive items (a (batch,
    head)'s query tiles, or a key pass's (batch, head, key group)'s), the
    CTA ranges cut at multiples of `granule`: a list per CTA of (unit,
    first, last) with first and last the unit's items (0-based) the segment
    holds."""
    bounds = _ranges(total, grid, granule)
    out = []
    for s, e in zip(bounds, bounds[1:]):
        segs, u = [], s
        while u < e:
            unit = u // per
            end = min(e, (unit + 1) * per)
            segs.append((unit, u - unit * per, end - 1 - unit * per))
            u = end
        out.append(segs)
    return out


def _stream_bwd_plan(b: int, nq: int, nk: int, c: int, num_heads: int,
                     sms: int) -> dict:
    """K2's bfloat16 streaming launch: the row pass over
    `fwd_stream_plan`'s grid (up to `BWD_SPLIT_ROWS_NK` keys its split
    kernel: one sweep, the score row split over the two consumers; past
    them two sweeps); the key pass over the W = B * heads * key
    groups * q tiles units of work in (batch, head, key group, tile) order
    (a key group is two 64-key M-tiles, one per consumer), G = min(W, sms)
    persistent CTAs each taking a contiguous, equal range (of whole key
    groups where that leaves the longest CTA within 1.1x the mean, as at
    MiT-B5's stages 3 and 4 at batch 16: then no group spans two CTAs and
    the split sum does not run). Where a CTA boundary cuts a (batch, head,
    key group) its CTAs write float32 dk and dv to their slots (two per
    CTA: its first and last segment) and the split sum adds a group's slots
    in CTA order. `splits` is the most CTAs a key group spans."""
    rows = fwd_stream_plan(b, nq, nk, c, num_heads, sms)
    tiles = rows["tiles_per_pair"]
    key_blocks = -(-nk // F32_KEY_BLOCK)
    groups = -(-key_blocks // 2)
    units = b * num_heads * groups
    key_total = units * tiles
    key_grid = min(key_total, sms)
    granule = tiles if (units >= key_grid and 10 * -(-units // key_grid)
                        * tiles * key_grid <= 11 * key_total) else 1
    spans = [0] * units
    for segs in stream_segments(key_total, key_grid, tiles, granule):
        for unit, _, _ in segs:
            spans[unit] += 1
    split = max(spans) > 1
    split_rows = nk <= BWD_SPLIT_ROWS_NK
    return {"stream": True, "row_grid": rows["grid"],
            "split_rows": split_rows, "q_tiles": tiles,
            "key_blocks": key_blocks, "key_groups": groups,
            "key_total": key_total, "key_grid": key_grid,
            "key_granule": granule,
            "splits": max(spans),
            "stats_floats": b * num_heads * nq * 4,
            "workspace_floats": (key_grid * 2 * 2 * STREAM_UNIT_KEYS
                                 * (c // num_heads) if split else 0),
            "kernels": ("sr_attention_bwd_wgmma_split_rows_kernel"
                        if split_rows else
                        "sr_attention_bwd_wgmma_rows_kernel",
                        "sr_attention_bwd_wgmma_keys_kernel")
            + (("sr_attention_bwd_split_sum_kernel",) if split else ())}


def stream_key_work(plan: dict):
    """The streaming key pass's work, CTA by CTA in launch order, as the
    kernel walks it: (pair, key block, first and last query tile) for each
    consumer that holds a key block, per segment."""
    groups, tiles = plan["key_groups"], plan["q_tiles"]
    work = []
    for segs in stream_segments(plan["key_total"], plan["key_grid"], tiles,
                                plan["key_granule"]):
        for unit, first, last in segs:
            pair, grp = divmod(unit, groups)
            for kb in (2 * grp, 2 * grp + 1):
                if kb < plan["key_blocks"]:
                    work.append((pair, kb, first, last))
    return work


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sr_attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_heads: int) -> torch.Tensor:
    """The forward operator's body: the plain version on a CPU tensor, else
    one launch of `csrc/sr_attention_fwd.cu`'s kernel for q's dtype and Nk
    (counted in `sr_attention.launches`, the bfloat16 kernel's also in
    `sr_attention.mma_launches`)."""
    if _device_of(q) == "cpu":
        return sr_attention_reference(q, k, v, num_heads)
    b, nq, c = q.shape
    nk = k.shape[1]
    lib = _lib()
    _check_kernel_inputs(
        "sr_attention", (("q", q), ("k", k), ("v", v)), num_heads,
        _fwd_limits(nk, c // num_heads, q.element_size()))
    bf16 = q.dtype == torch.bfloat16
    on_chip = bf16 and not streams_bf16(q.dtype, nk)
    out = torch.empty_like(q)
    if bf16 and not on_chip:
        plan = fwd_stream_plan(b, nq, nk, c, num_heads,
                               _sm_count(q.device.index))
        err = _launch(lib.sr_attention_fwd_stream, q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk,
                      c, num_heads, plan["grid"], int(plan["split"]))
    else:
        cpp = 0 if on_chip else f32_ctas_per_pair(
            b, nq, num_heads, _sm_count(q.device.index))
        err = _launch(lib.sr_attention_fwd, q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, nk,
                      c, num_heads, _DTYPES[q.dtype], cpp)
    if err:
        raise RuntimeError(
            f"sr_attention_fwd launch failed: "
            f"{lib.sr_attention_fwd_error_string(err).decode()} "
            f"(B={b}, Nq={nq}, Nk={nk}, C={c}, heads={num_heads}, "
            f"{q.dtype})")
    sr_attention.launches += 1
    sr_attention.mma_launches += bf16
    sr_attention.stream_launches += bf16 and not on_chip
    return out


def sr_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, num_heads: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `sr_attention` at (q, k, v) for the output gradient
    g (B,Nq,C), through the operator `ssod::sr_attention_bwd`.

    Replaces the Pallas TPU kernel
    `semisupervisedobjectdetection_tpu/ops/sr_attention.py::_bwd_kernel`.
    On a CUDA tensor it launches `csrc/sr_attention_bwd.cu`'s kernels for
    q's dtype and Nk (float32 or bfloat16, head width 32 or 64, any Nk) or
    raises; on a CPU tensor it computes `sr_attention_backward_reference`.

    What bounds it on the H100: 10*B*Nq*Nk*C flops (five products) against
    q, g, dq (B*Nq*C each) and k, v, dk, dv (B*Nk*C each) moved once puts it
    under the flops line at MiT-B5 stages 1-3. Every product runs on wgmma
    with tiles brought in by TMA. bfloat16 up to `BF16_ON_CHIP_NK` keys
    runs one kernel: the row statistics on chip, dk and dv in registers
    across each CTA's run of query tiles, over the grid of
    `bwd_launch_plan`; where that grid splits a (batch, head) over CTAs, a
    second kernel sums their float32 parts in CTA order. Past them a row
    pass (row statistics to a float32 workspace, dq; K and V streamed) and
    a key pass (dk and dv per 64-key M-tile over runs of query tiles) run
    over grids of one CTA an SM (`bwd_launch_plan`'s stream plan), with
    the split sum where a key group spans CTAs. float32 splits each
    product three ways on the TF32 tensor
    cores (3xTF32: hi = tf32(x), lo = tf32(x - hi), a b = a_lo b_hi +
    a_hi b_lo + a_hi b_hi, within ~1e-6 of float64; at most 495 / 3 = 165
    TFLOP/s) and streams K and V in blocks, over the grids of
    `bwd_f32_plan`: a row pass (row statistics and dq), a key pass (dk and
    dv, keys as the product's rows, over split ranges of query tiles) and,
    where there are splits, their sum in split order. No atomics: the
    result is the same every run.

    `sr_attention_bwd.launches` counts calls that launched the kernels (not
    CPU calls), `sr_attention_bwd.stream_launches` those of the bfloat16
    streaming kernels; `sr_attention_bwd.last_launches` is the number of
    kernels the last such call launched, as its C launcher counted them.
    """
    _check(q, k, v, num_heads)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    return _bwd_op(q, k, v, g, num_heads)


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, num_heads: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward operator's body: the plain version on a CPU tensor,
    else the launch of `csrc/sr_attention_bwd.cu`'s kernels for q's dtype
    and Nk (counted in `sr_attention_bwd.launches`)."""
    if _device_of(q) == "cpu":
        return sr_attention_backward_reference(q, k, v, g, num_heads)
    b, nq, c = q.shape
    nk = k.shape[1]
    lib = _bwd_lib()
    _check_kernel_inputs(
        "sr_attention_bwd", (("q", q), ("k", k), ("v", v), ("g", g)),
        num_heads, _bwd_limits(nk, c // num_heads, q.element_size()))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    launched = ctypes.c_int(0)
    sms = _sm_count(q.device.index)
    if q.dtype == torch.bfloat16 and not streams_bf16(q.dtype, nk):
        plan = bwd_launch_plan(b, nq, nk, c, num_heads, sms)
        part = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                           device=q.device)
        err = _launch(lib.sr_attention_bwd_wgmma, q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(),
                      part.data_ptr() if plan["split"] else None, b, nq, nk,
                      c, num_heads, plan["grid"], ctypes.byref(launched))
    else:
        if q.dtype == torch.bfloat16:
            plan = bwd_launch_plan(b, nq, nk, c, num_heads, sms)
            fn = lib.sr_attention_bwd_stream
            grids = (plan["row_grid"], int(plan["split_rows"]),
                     plan["key_grid"], plan["key_granule"])
        else:
            plan = bwd_f32_plan(b, nq, nk, c, num_heads, sms)
            fn = lib.sr_attention_bwd
            grids = (plan["row_ctas_per_pair"], plan["key_groups"],
                     plan["splits"])
        stats = torch.empty(plan["stats_floats"], dtype=torch.float32,
                            device=q.device)
        part = torch.empty(plan["workspace_floats"], dtype=torch.float32,
                           device=q.device)
        err = _launch(fn, q.device, q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                      part.data_ptr() if plan["splits"] > 1 else None, b, nq,
                      nk, c, num_heads, *grids, ctypes.byref(launched))
    if err:
        raise RuntimeError(
            f"sr_attention_bwd launch failed: "
            f"{lib.sr_attention_bwd_error_string(err).decode()} "
            f"(B={b}, Nq={nq}, Nk={nk}, C={c}, heads={num_heads}, "
            f"{q.dtype})")
    sr_attention_bwd.launches += 1
    sr_attention_bwd.stream_launches += streams_bf16(q.dtype, nk)
    sr_attention_bwd.last_launches = launched.value
    return dq, dk, dv


sr_attention_bwd.launches = 0
sr_attention_bwd.stream_launches = 0
sr_attention_bwd.last_launches = 0


# The operators are defined through `torch.library.Library` with a kernel per
# dispatch key, so an eager call goes from the C++ dispatcher straight to the
# Python body; `torch.library.custom_op` wraps the same bodies in more Python
# per call (PERF.md, `scripts/op_dispatch_ab.py`).
_LIB = torch.library.Library("ssod", "DEF")
_LIB.define("sr_attention_fwd(Tensor q, Tensor k, Tensor v, int num_heads)"
            " -> Tensor")
_LIB.define("sr_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor g, "
            "int num_heads) -> (Tensor, Tensor, Tensor)")


def _fwd_body(q, k, v, num_heads):
    """The forward operator's CPU and CUDA kernel (K1): `_forward`, looked
    up at each call."""
    return _forward(q, k, v, num_heads)


def _bwd_body(q, k, v, g, num_heads):
    """The backward operator's CPU and CUDA kernel (K2): `_backward`,
    looked up at each call."""
    return _backward(q, k, v, g, num_heads)


for _key in ("CPU", "CUDA"):
    _LIB.impl("sr_attention_fwd", _fwd_body, _key)
    _LIB.impl("sr_attention_bwd", _bwd_body, _key)


@torch.library.register_fake("ssod::sr_attention_fwd", lib=_LIB)
def _(q, k, v, num_heads):
    return torch.empty_like(q)


@torch.library.register_fake("ssod::sr_attention_bwd", lib=_LIB)
def _(q, k, v, g, num_heads):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_fwd_op = torch.ops.ssod.sr_attention_fwd.default
_bwd_op = torch.ops.ssod.sr_attention_bwd.default


class _SRAttentionGrad(torch.autograd.Function):
    """The forward operator's gradient: the backward operator, which
    recomputes the probabilities from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        with torch._C._AutoDispatchBelowAutograd():
            return _fwd_op(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return _bwd_op(q, k, v, g.contiguous(), ctx.num_heads) + (None,)


def _fwd_autograd(q, k, v, num_heads):
    """The forward operator's autograd kernel: through `_SRAttentionGrad`
    where a gradient is wanted, else straight to the device's kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _SRAttentionGrad.apply(q, k, v, num_heads)
    with torch._C._AutoDispatchBelowAutograd():
        return _fwd_op(q, k, v, num_heads)


_LIB.impl("sr_attention_fwd", _fwd_autograd, "Autograd")


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """SR attention q (B,Nq,C) x k,v (B,Nk,C) -> (B,Nq,C) over `num_heads`
    heads of width C/num_heads, differentiable in q, k and v.

    Replaces the Pallas TPU kernel
    `semisupervisedobjectdetection_tpu/ops/sr_attention.py::_attn_kernel`.
    On a CUDA tensor it launches `csrc/sr_attention_fwd.cu`'s kernel for
    q's dtype (head width 32 or 64) or raises; on a CPU tensor it computes
    the plain version. It calls the operator `ssod::sr_attention_fwd`,
    whose gradient is `sr_attention_bwd`'s operator. Both kernels run
    their products on wgmma with the query tiles, K and V brought in by
    TMA, and sum in the tensor cores' order:

    - bfloat16: all of a (batch, head)'s K and V on chip and one full-row
      softmax up to `BF16_ON_CHIP_NK` keys; up to `FWD_SPLIT_NK` the same
      one sweep with the score row split over the two consumer warpgroups;
      past that K and V stream in 128-key blocks in two sweeps (the row max
      and sum, then the normalised p rounded to bf16, the plain version's
      rounding point, and o += p v; `fwd_stream_plan` picks the kernel).
      A small share of its outputs differ from the plain version's by an
      ulp or two. The function moves
      2*B*(Nq+Nk)*C elements and does 4*B*Nq*Nk*C flops, ~250 flops a byte
      at Nk 256 and head width 64 against the card's ~295 for bf16, so at
      MiT-B5 512x512 it sits just under the bytes line.
    - float32: each product split three ways on the TF32 tensor cores
      (3xTF32: hi = tf32(x), lo = tf32(x - hi), a b = a_lo b_hi + a_hi b_lo
      + a_hi b_hi; the dropped a_lo b_lo is ~2^-22 of a b, so a product is
      within ~1e-6 of float64, far inside the float32 tolerance). Three
      TF32 products per float32 product bound it at 495 / 3 = 165 TFLOP/s,
      which puts MiT-B5's float32 shapes above the bytes line. K and V
      stream through shared memory in 32-key blocks with an online softmax,
      so it takes any Nk.

    `sr_attention.launches` counts forward kernel launches (not CPU calls),
    `sr_attention.mma_launches` those of the bfloat16 kernels and
    `sr_attention.stream_launches` those of the bfloat16 kernels past
    `BF16_ON_CHIP_NK` keys.
    """
    _check(q, k, v, num_heads)
    return _fwd_op(q, k, v, num_heads)


sr_attention.launches = 0
sr_attention.mma_launches = 0
sr_attention.stream_launches = 0
