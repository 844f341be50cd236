"""Sequence-reduction (SR) attention: the hand-written CUDA kernels and their
plain PyTorch versions.

SegFormer's SR-attention has a long query stream (H*W tokens plus the
prompt/CLS prefix: 16k at stage 1 of a 512x512 input) attending to a short
reduced key/value stream (256 tokens plus the prefix at every stage of a
512x512 input). `sr_attention` is differentiable through `SRAttention`, the
counterpart of the JAX package's `custom_vjp`: on a CUDA tensor its forward
runs `csrc/sr_attention_fwd.cu` and its backward `csrc/sr_attention_bwd.cu`
(`sr_attention_bwd`); on a CPU tensor both run the plain versions
(`sr_attention_reference`, `sr_attention_backward_reference`).
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
# The most keys either kernel takes (`kMaxSlots * 32` in both sources): one
# (batch, head)'s K and V sit on chip and the score row of a query tile sits
# in registers (the bf16 forward's 64-row tile: 18 tiles of 16 keys). Larger
# Nk needs a loop over K/V blocks (ROADMAP.md Queue 2).
MAX_NK = 288
# Query rows per block of the scalar kernels (the bf16 forward walks 64-row
# tiles over a persistent grid and takes no block size).
BLOCK_Q = 128
# The backward's key pass in float32 (scalar kernel): blocks of 32 keys per
# (batch, head), query rows in tiles of 32; its rows are split so that about
# this many blocks run (4 per SM on an H100).
BWD_KEYS_PER_BLOCK = 32
BWD_ROW_TILE = 32
BWD_TARGET_BLOCKS = 528
# In bfloat16 (tensor-core kernel): blocks of 4 warps over 64 keys, query
# rows in tiles of 64, about two blocks per SM.
BWD_MMA_KEYS_PER_BLOCK = 64
BWD_MMA_ROW_TILE = 64
BWD_MMA_TARGET_BLOCKS = 264
# Opt-in shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


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
    lib = _build.load_library(_SOURCE)
    lib.sr_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.sr_attention_fwd.restype = ctypes.c_int
    lib.sr_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sr_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.sr_attention_fwd_max_nk.argtypes = []
    lib.sr_attention_fwd_max_nk.restype = ctypes.c_int
    lib.sr_attention_fwd_wgmma_ctas_per_sm.argtypes = [ctypes.c_int] * 2
    lib.sr_attention_fwd_wgmma_ctas_per_sm.restype = ctypes.c_int
    lib.sr_attention_fwd_map_ns.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6)
    lib.sr_attention_fwd_map_ns.restype = ctypes.c_double
    lib.sr_attention_fwd_error_string.argtypes = [ctypes.c_int]
    lib.sr_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The built backward kernel library with its C signatures declared."""
    lib = _build.load_library(_BWD_SOURCE)
    lib.sr_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.sr_attention_bwd.restype = ctypes.c_int
    lib.sr_attention_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sr_attention_bwd_smem_bytes.restype = ctypes.c_size_t
    lib.sr_attention_bwd_max_nk.argtypes = []
    lib.sr_attention_bwd_max_nk.restype = ctypes.c_int
    lib.sr_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.sr_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _fwd_limits(nk: int, d: int, elem: int, mma: bool) -> Tuple[int, int]:
    """(shared-memory bytes per block, largest Nk) of a forward kernel."""
    lib = _lib()
    return (lib.sr_attention_fwd_smem_bytes(nk, d, elem, mma),
            lib.sr_attention_fwd_max_nk())


@functools.lru_cache(maxsize=None)
def _bwd_limits(nk: int, d: int, elem: int) -> Tuple[int, int]:
    """(shared-memory bytes per row-pass block, largest Nk) of the
    backward kernels."""
    lib = _bwd_lib()
    return (lib.sr_attention_bwd_smem_bytes(nk, d, elem),
            lib.sr_attention_bwd_max_nk())


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


def _check_kernel_inputs(name: str, tensors, num_heads: int, smem: int,
                         max_nk: int) -> None:
    """Raise for what a kernel does not take: the dtype, the head width,
    the device, the layout, and Nk beyond the shared memory of a block."""
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
    if nk > max_nk or smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name} kernel: Nk={nk} keys at head width {d} ({q.dtype}) "
            f"need {smem} bytes of shared memory per block; the kernel "
            f"takes Nk <= {max_nk} within {MAX_SMEM_BYTES} bytes")


def bwd_key_splits(b: int, nq: int, nk: int, num_heads: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """How many splits of the query rows the backward's key pass takes:
    enough that key blocks * B * heads * splits blocks fill the card, each
    split at least one row tile. float32 (the scalar kernel): 32-key blocks,
    32-row tiles, ~528 blocks (stage 1 of MiT-B5 at batch 16: 8 * 16
    blocks, 5 splits). bfloat16 (the tensor-core kernel): 64-key blocks,
    64-row tiles, ~264 blocks (stage 1: 4 * 16 blocks, 5 splits; stage 3:
    4 * 80 blocks, no split)."""
    keys, tile, target = (
        (BWD_MMA_KEYS_PER_BLOCK, BWD_MMA_ROW_TILE, BWD_MMA_TARGET_BLOCKS)
        if dtype == torch.bfloat16 else
        (BWD_KEYS_PER_BLOCK, BWD_ROW_TILE, BWD_TARGET_BLOCKS))
    blocks = -(-nk // keys) * b * num_heads
    want = -(-target // blocks)
    rows = -(-(-(-nq // want)) // tile) * tile
    return -(-nq // rows)


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sr_attention runs on cuda or cpu, not {q.device}")
    return q.device.type


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             num_heads: int, mma: bool) -> torch.Tensor:
    """The forward: the plain version on a CPU tensor, else one launch of
    `csrc/sr_attention_fwd.cu`, its wgmma + TMA kernel for bfloat16 with
    `mma` (counted in `sr_attention.launches`, and the wgmma ones also in
    `sr_attention.mma_launches`)."""
    if _device_of(q) == "cpu":
        return sr_attention_reference(q, k, v, num_heads)
    b, nq, c = q.shape
    nk = k.shape[1]
    mma = mma and q.dtype == torch.bfloat16
    lib = _lib()
    _check_kernel_inputs(
        "sr_attention", (("q", q), ("k", k), ("v", v)), num_heads,
        *_fwd_limits(nk, c // num_heads, q.element_size(), mma))
    out = torch.empty_like(q)
    err = _launch(lib.sr_attention_fwd, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, nq, nk, c, num_heads,
                  _DTYPES[q.dtype], BLOCK_Q, mma)
    if err:
        raise RuntimeError(
            f"sr_attention_fwd launch failed: "
            f"{lib.sr_attention_fwd_error_string(err).decode()} "
            f"(B={b}, Nq={nq}, Nk={nk}, C={c}, heads={num_heads}, "
            f"{q.dtype})")
    sr_attention.launches += 1
    sr_attention.mma_launches += mma
    return out


def sr_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, num_heads: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `sr_attention` at (q, k, v) for the output gradient
    g (B,Nq,C).

    Replaces the Pallas TPU kernel
    `semisupervisedobjectdetection_tpu/ops/sr_attention.py::_bwd_kernel`.
    On a CUDA tensor it launches `csrc/sr_attention_bwd.cu` (float32 or
    bfloat16, head width 32 or 64, Nk up to 288) or raises; on a CPU tensor
    it computes `sr_attention_backward_reference`.

    What bounds it on the H100: 10*B*Nq*Nk*C flops (five products) against
    q, g, dq (B*Nq*C each) and k, v, dk, dv (B*Nk*C each) moved once puts it
    under the flops line on the bf16 tensor cores at MiT-B5 stages 1-3. The
    kernel is a row pass (dq and the row statistics, K and V of one (batch,
    head) in shared memory) and a key pass (dk and dv summed in registers
    over the query rows in order, in `bwd_key_splits` splits whose float32
    partials a third kernel sums in order: no atomics, so the result is the
    same every run). In bfloat16 both passes do their products on the
    tensor cores (mma.sync); in float32 they are scalar FMAs, because TF32
    would not hold float32 results to their tolerance (see PERF.md).

    `sr_attention_bwd.launches` counts kernel launches (not CPU calls).
    """
    _check(q, k, v, num_heads)
    if g.shape != q.shape:
        raise ValueError(f"g {tuple(g.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if _device_of(q) == "cpu":
        return sr_attention_backward_reference(q, k, v, g, num_heads)
    b, nq, c = q.shape
    nk = k.shape[1]
    lib = _bwd_lib()
    _check_kernel_inputs(
        "sr_attention_bwd", (("q", q), ("k", k), ("v", v), ("g", g)),
        num_heads, *_bwd_limits(nk, c // num_heads, q.element_size()))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    # per query row: max, l and rowsum(dp * p) (the float32 kernels use 3
    # of the 4 values, the bfloat16 ones store 1 / l as one float4)
    stats = torch.empty(b * num_heads * nq * 4, dtype=torch.float32,
                        device=q.device)
    splits = bwd_key_splits(b, nq, nk, num_heads, q.dtype)
    part = torch.empty(splits * 2 * k.numel() if splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    err = _launch(lib.sr_attention_bwd, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), stats.data_ptr(),
                  part.data_ptr() if splits > 1 else None, b, nq, nk, c,
                  num_heads, _DTYPES[q.dtype], BLOCK_Q, splits)
    if err:
        raise RuntimeError(
            f"sr_attention_bwd launch failed: "
            f"{lib.sr_attention_bwd_error_string(err).decode()} "
            f"(B={b}, Nq={nq}, Nk={nk}, C={c}, heads={num_heads}, "
            f"{q.dtype})")
    sr_attention_bwd.launches += 1
    return dq, dk, dv


sr_attention_bwd.launches = 0


class SRAttention(torch.autograd.Function):
    """SR attention with its own backward, the counterpart of the JAX
    package's `custom_vjp` (`sr_attention.py:235-250`): the forward saves
    q, k, v; the backward recomputes the probabilities in
    `sr_attention_bwd`. On CUDA both directions run the hand-written
    kernels, on the CPU the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, mma: bool = True):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, num_heads, mma)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = sr_attention_bwd(q, k, v, g.contiguous(),
                                      ctx.num_heads)
        return dq, dk, dv, None, None


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int, mma: bool = True) -> torch.Tensor:
    """SR attention q (B,Nq,C) x k,v (B,Nk,C) -> (B,Nq,C) over `num_heads`
    heads of width C/num_heads, differentiable in q, k and v.

    Replaces the Pallas TPU kernel
    `semisupervisedobjectdetection_tpu/ops/sr_attention.py::_attn_kernel`.
    On a CUDA tensor it launches `csrc/sr_attention_fwd.cu` (float32 or
    bfloat16, head width 32 or 64, Nk up to 288) or raises; on a CPU tensor
    it computes the plain version. Its gradient is `sr_attention_bwd`.

    bfloat16 has two kernels: by default (`mma=True`) the Hopper one, on
    wgmma with K, V and the query tiles brought in by TMA, whose sums run in
    the tensor cores' order, so that a small share of its outputs differ
    from the plain version's by an ulp or two; with `mma=False` the scalar
    one, whose results equal the plain version's bit for bit. Every bf16
    path of the package, serving included, takes the Hopper kernel. float32
    always runs the scalar kernel.

    What bounds it on the H100: the function moves 2*B*(Nq+Nk)*C elements
    and does 4*B*Nq*Nk*C flops, ~250 flops a byte at Nk 256 and head width
    64 against the card's ~295 for bf16, so at MiT-B5 512x512 it sits just
    under the bytes line. The kernel keeps the whole score row on chip (K
    and V of one (batch, head) in shared memory for many 64-row query tiles,
    the row in registers), so only q, k, v and the output cross device
    memory; its products run on wgmma and the query tiles stream in by TMA
    while the products run. The scalar kernel does its products as float32
    FMAs, which then bound it (see PERF.md).

    `sr_attention.launches` counts forward kernel launches (not CPU calls),
    `sr_attention.mma_launches` those of the wgmma kernel.
    """
    _check(q, k, v, num_heads)
    return SRAttention.apply(q, k, v, num_heads, mma)


sr_attention.launches = 0
sr_attention.mma_launches = 0
