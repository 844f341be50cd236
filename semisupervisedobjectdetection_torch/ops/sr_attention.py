"""Sequence-reduction (SR) attention: the hand-written CUDA kernel and its
plain PyTorch version.

SegFormer's SR-attention has a long query stream (H*W tokens plus the
prompt/CLS prefix: 16k at stage 1 of a 512x512 input) attending to a short
reduced key/value stream (256 tokens plus the prefix at every stage of a
512x512 input). `sr_attention` runs `csrc/sr_attention_fwd.cu` on a CUDA
tensor and `sr_attention_reference` on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from semisupervisedobjectdetection_torch.ops import _build

_SOURCE = "sr_attention_fwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64)
BLOCK_Q = 128
# Opt-in shared memory a block may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


def sr_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int) -> torch.Tensor:
    """Plain version: q (B,Nq,C) x k,v (B,Nk,C) -> (B,Nq,C).

    Scores and softmax in float32, probabilities rounded to v's dtype
    before P.V, float32 accumulation, output in q's dtype - the arithmetic
    of the kernel and of the TPU kernel it replaces.
    """
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    qh = q.reshape(b, nq, num_heads, d).float()
    kh = k.reshape(b, nk, num_heads, d).float()
    vh = v.reshape(b, nk, num_heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(d))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p.float(), vh.float())
    return o.reshape(b, nq, c).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = _build.load_library(_SOURCE)
    lib.sr_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.sr_attention_fwd.restype = ctypes.c_int
    lib.sr_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.sr_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.sr_attention_fwd_max_nk.argtypes = []
    lib.sr_attention_fwd_max_nk.restype = ctypes.c_int
    lib.sr_attention_fwd_error_string.argtypes = [ctypes.c_int]
    lib.sr_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


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


def sr_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """SR attention q (B,Nq,C) x k,v (B,Nk,C) -> (B,Nq,C) over `num_heads`
    heads of width C/num_heads.

    Replaces the Pallas TPU kernel
    `semisupervisedobjectdetection_tpu/ops/sr_attention.py::_attn_kernel`.
    On a CUDA tensor it launches `csrc/sr_attention_fwd.cu` (float32 or
    bfloat16, head width 32 or 64, Nk up to what fits one block's shared
    memory) or raises; on a CPU tensor it computes the plain version.

    What bounds it on the H100: the function moves 2*B*(Nq+Nk)*C elements
    and does 4*B*Nq*Nk*C flops, which at MiT-B5 512x512 puts it under the
    bytes line on the bf16 tensor cores. The kernel keeps the whole score
    row on chip (K and V of one (batch, head) in shared memory, the row in
    registers), so only q, k, v and the output cross device memory; it
    does the products as scalar float32 FMAs, so today the FMA pipes and
    shared-memory reads bound it, not the bytes (see PERF.md).

    `sr_attention.launches` counts kernel launches (not CPU calls).
    """
    _check(q, k, v, num_heads)
    if q.device.type == "cpu":
        return sr_attention_reference(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"sr_attention runs on cuda or cpu, not {q.device}")
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // num_heads
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"sr_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"sr_attention kernel takes head width "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    lib = _lib()
    smem = lib.sr_attention_fwd_smem_bytes(nk, d, q.element_size())
    if nk > lib.sr_attention_fwd_max_nk() or smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"sr_attention kernel: Nk={nk} keys at head width {d} "
            f"({q.dtype}) need {smem} bytes of shared memory per block; the "
            f"kernel takes Nk <= {lib.sr_attention_fwd_max_nk()} within "
            f"{MAX_SMEM_BYTES} bytes")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.sr_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, nq, nk, c, num_heads, _DTYPES[q.dtype], BLOCK_Q, stream)
    if err:
        raise RuntimeError(
            f"sr_attention_fwd launch failed: "
            f"{lib.sr_attention_fwd_error_string(err).decode()} "
            f"(B={b}, Nq={nq}, Nk={nk}, C={c}, heads={num_heads}, "
            f"{q.dtype})")
    sr_attention.launches += 1
    return out


sr_attention.launches = 0
