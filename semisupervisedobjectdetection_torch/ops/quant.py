"""Low-precision serving: int8 and fp8 (e4m3) weight quantization and the
dynamic-activation products of the SegFormer dense layers, the JAX
package's `ops/quant.py` in PyTorch.

The dense kernels (q/k/v and the attention output, MixFFN dense1/dense2,
the decode head's linear_c and cls_proj) are quantized per output channel;
activations are quantized per token at run time. Convs, the 1x1
`linear_fuse` and the classifier stay in the compute dtype.

The arithmetic is the JAX package's, step for step, so that int8 weights,
scales and products are bit-equal to it: quantization runs in float32 with
the scale `max(amax, 1e-8) / 127` (or `/ 448`), `torch.round` rounds half
to even as `jnp.round` does, values are clipped before the cast, and the
product dequantizes as `acc.float() * xscale * wscale`, after which the
float32 bias is added and the result is cast to the layer's dtype.

On a CUDA tensor the products run on the card's library GEMMs:
`torch._int_mm` (int8 x int8 -> int32) and `torch._scaled_mm` (e4m3 x e4m3
-> float32, unit scales, full-precision accumulation). Rows, inner and
outer widths are zero-padded to what those calls take (exact: a zero row
or column adds nothing); anything else they refuse raises. On a CPU tensor
each product runs its plain version: an exact integer product (int8, in
float64, where every partial sum is an integer below 2**53) or a float32
product of the upcast e4m3 values (fp8).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

KINDS = ("int8", "fp8")
INT8_MAX = 127.0
# float8_e4m3fn's largest finite value; the scale maps each channel's or
# token's abs-max onto it, as int8's maps it onto 127.
FP8_MAX = 448.0
FP8 = torch.float8_e4m3fn
WEIGHT_DTYPES = {"int8": torch.int8, "fp8": FP8}


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of a torch (out, in)
    weight: (int8 weight, float32 scale per output channel)."""
    w32 = w.float()
    scale = w32.abs().amax(dim=1).clamp_min(1e-8) / INT8_MAX
    q = torch.round(w32 / scale[:, None]).clamp(-INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def quantize_weight_fp8(w: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric e4m3 quantization of a torch (out, in)
    weight: (float8_e4m3fn weight, float32 scale per output channel). The
    cast rounds to nearest even; only the clip is explicit."""
    w32 = w.float()
    scale = w32.abs().amax(dim=1).clamp_min(1e-8) / FP8_MAX
    q = (w32 / scale[:, None]).clamp(-FP8_MAX, FP8_MAX)
    return q.to(FP8), scale


def _scale_tokens(x: torch.Tensor, qmax: float):
    """(x / xscale, xscale) per token (last axis) in float32, the scale a
    (..., 1) column mapping each token's abs-max onto `qmax`."""
    x32 = x.float()
    xscale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / qmax
    return x32 / xscale, xscale


def _pad2(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """`t` (r, c) zero-padded to (rows, cols); itself when no padding."""
    r, c = t.shape
    if (r, c) == (rows, cols):
        return t
    return F.pad(t, (0, cols - c, 0, rows - r))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_inner(xq: torch.Tensor, wq: torch.Tensor) -> None:
    if xq.shape[1] != wq.shape[1]:
        raise ValueError(f"inner widths differ: x {tuple(xq.shape)}, "
                         f"w {tuple(wq.shape)}")


def int8_mm_card(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 (M, N) = xq (M, K) @ wq (N, K)^T by `torch._int_mm` on the
    card. It takes more than 16 rows and K, N in multiples of 8: rows are
    padded to 32 when there are fewer, K and N to the next multiple of 8,
    all with zeros, and the result sliced back."""
    _check_inner(xq, wq)
    m, k = xq.shape
    n = wq.shape[0]
    mp = max(m, 32) if m <= 16 else m
    kp, np_ = _round_up(k, 8), _round_up(n, 8)
    acc = torch._int_mm(_pad2(xq, mp, kp), _pad2(wq, np_, kp).t())
    return acc[:m, :n]


def fp8_mm_card(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """float32 (M, N) = xq (M, K) @ wq (N, K)^T by `torch._scaled_mm` on
    the card, with unit tensor-wise scales (the dequantization follows in
    float32, in the JAX package's order) and `use_fast_accum=False` (the
    fp8 tensor cores' shortened accumulator would drift over K = 2048).
    M, K and N are zero-padded to multiples of 16; the second operand is
    the column-major view of the (N, K) weight, as the call requires."""
    _check_inner(xq, wq)
    m, k = xq.shape
    n = wq.shape[0]
    mp, kp, np_ = (_round_up(v, 16) for v in (m, k, n))
    one = torch.ones((), dtype=torch.float32, device=xq.device)
    out = torch._scaled_mm(_pad2(xq, mp, kp), _pad2(wq, np_, kp).t(),
                           scale_a=one, scale_b=one,
                           out_dtype=torch.float32, use_fast_accum=False)
    if isinstance(out, tuple):   # older releases also return the amax
        out = out[0]
    return out[:m, :n]


def int8_mm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact integer product of `int8_mm_card`, on any device: int8
    values summed in float64 (each product at most 127**2, so every partial
    sum up to K = 2**38 is an exact integer), returned as int32."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def fp8_mm_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """`fp8_mm_card`'s product in float32 of the upcast e4m3 values (each
    product of two e4m3 values is exact in float32; the sums round)."""
    return xq.float() @ wq.float().t()


_CARD = {"int8": int8_mm_card, "fp8": fp8_mm_card}
_PLAIN = {"int8": int8_mm_plain, "fp8": fp8_mm_plain}


def _mm(kind: str, xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The card's GEMM on a CUDA tensor, the plain product on a CPU one."""
    if xq.device.type == "cpu":
        return _PLAIN[kind](xq, wq)
    if xq.device.type != "cuda":
        raise RuntimeError(f"quantized products run on cuda or cpu, not "
                           f"{xq.device}")
    return _CARD[kind](xq, wq)


def _quantize_tokens(kind: str, x: torch.Tensor):
    """(xq, xscale): `x` quantized per token, int8 rounded half to even and
    clipped to +-127, or e4m3 clipped to +-448 and cast (round to nearest
    even)."""
    if kind == "int8":
        xf, xscale = _scale_tokens(x, INT8_MAX)
        return (torch.round(xf).clamp(-INT8_MAX, INT8_MAX).to(torch.int8),
                xscale)
    xf, xscale = _scale_tokens(x, FP8_MAX)
    return xf.clamp(-FP8_MAX, FP8_MAX).to(FP8), xscale


def _dynamic_matmul(kind: str, x: torch.Tensor, wq: torch.Tensor,
                    wscale: torch.Tensor, mm) -> torch.Tensor:
    """x (..., in) quantized per token, `mm` of it against the (out, in)
    weight, dequantized as `acc * xscale[token] * wscale[channel]` in
    float32: (..., out)."""
    xq, xscale = _quantize_tokens(kind, x)
    acc = mm(xq.reshape(-1, xq.shape[-1]), wq)
    acc = acc.reshape(*x.shape[:-1], wq.shape[0])
    return acc.float() * xscale * wscale


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                wscale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation int8 product: x (..., in) against an int8 (out,
    in) weight with per-output-channel scales, float32 (..., out). The
    activations are quantized per token (one outlier token does not coarsen
    the others), accumulated in int32 and dequantized as
    `acc * xscale[token] * wscale[channel]`."""
    return _dynamic_matmul("int8", x, wq, wscale, partial(_mm, "int8"))


def fp8_matmul(x: torch.Tensor, wq: torch.Tensor,
               wscale: torch.Tensor) -> torch.Tensor:
    """Dynamic-activation e4m3 product, as `int8_matmul` with the per-token
    scale onto 448 and a float32 accumulation."""
    return _dynamic_matmul("fp8", x, wq, wscale, partial(_mm, "fp8"))


_QUANTIZERS = {"int8": quantize_weight, "fp8": quantize_weight_fp8}
_MATMULS = {"int8": int8_matmul, "fp8": fp8_matmul}


def check_kind(kind: str) -> str:
    if kind not in KINDS:
        raise ValueError(f"kind must be 'int8' or 'fp8', got {kind!r}")
    return kind


class QLinear(nn.Module):
    """A dense layer serving quantized weights, the JAX package's `QDense`
    (kind "int8") and `F8Dense` (kind "fp8") in one module.

    Buffers: `weight` (out, in) int8 or float8_e4m3fn, `weight_scale`
    float32 (out,), `bias` float32 (out,). A new layer holds zeros (unit
    scales): it is filled from a float layer by `quantize_dense_params` or
    from a snapshot's state_dict. The output is cast to `dtype`, the
    model's compute dtype. Inference only."""

    def __init__(self, in_features: int, out_features: int, kind: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.kind = check_kind(kind)
        self.dtype = dtype
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=WEIGHT_DTYPES[kind]))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    @torch.no_grad()
    def set_from(self, weight: torch.Tensor, bias: torch.Tensor) -> None:
        """Quantize a float (out, in) weight into this layer, keeping the
        bias in float32."""
        wq, scale = _QUANTIZERS[self.kind](weight)
        self.weight.copy_(wq)
        self.weight_scale.copy_(scale)
        self.bias.copy_(bias.float())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _MATMULS[self.kind](x, self.weight, self.weight_scale)
        return (y + self.bias).to(self.dtype)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, "
                f"out_features={self.out_features}, kind={self.kind}")


def plain_linear(layer: QLinear, x: torch.Tensor) -> torch.Tensor:
    """`layer(x)` through the plain product on any device: the reference
    the card's int8 and fp8 GEMMs are held to."""
    y = _dynamic_matmul(layer.kind, x, layer.weight, layer.weight_scale,
                        _PLAIN[layer.kind])
    return (y + layer.bias).to(layer.dtype)


@torch.no_grad()
def quantize_dense_params(model: nn.Module, kind: str = "int8") -> nn.Module:
    """A quantized serving copy of a float SegFormer: the model's class
    built for `model.cfg.replace(quant=kind)`, whose dense layers (the ones
    the JAX model builds through `_dense_cls`: q/k/v, the attention output,
    dense1/dense2, linear_c and cls_proj) are `QLinear(kind)`s, each
    filled by quantizing the float layer of the same name; every other
    weight and BatchNorm statistic is copied as `model` holds it
    (`cast_to_compute_dtype` casts them once for serving). The copy shares
    no tensor with `model`, so training `model` in place leaves it as it
    was (the JAX package deep-copies its snapshot for the same reason).
    Eval mode, no gradients."""
    cfg = model.cfg.replace(quant=check_kind(kind))
    device = next(model.parameters()).device
    with torch.inference_mode(False):
        with torch.device("meta"):
            q = type(model)(cfg)
        q = q.to_empty(device=device)
        dense = {name: m for name, m in q.named_modules()
                 if isinstance(m, QLinear)}
        rest = {k: v for k, v in model.state_dict().items()
                if k.rpartition(".")[0] not in dense}
        missing, unexpected = q.load_state_dict(rest, strict=False)
        if unexpected or {k.rpartition(".")[0] for k in missing} - set(dense):
            raise ValueError(f"{type(model).__name__} does not match its "
                             f"quantized build: missing {missing}, "
                             f"unexpected {unexpected}")
        for name, layer in dense.items():
            src = model.get_submodule(name)
            layer.set_from(src.weight, src.bias)
    return q.eval().requires_grad_(False)


def snapshot_kind(state_dict) -> str:
    """The width of a quantized snapshot, from its tensors' dtypes: "int8"
    or "fp8". ValueError when it holds neither or both."""
    kinds = sorted({k for t in state_dict.values()
                    for k, d in WEIGHT_DTYPES.items() if t.dtype == d})
    if len(kinds) != 1:
        raise ValueError(f"cannot infer the snapshot's width: found "
                         f"quantized weight dtypes {kinds or 'none'}")
    return kinds[0]
