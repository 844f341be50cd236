"""SegFormer (MiT encoder + all-MLP decode head) in PyTorch.

The counterpart of the JAX package's `models/segformer.py` in eval mode:
deterministic, no dropout or drop-path, BatchNorm on its running statistics
(the JAX `train_mode=False` forward, which the EMA step trains through). It
keeps that model's prompt-tuning and domain-CLS behaviour:

1. Prompt tokens are prepended at every layer of a stage and skip the
   spatial sequence-reduction conv inside attention, but not its LayerNorm.
2. One CLS token is prepended at the front of the stream, carried across
   the layers of a stage (only the first prefix token is carried), and the
   prefix tokens bypass the MixFFN.
3. The decode head adds a projection of the sigmoid of the final-stage CLS
   token to every stage's features.

Parameter names are the HF SegFormer keys (`segformer.encoder.block.0.0.
attention.self.query.weight`, ...); prompt and CLS tokens are real
parameters under `segformer.encoder.prompt_tokens.<stage>` and
`segformer.encoder.cls_token.<stage>`.

Public functions keep the JAX layout: NHWC float images in, NHWC logits and
(B, H, W) masks out. Convolutions run NCHW inside. Parameters are float32
and each dense and conv layer casts its weights to the compute dtype at use,
as the JAX model does, so gradients reach the float32 masters; serving casts
the dense and conv weights once (`cast_to_compute_dtype`), after which the
cast at use is a no-op. LayerNorm and BatchNorm statistics, prompt/CLS
tokens, the logits and the mask sigmoid stay float32. Under
`cfg.remat="full"` each encoder layer runs under `torch.utils.checkpoint`
when gradients are recorded, the counterpart of the JAX `nn.remat(Block)`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.ops.sr_attention import (
    sr_attention,
    sr_attention_reference,
)


def compute_dtype(cfg: MiTConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype: the weight and bias are
    cast at use (float32 masters, bfloat16 compute)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype, as `Linear`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose statistics are taken in float32 whatever the input
    dtype; the result comes back in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def upsample_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear NHWC resize with half-pixel centres. Equal to
    `jax.image.resize(..., "bilinear")` when upsampling, which is its only
    use here (`align_corners=False`, no antialiasing)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def _to_nchw(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = tokens.shape
    return tokens.transpose(1, 2).reshape(b, c, h, w)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


class OverlapPatchEmbed(nn.Module):
    """Overlapping patch embedding: strided conv, then LayerNorm."""

    def __init__(self, in_ch: int, hidden: int, patch: int, stride: int,
                 eps: float):
        super().__init__()
        self.proj = Conv2d(in_ch, hidden, patch, stride, patch // 2)
        self.layer_norm = LayerNorm(hidden, eps=eps)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        h, w = x.shape[2:]
        return self.layer_norm(_to_tokens(x)), h, w


class EfficientSelfAttention(nn.Module):
    """SR self-attention (HF `attention.self`). The first `n_prefix` tokens
    skip the strided reduction conv and are put back in front of the
    reduced spatial tokens before `layer_norm` (the JAX model's
    `sr_norm`)."""

    def __init__(self, hidden: int, num_heads: int, sr_ratio: int,
                 eps: float, attn_impl: str):
        super().__init__()
        self.num_heads = num_heads
        self.sr_ratio = sr_ratio
        self.attn_impl = attn_impl
        # The bfloat16 forward on the tensor cores (`sr_attention(...,
        # mma=True)`); serving turns it off (`api.SegFormerModel`).
        self.attn_fwd_mma = True
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        if sr_ratio > 1:
            self.sr = Conv2d(hidden, hidden, sr_ratio, sr_ratio)
            self.layer_norm = LayerNorm(hidden, eps=eps)

    def forward(self, x: torch.Tensor, h: int, w: int,
                n_prefix: int) -> torch.Tensor:
        q = self.query(x)
        kv_in = x
        if self.sr_ratio > 1:
            spatial = _to_tokens(self.sr(_to_nchw(x[:, n_prefix:], h, w)))
            kv_in = torch.cat([x[:, :n_prefix], spatial], 1) if n_prefix \
                else spatial
            kv_in = self.layer_norm(kv_in)
        k = self.key(kv_in)
        v = self.value(kv_in)
        if self.attn_impl == "kernel":
            return sr_attention(q, k, v, self.num_heads, self.attn_fwd_mma)
        return sr_attention_reference(q, k, v, self.num_heads)


class SelfOutput(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = Linear(hidden, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense(x)


class Attention(nn.Module):
    def __init__(self, hidden: int, num_heads: int, sr_ratio: int,
                 eps: float, attn_impl: str):
        super().__init__()
        self.self = EfficientSelfAttention(hidden, num_heads, sr_ratio, eps,
                                           attn_impl)
        self.output = SelfOutput(hidden)

    def forward(self, x, h, w, n_prefix):
        return self.output(self.self(x, h, w, n_prefix))


class DWConv(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.dwconv = Conv2d(ch, ch, 3, 1, 1, groups=ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dwconv(x)


class MixFFN(nn.Module):
    """dense -> 3x3 depthwise conv -> GELU -> dense."""

    def __init__(self, hidden: int, mlp_hidden: int, gelu_approx: bool):
        super().__init__()
        self.gelu = "tanh" if gelu_approx else "none"
        self.dense1 = Linear(hidden, mlp_hidden)
        self.dwconv = DWConv(mlp_hidden)
        self.dense2 = Linear(mlp_hidden, hidden)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = self.dense1(x)
        x = _to_tokens(self.dwconv(_to_nchw(x, h, w)))
        return self.dense2(F.gelu(x, approximate=self.gelu))


class Block(nn.Module):
    """One SegFormer layer: pre-LN attention over the [cls, prompt, spatial]
    stream with a residual, then only the spatial tokens go through the
    MixFFN; the first prefix token is the carried CLS of the next layer."""

    def __init__(self, cfg: MiTConfig, i: int):
        super().__init__()
        c = cfg.hidden_sizes[i]
        eps = cfg.layer_norm_eps
        self.layer_norm_1 = LayerNorm(c, eps=eps)
        self.attention = Attention(c, cfg.num_heads[i], cfg.sr_ratios[i], eps,
                                   cfg.attn_impl)
        self.layer_norm_2 = LayerNorm(c, eps=eps)
        self.mlp = MixFFN(c, int(c * cfg.mlp_ratio), cfg.gelu_approx)

    def forward(self, tokens: torch.Tensor, h: int, w: int,
                prompt: Optional[torch.Tensor],
                carried: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        b = tokens.shape[0]
        parts = []
        if carried is not None:
            parts.append(carried.to(tokens.dtype))
        if prompt is not None:
            parts.append(prompt.to(tokens.dtype).expand(b, -1, -1))
        n_prefix = sum(p.shape[1] for p in parts)
        stream = torch.cat(parts + [tokens], 1) if parts else tokens
        stream = stream + self.attention(self.layer_norm_1(stream), h, w,
                                         n_prefix)
        tokens = stream[:, n_prefix:]
        tokens = tokens + self.mlp(self.layer_norm_2(tokens), h, w)
        new_carried = stream[:, :1] if carried is not None else None
        return tokens, new_carried


class MiTEncoder(nn.Module):
    """Hierarchical Mix-Transformer encoder; each stage is patch embed ->
    its layers in a plain loop -> LayerNorm."""

    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.cfg = cfg
        ins = (cfg.num_channels,) + tuple(cfg.hidden_sizes[:-1])
        self.patch_embeddings = nn.ModuleList(
            OverlapPatchEmbed(ins[i], cfg.hidden_sizes[i], cfg.patch_sizes[i],
                              cfg.strides[i], cfg.layer_norm_eps)
            for i in range(cfg.num_stages))
        self.block = nn.ModuleList(
            nn.ModuleList(Block(cfg, i) for _ in range(cfg.depths[i]))
            for i in range(cfg.num_stages))
        self.layer_norm = nn.ModuleList(
            LayerNorm(c, eps=cfg.layer_norm_eps) for c in cfg.hidden_sizes)
        self.prompt_tokens = nn.ParameterDict()
        self.cls_token = nn.ParameterDict()
        for i, c in enumerate(cfg.hidden_sizes):
            t = cfg.prompt_tokens[i]
            if t > 0:
                shape = (cfg.depths[i], t, c) if cfg.prompt_per_layer \
                    else (t, c)
                self.prompt_tokens[str(i)] = nn.Parameter(torch.zeros(shape))
            if cfg.cls_tokens[i] > 0:
                if cfg.cls_tokens[i] != 1:
                    raise NotImplementedError(
                        "cls_tokens per stage must be 0 or 1: one CLS token "
                        "is carried across a stage")
                self.cls_token[str(i)] = nn.Parameter(torch.zeros(1, c))

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        """NHWC images -> (per-stage NHWC features, per-stage carried CLS
        (B, 1, C_i) or None)."""
        dtype = compute_dtype(self.cfg)
        x = pixel_values.permute(0, 3, 1, 2).to(dtype)
        b = x.shape[0]
        hidden_states, cls_out = [], []
        for i in range(self.cfg.num_stages):
            tokens, h, w = self.patch_embeddings[i](x)
            prompt = self.prompt_tokens[str(i)] \
                if str(i) in self.prompt_tokens else None
            carried = None
            if str(i) in self.cls_token:
                carried = self.cls_token[str(i)].to(dtype)[None].expand(
                    b, -1, -1)
            remat = self.cfg.remat == "full" and torch.is_grad_enabled()
            for j, blk in enumerate(self.block[i]):
                p = prompt[j] if (prompt is not None
                                  and self.cfg.prompt_per_layer) else prompt
                if remat:
                    tokens, carried = checkpoint(blk, tokens, h, w, p,
                                                 carried, use_reentrant=False)
                else:
                    tokens, carried = blk(tokens, h, w, p, carried)
            tokens = self.layer_norm[i](tokens)
            c = tokens.shape[-1]
            hidden_states.append(tokens.reshape(b, h, w, c))
            cls_out.append(carried)
            x = _to_nchw(tokens, h, w)
        return hidden_states, cls_out


class _Backbone(nn.Module):
    """Holds the encoder under the HF key prefix `segformer.encoder`."""

    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.encoder = MiTEncoder(cfg)


class LinearC(nn.Module):
    """Per-stage projection to the decoder width, plus `cls_proj` of the
    final-stage CLS when every stage has a CLS token."""

    def __init__(self, in_ch: int, d: int, cls_in: Optional[int]):
        super().__init__()
        self.proj = Linear(in_ch, d)
        if cls_in is not None:
            self.cls_proj = Linear(cls_in, d)


class DecodeHead(nn.Module):
    """All-MLP decode head. `linear_fuse` (a 1x1 conv without bias over the
    reversed concat of the stages) is applied per stage at the stage's own
    resolution before upsampling: stage i uses input rows
    [(n-1-i)d, (n-i)d). That equals fuse-after-concat because the 1x1 conv
    and the bilinear upsampling are both linear and commute."""

    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.cfg = cfg
        d, n = cfg.decoder_hidden, cfg.num_stages
        cls_in = cfg.hidden_sizes[-1] if cfg.use_cls else None
        self.linear_c = nn.ModuleList(
            LinearC(c, d, cls_in) for c in cfg.hidden_sizes)
        self.linear_fuse = Conv2d(n * d, d, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(d, eps=1e-5)
        self.classifier = Conv2d(d, cfg.num_labels, 1)

    def forward(self, hidden_states: List[torch.Tensor],
                cls_final: Optional[torch.Tensor]) -> torch.Tensor:
        """NHWC stage features (+ sigmoid CLS (B,1,C) f32) -> NHWC logits
        in the compute dtype."""
        dtype = compute_dtype(self.cfg)
        d, n = self.cfg.decoder_hidden, len(hidden_states)
        target = tuple(hidden_states[0].shape[1:3])
        acc = None
        for i, hs in enumerate(hidden_states):
            b, h, w, c = hs.shape
            x = self.linear_c[i].proj(hs.reshape(b, h * w, c))
            if cls_final is not None:
                x = x + self.linear_c[i].cls_proj(cls_final.to(dtype))
            rows = self.linear_fuse.weight[:, (n - 1 - i) * d:(n - i) * d,
                                           0, 0]
            x = torch.matmul(x, rows.t().to(dtype)).reshape(b, h, w, d)
            if (h, w) != target:
                x = upsample_bilinear(x, target)
            acc = x if acc is None else acc + x
        bn = self.batch_norm
        x = F.batch_norm(acc.permute(0, 3, 1, 2).float(), bn.running_mean,
                         bn.running_var, bn.weight, bn.bias, False, 0.0,
                         bn.eps).to(dtype)
        logits = self.classifier(F.relu(x))
        return logits.permute(0, 2, 3, 1)


class SegFormer(nn.Module):
    """SegFormer for semantic segmentation: `forward(NHWC images)` returns
    (NHWC float32 logits at 1/4 resolution, per-stage carried CLS tokens)."""

    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.cfg = cfg
        self.segformer = _Backbone(cfg)
        self.decode_head = DecodeHead(cfg)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
        hidden_states, cls_list = self.segformer.encoder(pixel_values)
        cls_final = torch.sigmoid(cls_list[-1].float()) \
            if self.cfg.use_cls else None
        logits = self.decode_head(hidden_states, cls_final)
        return logits.float(), cls_list


_DENSE = (nn.Linear, nn.Conv2d)


def cast_to_compute_dtype(model: SegFormer) -> SegFormer:
    """Cast the dense and conv weights to the config's compute dtype, once,
    as the JAX model casts its float32 params at use. Norm parameters,
    BatchNorm statistics and prompt/CLS tokens stay float32."""
    dtype = compute_dtype(model.cfg)
    for m in model.modules():
        if isinstance(m, _DENSE):
            m.to(dtype)
    return model


def init_weights(model: SegFormer, generator: torch.Generator) -> SegFormer:
    """Random init from `generator`, by the JAX model's initialisers:
    dense weights normal(0, 0.02), conv weights LeCun normal (truncated at
    two standard deviations), biases zero, norm scales one, BatchNorm
    statistics (0, 1), prompt/CLS tokens uniform [0, 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                # truncated normal on [-2, 2] rescaled to unit variance
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
        enc = model.segformer.encoder
        for p in list(enc.prompt_tokens.values()) + \
                list(enc.cls_token.values()):
            p.uniform_(0.0, 1.0, generator=generator)
    return model


def forward_logits(model: SegFormer, images: torch.Tensor
                   ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """Eval forward returning raw logits upsampled to the image size
    (NHWC float32) and the per-stage CLS tokens."""
    logits, cls_list = model(images)
    return upsample_bilinear(logits, images.shape[1:3]).float(), cls_list


def predict_masks(logits: torch.Tensor, out_hw: Tuple[int, int]
                  ) -> torch.Tensor:
    """Upsample NHWC logits to `out_hw` and apply the sigmoid in float32:
    (B, H, W) when there is one label, else (B, H, W, L)."""
    masks = torch.sigmoid(upsample_bilinear(logits, out_hw).float())
    return masks[..., 0] if masks.shape[-1] == 1 else masks


def forward_masks(model: SegFormer, images: torch.Tensor
                  ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
    """Eval forward returning sigmoid masks at the image size and the
    per-stage CLS tokens."""
    logits, cls_list = model(images)
    return predict_masks(logits, tuple(images.shape[1:3])), cls_list
