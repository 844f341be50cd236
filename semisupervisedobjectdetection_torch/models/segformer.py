"""SegFormer (MiT encoder + all-MLP decode head) in PyTorch.

The counterpart of the JAX package's `models/segformer.py`. The default
forward is its eval mode (the JAX `train_mode=False` forward): no dropout or
drop-path, BatchNorm on its running statistics. Given a `TrainDraws`, the
forward is its train mode: per-sample drop-path on both residual branches
of every layer at the linear rate schedule, classifier dropout, and the
decode head's BatchNorm on batch statistics, which it also returns so the
caller can update the running ones. All randomness comes from an explicit
`torch.Generator`; the drop-path masks of a whole forward are drawn before
it starts, so a layer recomputed under `torch.utils.checkpoint` sees the
same masks. Attention and hidden dropout are not ported (both rates are 0
in every config the system runs). It keeps the JAX model's prompt-tuning
and domain-CLS behaviour:

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

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.ops.sr_attention import (
    HEAD_DIMS,
    MAX_NK,
    max_nk,
    sr_attention,
    sr_attention_reference,
)


def compute_dtype(cfg: MiTConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# flax `nn.BatchNorm(momentum=0.9)`: running <- 0.9 running + 0.1 batch
BN_MOMENTUM = 0.9


def drop_path_rates(cfg: MiTConfig) -> np.ndarray:
    """The drop-path rate of every encoder layer, in layer order: linear
    from 0 to `cfg.drop_path_rate` over all stages, as the JAX model's
    `np.linspace(0, drop_path_rate, sum(depths))`."""
    return np.linspace(0.0, cfg.drop_path_rate, sum(cfg.depths))


@dataclasses.dataclass
class TrainDraws:
    """The randomness of one train-mode forward.

    `keep` is the (layers, 2, B) drop-path mask (1 keep, 0 drop) of the
    attention and MLP branches of every layer, in the compute dtype, and
    `keep_prob` the (layers,) keep probabilities it was drawn with; both are
    None when `drop_path_rate` is 0. `generator` draws the classifier
    dropout mask in the decode head (None when `classifier_dropout` is 0)."""

    keep: Optional[torch.Tensor]
    keep_prob: Optional[torch.Tensor]
    generator: Optional[torch.Generator]

    @classmethod
    def draw(cls, cfg: MiTConfig, batch: int,
             generator: Optional[torch.Generator],
             device: torch.device) -> "TrainDraws":
        """Draw every drop-path mask of one forward over `batch` images
        from `generator` (on `device`), keeping it for the classifier
        dropout. Raises for attention or hidden dropout, which are not
        ported."""
        if cfg.attention_dropout > 0 or cfg.hidden_dropout > 0:
            raise NotImplementedError(
                "attention_dropout and hidden_dropout > 0 in train mode are "
                "not ported yet (neither SR-attention kernel does dropout); "
                "ROADMAP.md Queue 1 names them")
        needs = cfg.drop_path_rate > 0 or cfg.classifier_dropout > 0
        if needs and generator is None:
            raise ValueError("a train-mode forward with drop-path or "
                             "classifier dropout needs a torch.Generator")
        keep = keep_prob = None
        if cfg.drop_path_rate > 0:
            keep_prob = _keep_prob(cfg, torch.device(device))
            u = torch.rand((len(keep_prob), 2, batch), generator=generator,
                           device=device)
            keep = (u < keep_prob.float()[:, None, None]).to(keep_prob.dtype)
        return cls(keep, keep_prob,
                   generator if cfg.classifier_dropout > 0 else None)


@functools.lru_cache(maxsize=None)
def _keep_prob(cfg: MiTConfig, device: torch.device) -> torch.Tensor:
    """1 - the drop-path rates, in the compute dtype as the JAX model holds
    them, put on `device` once (a copy to the card per step would make the
    host wait for the card)."""
    rates = torch.from_numpy(drop_path_rates(cfg)).to(compute_dtype(cfg))
    return (1.0 - rates).to(device)


def _drop_path(x: torch.Tensor, keep: Optional[torch.Tensor],
               keep_prob: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-sample stochastic depth: x / keep_prob * keep, `keep` (B,)."""
    if keep is None:
        return x
    return x / keep_prob * keep.view(-1, *([1] * (x.dim() - 1)))


def attention_shapes(cfg: MiTConfig, h: int, w: int
                     ) -> List[Tuple[int, int, int]]:
    """(Nq, Nk, head width) of each stage's SR-attention on an h x w input:
    the stage's tokens and its reduced key/value tokens (a stride-`sr`
    conv), each with the stage's prompt and CLS prefix. MiT-B5 at 512x512:
    Nk = 256 + prefix at every stage."""
    out = []
    for i in range(cfg.num_stages):
        p, s = cfg.patch_sizes[i], cfg.strides[i]
        h = (h + 2 * (p // 2) - p) // s + 1
        w = (w + 2 * (p // 2) - p) // s + 1
        r = cfg.sr_ratios[i]
        prefix = cfg.prompt_tokens[i] + cfg.cls_tokens[i]
        out.append((h * w + prefix, (h // r) * (w // r) + prefix,
                    cfg.hidden_sizes[i] // cfg.num_heads[i]))
    return out


def check_attention_kernels(cfg: MiTConfig, h: int, w: int,
                            device: torch.device) -> None:
    """Raise ValueError, before a model is built, when `cfg` at h x w would
    send the SR-attention kernels shapes they refuse on `device` (a CUDA
    device with `attn_impl="kernel"`): a head width outside `HEAD_DIMS`, or
    in bfloat16 Nk above `MAX_NK` (the float32 kernels take any Nk).
    Nothing falls back to the plain attention."""
    if torch.device(device).type != "cuda" or cfg.attn_impl != "kernel":
        return
    limit = max_nk(compute_dtype(cfg))
    for i, (_, nk, d) in enumerate(attention_shapes(cfg, h, w)):
        if limit is not None and nk > limit:
            prompt, cls = cfg.prompt_tokens[i], cfg.cls_tokens[i]
            raise ValueError(
                f"stage {i}: SR-attention over Nk={nk} keys "
                f"({nk - prompt - cls} reduced tokens + {prompt} prompt + "
                f"{cls} CLS) at {h}x{w}; the kernels take Nk <= {MAX_NK} "
                "(a K/V loop that lifts the limit is ROADMAP.md Queue 2 "
                "work)")
        if d not in HEAD_DIMS:
            raise ValueError(f"stage {i}: head width {d}; the SR-attention "
                             f"kernels take {HEAD_DIMS}")


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
            return sr_attention(q, k, v, self.num_heads)
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
                carried: Optional[torch.Tensor],
                keep: Optional[torch.Tensor] = None,
                keep_prob: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`keep` (2, B) and `keep_prob` (a scalar): this layer's drop-path
        mask of the attention and MLP branches (None: no drop-path)."""
        b = tokens.shape[0]
        parts = []
        if carried is not None:
            parts.append(carried.to(tokens.dtype))
        if prompt is not None:
            parts.append(prompt.to(tokens.dtype).expand(b, -1, -1))
        n_prefix = sum(p.shape[1] for p in parts)
        stream = torch.cat(parts + [tokens], 1) if parts else tokens
        keep_a, keep_m = (None, None) if keep is None else keep
        stream = stream + _drop_path(
            self.attention(self.layer_norm_1(stream), h, w, n_prefix),
            keep_a, keep_prob)
        tokens = stream[:, n_prefix:]
        tokens = tokens + _drop_path(
            self.mlp(self.layer_norm_2(tokens), h, w), keep_m, keep_prob)
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

    def forward(self, pixel_values: torch.Tensor,
                train: Optional[TrainDraws] = None
                ) -> Tuple[List[torch.Tensor], List[Optional[torch.Tensor]]]:
        """NHWC images -> (per-stage NHWC features, per-stage carried CLS
        (B, 1, C_i) or None); `train` holds the drop-path masks of a
        train-mode forward."""
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
            first = sum(self.cfg.depths[:i])
            for j, blk in enumerate(self.block[i]):
                p = prompt[j] if (prompt is not None
                                  and self.cfg.prompt_per_layer) else prompt
                keep = keep_prob = None
                if train is not None and train.keep is not None:
                    keep = train.keep[first + j]
                    keep_prob = train.keep_prob[first + j]
                if remat:
                    tokens, carried = checkpoint(blk, tokens, h, w, p,
                                                 carried, keep, keep_prob,
                                                 use_reentrant=False)
                else:
                    tokens, carried = blk(tokens, h, w, p, carried, keep,
                                          keep_prob)
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
                cls_final: Optional[torch.Tensor],
                train: Optional[TrainDraws] = None
                ) -> Tuple[torch.Tensor,
                           Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        """NHWC stage features (+ sigmoid CLS (B,1,C) f32) -> (NHWC logits
        in the compute dtype, the BatchNorm batch statistics (mean, biased
        variance), float32 and detached, of a train-mode forward, else
        None)."""
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
        stats = None
        if train is None:
            x = F.batch_norm(acc.permute(0, 3, 1, 2).float(),
                             bn.running_mean, bn.running_var, bn.weight,
                             bn.bias, False, 0.0, bn.eps).to(dtype)
            x = F.relu(x)
        else:
            # flax BatchNorm on batch statistics: float32 mean and
            # E[x^2] - E[x]^2 (biased) over (B, H, W), then
            # (x - mean) * (rsqrt(var + eps) * scale) + bias
            xf = acc.float()
            mean = xf.mean((0, 1, 2))
            var = (xf.square().mean((0, 1, 2)) - mean.square()).clamp_min(0)
            x = (xf - mean) * (torch.rsqrt(var + bn.eps) * bn.weight) \
                + bn.bias
            x = F.relu(x.to(dtype)).permute(0, 3, 1, 2)
            stats = (mean.detach(), var.detach())
            if train.generator is not None:
                keep = 1.0 - self.cfg.classifier_dropout
                u = torch.rand(x.shape, generator=train.generator,
                               device=x.device)
                x = torch.where(u < keep, x / keep, torch.zeros_like(x))
        logits = self.classifier(x)
        return logits.permute(0, 2, 3, 1), stats


class SegFormer(nn.Module):
    """SegFormer for semantic segmentation: `forward(NHWC images)` returns
    (NHWC float32 logits at 1/4 resolution, per-stage carried CLS tokens)."""

    def __init__(self, cfg: MiTConfig):
        super().__init__()
        self.cfg = cfg
        self.segformer = _Backbone(cfg)
        self.decode_head = DecodeHead(cfg)

    def forward(self, pixel_values: torch.Tensor,
                train: Optional[TrainDraws] = None):
        """Eval mode: (logits, cls_list). Train mode (`train` given):
        (logits, cls_list, (BatchNorm batch mean, biased variance))."""
        hidden_states, cls_list = self.segformer.encoder(pixel_values, train)
        cls_final = torch.sigmoid(cls_list[-1].float()) \
            if self.cfg.use_cls else None
        logits, stats = self.decode_head(hidden_states, cls_final, train)
        if train is None:
            return logits.float(), cls_list
        return logits.float(), cls_list, stats


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


def forward_masks(model: SegFormer, images: torch.Tensor,
                  train: Optional[TrainDraws] = None):
    """Sigmoid masks at the image size and the per-stage CLS tokens; in
    train mode (`train` given) also the BatchNorm batch statistics."""
    out = model(images, train)
    return (predict_masks(out[0], tuple(images.shape[1:3])),) + out[1:]
