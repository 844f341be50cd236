"""Model configuration of the PyTorch port.

The port's own copy of the MiT variants of the JAX package's
`core/config.py` (`MiTConfig`, `mit_b0`..`mit_b5`, `MIT_VARIANTS`), with the
same constants. Fields that only steer JAX compilation (`remat`,
`scan_unroll`, `ffn_impl`) are left out, and so is `quant`, which belongs to
the quantized-serving slice. `attn_impl` names the port's own choices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

ATTN_IMPLS = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class MiTConfig:
    """Mix Transformer (SegFormer encoder) + all-MLP decode head.

    Constants follow SegFormer's B0 defaults; B1-B5 widen and deepen them
    (nvidia/mit-b5 for B5).
    """

    num_channels: int = 3
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    hidden_sizes: Tuple[int, ...] = (32, 64, 160, 256)
    patch_sizes: Tuple[int, ...] = (7, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 2, 2, 2)
    num_heads: Tuple[int, ...] = (1, 2, 5, 8)
    sr_ratios: Tuple[int, ...] = (8, 4, 2, 1)
    mlp_ratio: float = 4.0
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    classifier_dropout: float = 0.1
    drop_path_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    decoder_hidden: int = 256
    num_labels: int = 1

    # Prompt tuning: prompt_tokens[i] learnable tokens prepended at every
    # layer of stage i (one set per layer when prompt_per_layer);
    # cls_tokens[i] (0 or 1) a domain-CLS token prepended at the first layer
    # of stage i and carried across its layers.
    prompt_tokens: Tuple[int, ...] = (0, 0, 0, 0)
    prompt_per_layer: bool = False
    cls_tokens: Tuple[int, ...] = (0, 0, 0, 0)

    # Compute dtype of the forward pass ("bfloat16" or "float32"); params of
    # normalisation layers and the prompt/CLS tokens stay float32.
    dtype: str = "float32"

    # SR-attention: "kernel" (the hand-written CUDA kernel on a CUDA tensor,
    # its plain version on a CPU tensor) or "plain" (plain torch anywhere;
    # the comparison path of chip_smoke.py).
    attn_impl: str = "kernel"

    # GELU flavour: False = exact erf, True = tanh approximation.
    gelu_approx: bool = False

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', "
                             f"got {self.dtype!r}")

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def use_cls(self) -> bool:
        # The decode head takes the CLS token only when every stage has one.
        return all(c > 0 for c in self.cls_tokens)

    def replace(self, **kw) -> "MiTConfig":
        return dataclasses.replace(self, **kw)


def mit_b0(**kw) -> MiTConfig:
    return MiTConfig(**kw)


def mit_b1(**kw) -> MiTConfig:
    return MiTConfig(
        hidden_sizes=(64, 128, 320, 512), decoder_hidden=256, **kw)


def mit_b2(**kw) -> MiTConfig:
    return MiTConfig(
        hidden_sizes=(64, 128, 320, 512), depths=(3, 4, 6, 3),
        decoder_hidden=768, **kw)


def mit_b3(**kw) -> MiTConfig:
    return MiTConfig(
        hidden_sizes=(64, 128, 320, 512), depths=(3, 4, 18, 3),
        decoder_hidden=768, **kw)


def mit_b4(**kw) -> MiTConfig:
    return MiTConfig(
        hidden_sizes=(64, 128, 320, 512), depths=(3, 8, 27, 3),
        decoder_hidden=768, **kw)


def mit_b5(**kw) -> MiTConfig:
    """MiT-B5 (nvidia/mit-b5), the production encoder."""
    return MiTConfig(
        hidden_sizes=(64, 128, 320, 512), depths=(3, 6, 40, 3),
        decoder_hidden=768, **kw)


MIT_VARIANTS = {
    "b0": mit_b0, "b1": mit_b1, "b2": mit_b2,
    "b3": mit_b3, "b4": mit_b4, "b5": mit_b5,
}
