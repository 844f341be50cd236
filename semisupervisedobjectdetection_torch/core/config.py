"""Model, data and training configuration of the PyTorch port.

The port's own copy of the MiT variants of the JAX package's
`core/config.py` (`MiTConfig`, `mit_b0`..`mit_b5`, `MIT_VARIANTS`), of its
tile-data settings (`DataConfig`) and of its optimizer constants
(`TrainConfig`), with the same values. Fields that
only steer JAX compilation (`scan_unroll`, `ffn_impl`) are left out.
`attn_impl` names the port's own choices; `remat` takes the JAX package's
"full" and "none"; `quant` takes its "none", "int8" and "fp8".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

ATTN_IMPLS = ("kernel", "plain")
REMAT_POLICIES = ("full", "none")


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

    # Rematerialisation of the encoder layers in a backward pass: "full"
    # (each layer's activations are recomputed from its input,
    # `torch.utils.checkpoint` per Block, as the JAX package's `nn.remat`)
    # or "none" (all activations kept). The JAX package's "dots" and
    # "save:a+b" policies are not ported yet.
    remat: str = "full"

    # GELU flavour: False = exact erf, True = tanh approximation.
    gelu_approx: bool = False

    # Serving quantization of the dense layers: "none" (cfg.dtype), "int8"
    # or "fp8" (e4m3): per-channel weights and per-token activations,
    # `ops/quant.py::QLinear`. Inference only; a float model is converted
    # by `ops.quant.quantize_dense_params(model, kind)`.
    quant: str = "none"

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            # the JAX package's other policies, one or one per stage
            jax_only = self.remat == "dots" or "save:" in self.remat \
                or "," in self.remat
            raise (NotImplementedError if jax_only else ValueError)(
                f"remat must be one of {REMAT_POLICIES}, got "
                f"{self.remat!r}" + (" (not ported yet; ROADMAP.md Queue 1)"
                                     if jax_only else ""))
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {self.attn_impl!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be 'float32' or 'bfloat16', "
                             f"got {self.dtype!r}")
        if self.quant not in ("none", "int8", "fp8"):
            # a typo would otherwise serve the float model
            raise ValueError(f"MiTConfig.quant must be 'none', 'int8' or "
                             f"'fp8', got {self.quant!r}")

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


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Tile dataset and augmentation settings.

    The host decodes tiles to a fixed-size uint8 canvas; the device applies
    the random crop, one of flip/rot90, the /255 normalisation and the
    resize (`data/augment.py`), the reference's albumentations chain."""

    dataset: Optional[str] = None           # labeled train tiles
    evalset: Optional[str] = None           # labeled eval tiles
    unlabeledset: Optional[str] = None      # unlabeled tiles
    pseudoset: Optional[str] = None         # unlabeled tiles for pseudo-labels
    labeled_classified: Optional[str] = None    # per-domain labeled dirs
    unlabeled_classified: Optional[str] = None  # per-domain unlabeled dirs
    maskdir: Optional[str] = None           # ground-truth masks

    img_h: int = 512
    img_w: int = 512
    canvas: int = 512        # host-side fixed canvas fed to the augmenter
    crop: int = 500          # random crop size
    aug_prob: float = 0.75   # probability of one of hflip / vflip / rot90
    batch_size: int = 20
    few_shot_batch_size: int = 2
    drop_last: bool = True
    shuffle: bool = True
    # The reference runs its random train chain at eval time too; off by
    # default because it makes eval metrics stochastic (CLI
    # --reference-eval-aug turns it on).
    reference_eval_aug: bool = False
    # "raise" (a corrupt tile stops the run) or "substitute" (CLI
    # --skip-bad-tiles: warn once and batch a readable tile in its place).
    bad_tile_policy: str = "raise"
    # >0 (CLI --cache-tiles MB): keep decoded canvas tiles in an LRU cache
    # in host RAM up to this budget, so later epochs skip the PNG decode.
    cache_mb: float = 0.0

    def replace(self, **kw) -> "DataConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer constants of the JAX package's `TrainConfig`: Adam with
    torch's betas (0.5, 0.999) and weight decay folded into the gradient,
    gradient-value clipping, and an exponential learning-rate decay stepped
    per epoch.

    `reference_quirks` (default on) reproduces the reference's behaviour;
    for the semi-supervised loops that means the student's forward runs in
    train mode: drop-path, classifier dropout and BatchNorm on batch
    statistics (`--no-quirks` turns it off)."""

    lr: float = 1e-5
    weight_decay: float = 5e-5
    epochs: int = 50
    lr_decay: float = 0.97
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_value: float = 1.2
    reference_quirks: bool = True

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def product_grid(*iterables: Sequence, repeat: int = 1, shuffle: bool = False,
                 seed: int = 0):
    """The cartesian product of `iterables` as a list of tuples, shuffled
    by `random.Random(seed)` when `shuffle`: the JAX package's
    `core/config.py::product_grid`, so a `--tune` sweep visits its points
    in the same order."""
    import random

    pools = [tuple(pool) for pool in iterables] * repeat
    result = [[]]
    for pool in pools:
        result = [x + [y] for x in result for y in pool]
    if shuffle:
        random.Random(seed).shuffle(result)
    return [tuple(r) for r in result]
