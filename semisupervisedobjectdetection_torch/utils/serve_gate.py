"""How far MiT-B5's bfloat16 serving paths are from the plain attention path
and from float32: the readings behind serving's SR-attention forward and
chip_smoke's serve gate.

    python -m semisupervisedobjectdetection_torch.utils.serve_gate \
        [--variant b5] [--img-size 512] [--images 16] [--seed 0] \
        [--device cuda]

The same seeded weights and seeded uint8 images (scaled to [0, 1]) go
through `SegFormerModel.predict` in batches of 8 on four paths:

- `served`: what `SegFormerModel` serves in bfloat16 (the Hopper wgmma
  SR-attention forward);
- `scalar`: bfloat16 with the scalar forward (`mma=False`), whose attention
  outputs equal the plain version's bit for bit;
- `plain`: bfloat16 with the plain attention;
- `float32`: the plain attention in float32, TF32 off.

Prints one JSON line: for each bfloat16 path, the share of pixels whose
0.5-thresholded mask differs from the plain path's and from float32's, the
largest |probability difference| from the plain path, the mean one from
float32, and quantiles of |p - 0.5| over the float32 masks, with the card's
name and power limit. chip_smoke's serve phase holds the served path to
the float32 model by these readings.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict

import numpy as np
import torch

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.core.config import (
    MIT_VARIANTS,
    MiTConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    EfficientSelfAttention,
)
from semisupervisedobjectdetection_torch.utils.device import resolve_device

BATCH = 8
QUANTILES = (0.001, 0.01, 0.1, 0.5)


def masks(cfg: MiTConfig, x: np.ndarray, seed: int, device: torch.device,
          scalar: bool = False) -> np.ndarray:
    """`SegFormerModel(config=cfg, seed=seed).predict` of `x` in batches of
    8; with `scalar`, its bfloat16 serving copy runs the scalar
    SR-attention forward."""
    model = SegFormerModel(config=cfg, seed=seed, device=device)
    if scalar:
        for layer in model.model.modules():
            if isinstance(layer, EfficientSelfAttention):
                layer.attn_fwd_mma = False
    out = np.concatenate([model.predict(x[i:i + BATCH])
                          for i in range(0, len(x), BATCH)])
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _flips(a: np.ndarray, b: np.ndarray) -> float:
    return float(((a >= 0.5) != (b >= 0.5)).mean())


def readings(paths: Dict[str, np.ndarray], f32: np.ndarray) -> dict:
    """The readings of the module docstring for the bfloat16 masks `paths`
    (one of them "plain") against the plain path's and the float32 masks
    `f32`."""
    plain = paths["plain"]
    return {
        "mask_flip_vs_plain": {n: _flips(a, plain) for n, a in paths.items()
                               if n != "plain"},
        "max_abs_err_vs_plain": {n: float(np.abs(a - plain).max())
                                 for n, a in paths.items() if n != "plain"},
        "mask_flip_vs_float32": {n: _flips(a, f32) for n, a in paths.items()},
        "mean_abs_err_vs_float32": {n: float(np.abs(a - f32).mean())
                                    for n, a in paths.items()},
        "float32_abs_minus_half_quantiles": dict(zip(
            map(str, QUANTILES),
            np.quantile(np.abs(f32 - 0.5), QUANTILES).tolist())),
    }


def compare(cfg: MiTConfig, x: np.ndarray, seed: int = 0,
            device: torch.device = torch.device("cuda")) -> dict:
    """The readings above for `cfg`'s widths and weights from `seed` on the
    float32 NHWC images `x`."""
    bf16 = cfg.replace(dtype="bfloat16", attn_impl="kernel")
    paths = {"served": masks(bf16, x, seed, device),
             "scalar": masks(bf16, x, seed, device, scalar=True),
             "plain": masks(bf16.replace(attn_impl="plain"), x, seed,
                            device)}
    f32 = masks(cfg.replace(dtype="float32", attn_impl="plain"), x, seed,
                device)
    return readings(paths, f32)


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", default="b5")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = np.random.default_rng(args.seed).integers(
        0, 256, (args.images, args.img_size, args.img_size, 3),
        dtype=np.uint8).astype(np.float32) / 255.0
    out = compare(MIT_VARIANTS[args.variant](), x, args.seed, device)
    print(json.dumps({"serve_gate": {
        "variant": args.variant, "img": args.img_size, "images": args.images,
        "seed": args.seed, **out,
        "card": _smi() if device.type == "cuda" else "cpu"}}), flush=True)


if __name__ == "__main__":
    main()
