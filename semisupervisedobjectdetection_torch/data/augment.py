"""Device-side augmentation of uint8 tile batches, the JAX package's
`data/augment.py` in PyTorch.

The reference's albumentations chain (`config.py:27-38`):
  RandomCrop(500, 500) ->
  OneOf([HorizontalFlip, VerticalFlip, RandomRotate90], p=0.75) ->
  Normalize(mean=0, std=255, max_pixel_value=1)  (x / 255) ->
  Resize(512, 512)
then the min-max binarisation of the mask
(`archaeological_georgia_biostyle_dataloader.py:89-90`).

The host ships fixed-size uint8 canvases; the crop and the one-of op of
every sample become one gather of source pixels on the device, followed by
the /255 and the resize of the whole batch, so only uint8 crosses to the
card. The per-sample choices (`AugmentChoices`) are drawn on the host from
a `torch.Generator`, or passed in. Their distribution is the JAX package's:
with probability `prob` one of hflip / vflip / rot90 is chosen uniformly,
rot90's k uniform in {0, 1, 2, 3} with k = 0 folded into identity, so at
`prob` 0.75 identity / hflip / vflip / rot90 have 0.3125 / 0.25 / 0.25 /
0.1875.

Resizes follow `jax.image.resize` (half-pixel centres): bilinear is
`F.interpolate(mode="bilinear", align_corners=False)`, antialiased when it
shrinks, and nearest is torch's "nearest-exact".
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

IDENTITY, HFLIP, VFLIP, ROT90 = 0, 1, 2, 3


class AugmentChoices(NamedTuple):
    """Per-sample choices, each a (B,) int64 tensor: the crop's top-left
    corner (`oy`, `ox`), the op (`branch`: IDENTITY, HFLIP, VFLIP, ROT90)
    and rot90's count `k` in {1, 2, 3} (read where `branch` is ROT90)."""

    oy: torch.Tensor
    ox: torch.Tensor
    branch: torch.Tensor
    k: torch.Tensor


def draw_choices(batch: int, h0: int, w0: int, crop: int, prob: float,
                 generator: torch.Generator) -> AugmentChoices:
    """Draw every sample's crop corner and op from `generator` (a CPU
    generator), with the JAX package's distribution."""
    g = generator
    oy = torch.randint(0, h0 - crop + 1, (batch,), generator=g)
    ox = torch.randint(0, w0 - crop + 1, (batch,), generator=g)
    apply = torch.rand(batch, generator=g) < prob
    op = torch.randint(0, 3, (batch,), generator=g)
    k = torch.randint(1, 4, (batch,), generator=g)
    # RandomRotate90's k = 0 (a quarter of the rot90 draws) is identity
    fold = torch.rand(batch, generator=g) < 0.25
    branch = torch.where(apply, op + 1, torch.zeros_like(op))
    branch = torch.where((branch == ROT90) & fold, torch.zeros_like(op),
                         branch)
    return AugmentChoices(oy, ox, branch, k)


def _source_index(choices: AugmentChoices, crop: int, h0: int, w0: int,
                  device: torch.device) -> torch.Tensor:
    """(B, crop, crop) flat index into the (B*h0*w0) pixels of the batch of
    the source pixel of every output pixel: the crop, then the op.
    `jnp.flip(a, 1)` (hflip), `jnp.flip(a, 0)` (vflip) and
    `jnp.rot90(a, k, axes=(0, 1))` read out[i, j] from (i, c-1-j),
    (c-1-i, j), and for k = 1, 2, 3 from (j, c-1-i), (c-1-i, c-1-j),
    (c-1-j, i)."""
    packed = torch.stack([t.to(torch.int64) for t in choices])
    if device.type == "cuda":      # no host wait on the card's queue
        packed = packed.pin_memory().to(device, non_blocking=True)
    oy, ox, branch, k = packed.to(device)
    r = torch.arange(crop, device=device)
    i, j = r[:, None].expand(crop, crop), r[None, :].expand(crop, crop)
    ri, rj = crop - 1 - i, crop - 1 - j
    rows = torch.stack([i, i, ri, j, ri, rj])      # identity, h, v, k=1..3
    cols = torch.stack([j, rj, j, ri, rj, i])
    case = torch.where(branch == ROT90, ROT90 + k - 1, branch)
    b = torch.arange(len(case), device=device)[:, None, None]
    src_r = rows[case] + oy[:, None, None]
    src_c = cols[case] + ox[:, None, None]
    return (b * h0 + src_r) * w0 + src_c


def _resize(x: torch.Tensor, hw: Tuple[int, int], mode: str) -> torch.Tensor:
    """NCHW resize with half-pixel centres, as `jax.image.resize`."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=hw, mode="nearest-exact")
    shrink = hw[0] < x.shape[-2] or hw[1] < x.shape[-1]
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False,
                         antialias=shrink)


def _binarize(m: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max scaling of (B, H, W) masks, zero where a mask is
    constant (the reference would give NaN there)."""
    mn = m.amin((1, 2), keepdim=True)
    mx = m.amax((1, 2), keepdim=True)
    return torch.where(mx > mn, (m - mn) / torch.clamp(mx - mn, min=1e-8),
                       torch.zeros_like(m))


def _finish(imgs_u8: torch.Tensor, masks: Optional[torch.Tensor],
            out_hw: Tuple[int, int]):
    """uint8 NHWC (+ masks) -> float32 NHWC in [0, 1] at `out_hw` (+ {0, 1}
    masks at `out_hw`)."""
    imgs = imgs_u8.float().div_(255.0).permute(0, 3, 1, 2)
    imgs = _resize(imgs, out_hw, "bilinear").permute(0, 2, 3, 1)
    if masks is None:
        return imgs.contiguous(), None
    m = _resize(masks.float()[:, None], out_hw, "nearest")[:, 0]
    return imgs.contiguous(), _binarize(m)


def augment_batch(images_u8: torch.Tensor,
                  masks: Optional[torch.Tensor] = None, *, crop: int = 500,
                  out_h: int = 512, out_w: int = 512, prob: float = 0.75,
                  generator: Optional[torch.Generator] = None,
                  choices: Optional[AugmentChoices] = None):
    """Train-time augmentation of a uint8 batch, on the batch's device.

    images_u8: (B, H0, W0, 3) uint8; masks: (B, H0, W0) of any numeric
    dtype, or None. The choices come from `choices`, else are drawn from
    `generator` (a CPU generator). Returns (float32 NHWC images in [0, 1]
    at (out_h, out_w), float32 {0, 1} masks or None)."""
    b, h0, w0 = images_u8.shape[:3]
    if choices is None:
        if generator is None:
            raise ValueError("augment_batch needs a generator or choices")
        choices = draw_choices(b, h0, w0, crop, prob, generator)
    idx = _source_index(choices, crop, h0, w0, images_u8.device)
    imgs = images_u8.reshape(-1, images_u8.shape[-1])[idx]
    cropped = None if masks is None else masks.reshape(-1)[idx]
    return _finish(imgs, cropped, (out_h, out_w))


def eval_batch(images_u8: torch.Tensor,
               masks: Optional[torch.Tensor] = None, *, out_h: int = 512,
               out_w: int = 512):
    """Eval-time path: /255 and resize only, no random ops (the reference
    runs its random chain at eval time too; `DataConfig.reference_eval_aug`
    routes eval batches through `augment_batch` for that)."""
    return _finish(images_u8, masks, (out_h, out_w))
