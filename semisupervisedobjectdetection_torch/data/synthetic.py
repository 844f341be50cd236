"""Synthetic Georgia-shaped tiles for tests and benchmarks.

(The port's own copy of the JAX package's numpy/PIL-only
`data/synthetic.py`: the same tiles, byte for byte, from the same seeds.)

The real dataset (private Bing aerial tiles of archaeological sites,
reference `config.py:19-26`) is not distributable; this module generates
deterministic tiles with the same on-disk layout (`{id}bing.png` +
`{maskdir}/{id}bing_mask.png`, bottom watermark strip included) so the host
decode path (`data/tiles.py`) and every training workload can run end-to-end
without the private data.

Tiles are smooth value-noise backgrounds with elliptical "site" regions;
masks are 0/255 binary PNGs like the originals.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def _value_noise(rng: np.random.Generator, hw: Tuple[int, int],
                 scale: int = 8) -> np.ndarray:
    coarse = rng.uniform(0, 1, (scale, scale))
    ys = np.linspace(0, scale - 1, hw[0])
    xs = np.linspace(0, scale - 1, hw[1])
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, scale - 1)
    x1 = np.minimum(x0 + 1, scale - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    v = (coarse[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
         + coarse[np.ix_(y1, x0)] * wy * (1 - wx)
         + coarse[np.ix_(y0, x1)] * (1 - wy) * wx
         + coarse[np.ix_(y1, x1)] * wy * wx)
    return v


def synthetic_tile(seed: int, size: int = 512, n_sites: int = 3
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One (image uint8 HWC, mask uint8 HW in {0,255}) synthetic tile."""
    rng = np.random.default_rng(seed)
    base = _value_noise(rng, (size, size))
    img = np.stack([
        0.35 + 0.4 * base,
        0.4 + 0.35 * _value_noise(rng, (size, size)),
        0.3 + 0.3 * _value_noise(rng, (size, size)),
    ], axis=-1)
    mask = np.zeros((size, size), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(n_sites):
        cy, cx = rng.integers(size // 8, size - size // 8, 2)
        ry, rx = rng.integers(size // 16, size // 5, 2)
        theta = rng.uniform(0, np.pi)
        dy, dx = yy - cy, xx - cx
        u = dy * np.cos(theta) + dx * np.sin(theta)
        v = -dy * np.sin(theta) + dx * np.cos(theta)
        inside = (u / ry) ** 2 + (v / rx) ** 2 <= 1.0
        mask[inside] = 255
        img[inside] = img[inside] * 0.6 + np.array([0.45, 0.4, 0.3]) * 0.4
    img = np.clip(img * 255, 0, 255).astype(np.uint8)
    return img, mask


def synthetic_batch(seed: int, batch: int, size: int = 512
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched synthetic tiles: (B,H,W,3) uint8, (B,H,W) float32 {0,1}."""
    imgs, masks = [], []
    for i in range(batch):
        img, mask = synthetic_tile(seed * 10007 + i, size)
        imgs.append(img)
        masks.append(mask)
    return (np.stack(imgs),
            (np.stack(masks) > 127).astype(np.float32))


def write_synthetic_dataset(data_dir: str, mask_dir: Optional[str],
                            n: int, size: int = 256, seed: int = 0,
                            unlabeled: bool = False,
                            pair: bool = False) -> None:
    """Write tiles in the reference's on-disk layout, including the 23-px
    watermark strip the decoder crops off. `pair=True` also writes the
    `{id}book.jpg` greyscale scan (75-px watermark) + `{id}book_mask.png`
    companions of the reference 4-tuple item
    (`archaeological_georgia_biostyle_dataloader.py:51-69`)."""
    from PIL import Image

    os.makedirs(data_dir, exist_ok=True)
    if mask_dir:
        os.makedirs(mask_dir, exist_ok=True)
    for i in range(n):
        img, mask = synthetic_tile(seed * 7919 + i, size + 23)
        tile_id = f"tile{i:05d}_"          # basename > 8 chars => labeled
        if unlabeled:
            name = f"u{i:03d}"             # basename <= 8 chars => unlabeled
            Image.fromarray(img).save(os.path.join(data_dir, name + ".png"))
            continue
        Image.fromarray(img).save(
            os.path.join(data_dir, tile_id + "bing.png"))
        if mask_dir:
            m3 = np.stack([mask] * 3, axis=-1)
            Image.fromarray(m3).save(
                os.path.join(mask_dir, tile_id + "bing_mask.png"))
        if pair:
            bimg, bmask = synthetic_tile(seed * 7919 + i + 5000, size + 75)
            grey = bimg.mean(axis=-1).astype(np.uint8)
            Image.fromarray(grey, mode="L").save(
                os.path.join(data_dir, tile_id + "book.jpg"))
            if mask_dir:
                m3 = np.stack([bmask] * 3, axis=-1)
                Image.fromarray(m3).save(
                    os.path.join(mask_dir, tile_id + "book_mask.png"))
