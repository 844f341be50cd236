"""Sliding-window inference over rasters larger than one tile, the JAX
package's `eval/sliding_window.py`.

The model runs over overlapping fixed-size windows in batches of one shape
(the last batch zero-padded), and the overlaps are blended with a
separable Hann weight so that window seams vanish. The blending is numpy
on the host, the same arithmetic as the JAX package's, so the same
predictor gives the same bits.
"""

from __future__ import annotations

import numpy as np


def _hann2d(size: int) -> np.ndarray:
    w = 0.5 - 0.5 * np.cos(2 * np.pi * (np.arange(size) + 0.5) / size)
    return np.outer(w, w).astype(np.float32)


def window_coords(h: int, w: int, window: int, overlap: int):
    """The (y, x) corners of the windows over an h x w raster, row by row:
    a stride of `window - overlap`, plus a last row and column flush with
    the raster's edge where the stride does not reach it."""
    stride = window - overlap
    ys = list(range(0, max(h - window, 0) + 1, stride))
    xs = list(range(0, max(w - window, 0) + 1, stride))
    if ys[-1] + window < h:
        ys.append(h - window)
    if xs[-1] + window < w:
        xs.append(w - window)
    return [(y, x) for y in ys for x in xs]


def sliding_window_predict(predict_fn, image: np.ndarray,
                           window: int = 512, overlap: int = 64,
                           batch: int = 8) -> np.ndarray:
    """Blend `predict_fn` over overlapping windows of a large image.

    predict_fn: (batch, window, window, 3) float32 numpy -> (batch, window,
        window) sigmoid masks (e.g. `SegFormerModel.predict`).
    image: (H, W, 3) float32 in [0, 1], H and W at least `window`.
    Returns the (H, W) float32 blended mask: each window's mask weighted by
    the Hann window + 1e-3, summed and divided by the summed weights.
    """
    h, w, _ = image.shape
    coords = window_coords(h, w, window, overlap)
    weight = _hann2d(window) + 1e-3
    acc = np.zeros((h, w), np.float32)
    norm = np.zeros((h, w), np.float32)

    for start in range(0, len(coords), batch):
        chunk = coords[start:start + batch]
        tiles = np.stack([image[y:y + window, x:x + window] for y, x in
                          chunk])
        if len(chunk) < batch:  # pad to the one batch shape
            pad = np.zeros((batch - len(chunk), window, window, 3),
                           np.float32)
            tiles = np.concatenate([tiles, pad])
        preds = np.asarray(predict_fn(tiles))
        for (y, x), p in zip(chunk, preds):
            acc[y:y + window, x:x + window] += p * weight
            norm[y:y + window, x:x + window] += weight
    return acc / np.maximum(norm, 1e-8)
