"""Confidence-thresholded pseudo-labels and label denoising, the JAX
package's `train/pseudo.py` in PyTorch.

Samples that fail the confidence gate get weight 0 instead of being dropped,
so shapes stay fixed and nothing waits on the host:

- per sample, "pixel_num" is the sum of the soft probabilities, and the
  confidence the share of pixels with p >= thr or p <= 1 - thr;
- the pseudo mask is p >= thr;
- a sample is kept when pixel_num > 1000 and its confidence >=
  confident_thr (every sample when `allow_throw_sample` is False);
- the loss is the mean per-sample dice loss over the kept samples, NaN when
  none is kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PSEUDO_MASK_THRESHOLD = 0.7
CONFIDENT_THRESHOLD = 0.7
MIN_FG_SOFT_PIXELS = 1000.0


class PseudoLabels(NamedTuple):
    pseudo_mask: torch.Tensor   # (B,H,W) {0,1} binarised at threshold
    keep: torch.Tensor          # (B,) float32 {0,1} confidence gate
    confidence: torch.Tensor    # (B,) float32 per-sample confidence
    loss: torch.Tensor          # scalar: mean per-sample dice loss over kept
    n_kept: torch.Tensor        # scalar float32


def _per_sample_dice_loss(pred: torch.Tensor,
                          target: torch.Tensor) -> torch.Tensor:
    """1 - dice of each sample on its own."""
    b = pred.shape[0]
    p = pred.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    tp = (t * p).sum(1).abs()
    fp = p.abs().sum(1)
    fn = t.sum(1)
    return 1.0 - (2.0 * tp + 1.0) / (fp + fn + 1.0)


def threshold_pseudo_masks(soft_masks: torch.Tensor,
                           threshold: float = PSEUDO_MASK_THRESHOLD,
                           confident_threshold: float = CONFIDENT_THRESHOLD,
                           allow_throw_sample: bool = True) -> PseudoLabels:
    """soft_masks: (B, H, W) sigmoid teacher predictions in [0, 1]."""
    b = soft_masks.shape[0]
    flat = soft_masks.reshape(b, -1).float()
    pixel_num = flat.abs().sum(1)
    confident_px = (flat >= threshold) | (flat <= 1.0 - threshold)
    confidence = confident_px.float().mean(1)
    pseudo = torch.where(soft_masks >= threshold, 1.0, 0.0)
    if allow_throw_sample:
        keep = ((pixel_num > MIN_FG_SOFT_PIXELS)
                & (confidence >= confident_threshold)).float()
    else:
        keep = torch.ones(b, device=soft_masks.device)
    per_sample = _per_sample_dice_loss(soft_masks, pseudo.detach())
    n_kept = keep.sum()
    loss = (per_sample * keep).sum() / n_kept.clamp_min(1.0)
    loss = torch.where(n_kept > 0, loss, torch.full_like(loss, float("nan")))
    return PseudoLabels(pseudo_mask=pseudo, keep=keep, confidence=confidence,
                        loss=loss, n_kept=n_kept)


def denoise_labels(teacher_pred: torch.Tensor, ground_truth: torch.Tensor,
                   threshold: float = PSEUDO_MASK_THRESHOLD) -> torch.Tensor:
    """Blend the teacher's prediction with 0.2*GT - 0.1, clamp to [0, 1]
    and binarise at the pseudo threshold: the denoised {0,1} mask."""
    blended = (teacher_pred + 0.2 * ground_truth - 0.1).clamp(0.0, 1.0)
    return torch.where(blended >= threshold, 1.0, 0.0)
