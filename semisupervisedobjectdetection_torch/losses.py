"""Segmentation losses of the JAX package's `losses.py` that the training
steps and their evaluation use, in PyTorch: dice with smooth 1 over each
sample flattened, the binarised ("argmax") dice of the eval metric, the
reference's MSE of the autoencoder, and the `segmentation_loss` front end
over the three. Everything is float32."""

from __future__ import annotations

from typing import Optional

import torch


def _flatten_per_sample(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def dice_coeff(pred: torch.Tensor, gt: torch.Tensor, smooth: float = 1.0,
               sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch mean of (2*tp + smooth) / (fp + fn + smooth) with, per sample,
    tp = |sum(gt*pred)|, fp = sum(|pred|), fn = sum(gt); `sample_weight`
    re-weights the mean."""
    p = _flatten_per_sample(pred)
    t = _flatten_per_sample(gt)
    tp = (t * p).sum(1).abs()
    fp = p.abs().sum(1)
    fn = t.sum(1)
    score = (2.0 * tp + smooth) / (fp + fn + smooth)
    if sample_weight is None:
        return score.mean()
    w = sample_weight.float()
    return (score * w).sum() / w.sum().clamp_min(1e-8)


def dice_loss(pred: torch.Tensor, gt: torch.Tensor,
              sample_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """1 - mean dice."""
    return 1.0 - dice_coeff(pred, gt, sample_weight=sample_weight)


def dice_argmax_loss(pred: torch.Tensor, gt: torch.Tensor,
                     sample_weight: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """1 - dice of the predictions binarised at 0.5 (the eval metric)."""
    pred_bin = torch.where(pred >= 0.5, 1.0, 0.0)
    return 1.0 - dice_coeff(pred_bin, gt, sample_weight=sample_weight)


def mse_loss(pred: torch.Tensor, gt: torch.Tensor,
             sample_weight: Optional[torch.Tensor] = None,
             divisor: Optional[int] = None) -> torch.Tensor:
    """The reference's MSE (`Loss.py:44-54`): per sample, the sum of squared
    errors over every element divided by `divisor` (not by the pixel
    count), then the batch mean (`sample_weight` re-weights it). The
    reference's divisor is gt.shape[0] * gt.shape[1] of a (B, C, H, W)
    tensor, B*C; that formula is the default on whatever layout is given,
    so NHWC call sites pass `divisor=B*C`."""
    if divisor is None:
        divisor = gt.shape[0] * gt.shape[1]
    err = (_flatten_per_sample(gt) - _flatten_per_sample(pred)).square() \
        .sum(1) / divisor
    if sample_weight is None:
        return err.mean()
    w = sample_weight.float()
    return (err * w).sum() / w.sum().clamp_min(1e-8)


def segmentation_loss(pred: torch.Tensor, gt: torch.Tensor,
                      loss_type: str = "dice",
                      sample_weight: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The reference's `SegmentationLoss.forward` for one class, over the
    ported branches: "dice", "dice_argmax" (alias "argmax") and "mse". The
    "cross_entropy" branch belongs to a loop not ported yet."""
    if loss_type == "dice":
        return dice_loss(pred, gt, sample_weight)
    if loss_type in ("dice_argmax", "argmax"):
        return dice_argmax_loss(pred, gt, sample_weight)
    if loss_type == "mse":
        return mse_loss(pred, gt, sample_weight)
    if loss_type == "cross_entropy":
        raise NotImplementedError(
            f"loss_type {loss_type!r} is not ported yet; ROADMAP.md "
            "Queue 1 names the loops that use it")
    raise ValueError(f"unknown loss_type: {loss_type}")
