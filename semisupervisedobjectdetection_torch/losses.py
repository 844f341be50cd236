"""Segmentation losses of the JAX package's `losses.py` that the training
steps and their evaluation use, in PyTorch: dice with smooth 1 over each
sample flattened, the binarised ("argmax") dice of the eval metric, the
reference's MSE of the autoencoder, the `segmentation_loss` front end over
the three, and the few-shot loop's cosine losses on the domain CLS tokens.
Everything is float32."""

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


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """dot(a, b) / max(|a| * |b|, eps) along `dim`, in float32: the JAX
    package's formula, whose eps bounds the product of the norms (torch's
    `F.cosine_similarity` bounds each norm on its own)."""
    a, b = a.float(), b.float()
    dot = (a * b).sum(dim)
    na = (a * a).sum(dim).sqrt()
    nb = (b * b).sum(dim).sqrt()
    return dot / torch.clamp_min(na * nb, eps)


def inter_domain_loss(cls_a: torch.Tensor, cls_b: torch.Tensor
                      ) -> torch.Tensor:
    """0.5 + 0.5 * mean(cos(cls_a, cls_b)) over the channels of (B, 1, C)
    CLS tokens of two domains: pushes them apart
    (`segFormer_fewshot_learning.py:219-220`)."""
    return 0.5 + 0.5 * cosine_similarity(cls_a.squeeze(1), cls_b.squeeze(1),
                                         dim=1).mean()


def intra_domain_loss(cls_tokens: torch.Tensor) -> torch.Tensor:
    """0.5 - 0.5 * mean(cos(first half, last half)) of one domain's (B, 1,
    C) CLS tokens: pulls them together (`:222-225`). The halves are
    [:B//2] and [-(B//2):], so an odd batch leaves its middle sample out."""
    half = cls_tokens.shape[0] // 2
    return 0.5 - 0.5 * cosine_similarity(cls_tokens[:half].squeeze(1),
                                         cls_tokens[-half:].squeeze(1),
                                         dim=1).mean()


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
