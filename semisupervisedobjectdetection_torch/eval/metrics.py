"""Evaluation metrics for binary site masks, the JAX package's
`eval/metrics.py` in PyTorch: the binarised dice (the reference's eval
metric, `models/Loss.py:84-86`) and mIoU over {background, site} at
threshold 0.5, pooled over the batch or per image, and pixel accuracy.
Everything is float32 on the tensors' device."""

from __future__ import annotations

from typing import Dict

import torch


def _binary(x: torch.Tensor, threshold: float) -> torch.Tensor:
    return (x >= threshold).float()


def dice_score(pred: torch.Tensor, gt: torch.Tensor,
               threshold: float = 0.5) -> torch.Tensor:
    """Binarised dice (higher is better), the batch mean of
    (2 tp + 1) / (|p| + |g| + 1) per image."""
    p = _binary(pred, threshold).reshape(pred.shape[0], -1)
    g = gt.float().reshape(gt.shape[0], -1)
    tp = (p * g).sum(1)
    return ((2 * tp + 1.0) / (p.sum(1) + g.sum(1) + 1.0)).mean()


def _ious(p: torch.Tensor, g: torch.Tensor, dim=None):
    """(intersection, union) of foreground and of background."""
    pn, gn = 1.0 - p, 1.0 - g

    def total(x):
        return x.sum() if dim is None else x.sum(dim)

    return (total(p * g), total(torch.maximum(p, g)),
            total(pn * gn), total(torch.maximum(pn, gn)))


def binary_miou(pred: torch.Tensor, gt: torch.Tensor,
                threshold: float = 0.5, eps: float = 1e-8) -> torch.Tensor:
    """Mean IoU over {background, foreground} with all pixels of the batch
    pooled into one confusion matrix (the dataset-level convention);
    `per_image_miou` averages per image instead."""
    inter_fg, union_fg, inter_bg, union_bg = _ious(
        _binary(pred, threshold), _binary(gt, 0.5))
    iou_fg = inter_fg / torch.clamp(union_fg, min=eps)
    iou_bg = inter_bg / torch.clamp(union_bg, min=eps)
    return (iou_fg + iou_bg) / 2.0


def per_image_miou(pred: torch.Tensor, gt: torch.Tensor,
                   threshold: float = 0.5, eps: float = 1e-8
                   ) -> torch.Tensor:
    """Mean IoU per image, averaged over the batch. A class absent from
    both the prediction and the ground truth of an image scores 1."""
    b = pred.shape[0]
    inter_fg, union_fg, inter_bg, union_bg = _ious(
        _binary(pred, threshold).reshape(b, -1),
        _binary(gt, 0.5).reshape(b, -1), dim=1)
    one = torch.ones_like(inter_fg)
    iou_fg = torch.where(union_fg > 0,
                         inter_fg / torch.clamp(union_fg, min=eps), one)
    iou_bg = torch.where(union_bg > 0,
                         inter_bg / torch.clamp(union_bg, min=eps), one)
    return ((iou_fg + iou_bg) / 2.0).mean()


def pixel_accuracy(pred: torch.Tensor, gt: torch.Tensor,
                   threshold: float = 0.5) -> torch.Tensor:
    return (_binary(pred, threshold) == _binary(gt, 0.5)).float().mean()


def segmentation_metrics(pred: torch.Tensor, gt: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    return {
        "dice": dice_score(pred, gt),
        "miou": binary_miou(pred, gt),
        "miou_per_image": per_image_miou(pred, gt),
        "pixel_acc": pixel_accuracy(pred, gt),
    }
