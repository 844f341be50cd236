"""The eval step of the JAX package's `train/supervised.py`, in PyTorch: an
eval-mode forward and the binarised dice loss, the reference's eval metric
(`SegFormerModel.eval_one_epoch`, `models/SegFormerModel.py:141-144`).
The supervised `train_step` and `predict_step` come with the supervised
loop (ROADMAP.md Queue 1)."""

from __future__ import annotations

from typing import Tuple

import torch

from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.train.common import forward_masks
from semisupervisedobjectdetection_torch.train.state import TrainState


@torch.no_grad()
def eval_step(state: TrainState, images: torch.Tensor, masks: torch.Tensor,
              loss_type: str = "dice_argmax"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, predicted masks) of `state`'s model in eval mode on NHWC
    images against (B, H, W) masks."""
    pred, _, _ = forward_masks(state.model, images, train_mode=False)
    return losses.segmentation_loss(pred, masks, loss_type), pred
