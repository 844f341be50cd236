"""The supervised fine-tune steps of the JAX package's `train/supervised.py`,
in PyTorch (the reference's `main_segformer/segFormer_main.py` path).

- `train_step`: a forward, the segmentation loss ("dice" or
  "dice_argmax") and one Adam update with NaN-skip (`train/state.py`),
  over `accum` microbatches run in turn whose gradients and losses are
  averaged before the one update.
- `eval_step`: an eval-mode forward and the binarised dice loss, the
  reference's eval metric (`SegFormerModel.eval_one_epoch`,
  `models/SegFormerModel.py:141-144`).
- `predict_step`: the eval-mode sigmoid masks.

`train_mode=False` is the reference-quirks forward (eval mode,
`SegFormerModel.py:104-105`); `train_mode=True` draws drop-path and
classifier-dropout masks from `generator` (each microbatch in turn) and
normalises with batch statistics, whose running averages thread through the
microbatches as sequential forwards would and are kept in the state. The
state is updated in place; nothing in a step waits on the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.train.common import (
    accumulate_microbatches,
    forward_masks,
    grads_of,
)
from semisupervisedobjectdetection_torch.train.state import TrainState


def _loss_and_grads(state: TrainState, images, masks, loss_type, train_mode,
                    generator, stats=None):
    pred, _, new_stats = forward_masks(state.model, images,
                                       train_mode=train_mode,
                                       generator=generator, stats=stats)
    loss = losses.segmentation_loss(pred, masks, loss_type)
    grads = grads_of(loss, state.trainable_params)
    return loss.detach(), pred.detach(), grads, new_stats


def train_step(state: TrainState, images: torch.Tensor, masks: torch.Tensor,
               loss_type: str = "dice", train_mode: bool = False,
               accum: int = 1, generator: Optional[torch.Generator] = None
               ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One supervised update of `state` on NHWC float images and (B, H, W)
    masks on its device. Returns (state, loss, predicted masks); the loss
    and gradients are the means over the `accum` microbatches (dice
    normalises per microbatch, so the mean is not the full batch's dice).
    A loss that is not finite skips the update."""
    if accum <= 1:
        loss, pred, grads, new_stats = _loss_and_grads(
            state, images, masks, loss_type, train_mode, generator)
    else:
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum={accum}")
        xs = (images.reshape(accum, b // accum, *images.shape[1:]),
              masks.reshape(accum, b // accum, *masks.shape[1:]))

        def micro(stats, imgs, msks):
            loss, pred, g, new_stats = _loss_and_grads(
                state, imgs, msks, loss_type, train_mode, generator, stats)
            return g, new_stats, {"loss": loss}, pred

        zero = {"loss": torch.zeros((), device=images.device)}
        gsum, new_stats, sums, preds = accumulate_microbatches(
            micro, state.trainable_params, state.batch_stats, zero, xs)
        grads = {n: g / accum for n, g in gsum.items()}
        del gsum
        loss = sums["loss"] / accum
        pred = preds.reshape(b, *preds.shape[2:])
    state.apply_gradients(grads, loss)
    del grads
    if train_mode:
        state.set_batch_stats(new_stats)
    return state, loss, pred


@torch.no_grad()
def eval_step(state: TrainState, images: torch.Tensor, masks: torch.Tensor,
              loss_type: str = "dice_argmax"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, predicted masks) of `state`'s model in eval mode on NHWC
    images against (B, H, W) masks."""
    pred, _, _ = forward_masks(state.model, images, train_mode=False)
    return losses.segmentation_loss(pred, masks, loss_type), pred


@torch.no_grad()
def predict_step(state: TrainState, images: torch.Tensor) -> torch.Tensor:
    """Sigmoid masks of NHWC images at their size, eval mode
    (`SegFormerModel.predict` without a target)."""
    return forward_masks(state.model, images, train_mode=False)[0]
