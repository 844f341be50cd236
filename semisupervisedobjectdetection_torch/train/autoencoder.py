"""The autoencoder pretraining steps of the JAX package's
`train/autoencoder.py`, in PyTorch (the reference's
`main_segformer/segFormer_autoencoder_main.py`).

A SegFormer with `num_labels=3` reconstructs its input tile: forward,
logits upsampled to the image size, sigmoid, and the reference's MSE
against the image with the (B, C) divisor B*3 (`models/Loss.py:48-52`).
The reference trains it in train mode (`model.train()`,
`SegFormerModel.py:199`), so the train step always runs the train-mode
forward: drop-path and classifier dropout drawn from the step's
`torch.Generator`, BatchNorm on batch statistics whose running averages
the state keeps. The state is updated in place; nothing in a step waits on
the host.
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


def _recon_loss(recon: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """The reference's MSE with its (B, C, ...) divisor: its call sites pass
    (B, 3, H, W) tensors, so the divisor is B*3."""
    return losses.mse_loss(recon, images, divisor=images.shape[0] * 3)


def ae_train_step(state: TrainState, images: torch.Tensor,
                  generator: Optional[torch.Generator], accum: int = 1
                  ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """One reconstruction update of `state` on NHWC float images on its
    device (`SegFormerModel.train_one_epoch_without_mask`, ref `:198-219`):
    (state, loss, (B, H, W, 3) reconstruction). A loss that is not finite
    skips the update.

    `accum > 1` runs the microbatches in turn, in train mode each drawing
    its masks from `generator`, with BatchNorm statistics threaded through
    them; each keeps the full batch's divisor B*3 and its own batch mean,
    and the losses and gradients are averaged over `accum`, as the JAX
    step does."""
    full_divisor = images.shape[0] * 3
    params = state.trainable_params

    def loss_and_grads(imgs, stats=None):
        recon, _, new_stats = forward_masks(state.model, imgs,
                                            train_mode=True,
                                            generator=generator,
                                            stats=stats)
        loss = losses.mse_loss(recon, imgs, divisor=full_divisor)
        return loss.detach(), recon.detach(), grads_of(loss, params), \
            new_stats

    if accum <= 1:
        loss, recon, grads, new_stats = loss_and_grads(images)
    else:
        b = images.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by accum={accum}")
        xs = (images.reshape(accum, b // accum, *images.shape[1:]),)

        def micro(stats, imgs):
            loss, recon, g, new_stats = loss_and_grads(imgs, stats)
            return g, new_stats, {"loss": loss}, recon

        zero = {"loss": torch.zeros((), device=images.device)}
        gsum, new_stats, sums, recons = accumulate_microbatches(
            micro, params, state.batch_stats, zero, xs)
        grads = {n: g / accum for n, g in gsum.items()}
        del gsum
        loss = sums["loss"] / accum
        recon = recons.reshape(b, *recons.shape[2:])
    state.apply_gradients(grads, loss)
    del grads
    state.set_batch_stats(new_stats)
    return state, loss, recon


@torch.no_grad()
def ae_eval_step(state: TrainState, images: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, reconstruction) of `state`'s model in eval mode
    (`SegFormerModel.eval_one_epoch_without_mask`, ref `:177-196`)."""
    recon, _, _ = forward_masks(state.model, images, train_mode=False)
    return _recon_loss(recon, images), recon
