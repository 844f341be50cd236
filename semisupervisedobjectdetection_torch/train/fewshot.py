"""The few-shot domain-prompting steps of the JAX package's
`train/fewshot.py`, in PyTorch (the reference's
`main_segformer/segFormer_fewshot_learning.py`).

- `fewshot_ae_step`: the domain-prompt autoencoder (ref `:191-344`). One
  update on the mean of two category pairs' losses, each pair's loss
  recon + 100 * inter + 100 * intra: the reference's MSE of each image
  against the raw logits upsampled to its size (`SegFormerModel.py:133`),
  and the cosine losses on sigmoid of the last stage's carried CLS token
  (`:219-229`).
- `fewshot_seg_step`: the supervised per-domain fine-tune (ref `:44-133`):
  the dice loss of each category of a pair, with the inter/intra terms that
  the shipped reference zeroes available through `cls_loss_weight`.

Every forward runs in eval mode, the reference's quirk (`predict` calls
`model.eval()`), so no BatchNorm statistics move. The category draws stay
in the CLI. The state is updated in place; nothing in a step waits on the
host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.models.segformer import (
    forward_logits,
)
from semisupervisedobjectdetection_torch.train.common import (
    accumulate_microbatches,
    forward_masks,
    grads_of,
)
from semisupervisedobjectdetection_torch.train.state import TrainState


def cls_activation(cls_list: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """sigmoid of the last stage's carried CLS token in float32, (B, 1, C):
    the token the reference's forward returns (`modeling_segformer.py:
    848-850`) and its cosine losses see."""
    return torch.sigmoid(cls_list[-1].float())


def _cls_terms(c1: torch.Tensor, c2: torch.Tensor):
    """(inter, intra of c1, intra of c2) of two domains' activated tokens."""
    return (losses.inter_domain_loss(c1, c2), losses.intra_domain_loss(c1),
            losses.intra_domain_loss(c2))


def pair_ae_loss(model, img1: torch.Tensor, img2: torch.Tensor,
                 mse_divisor: Optional[int] = None):
    """(summation, recon1, recon2, inter) of one category pair of the
    autoencoder. The MSE divisor is the batch's B*3, or `mse_divisor` (the
    full batch's under accumulation, so that the microbatches' mean is the
    batch's MSE)."""
    div = mse_divisor if mse_divisor is not None else img1.shape[0] * 3
    logits1, cls1 = forward_logits(model, img1)
    logits2, cls2 = forward_logits(model, img2)
    recon1 = losses.mse_loss(img1, logits1, divisor=div)
    recon2 = losses.mse_loss(img2, logits2, divisor=div)
    inter, intra1, intra2 = _cls_terms(cls_activation(cls1),
                                       cls_activation(cls2))
    sum1 = recon1 + 100.0 * inter + 100.0 * intra1
    sum2 = recon2 + 100.0 * inter + 100.0 * intra2
    return (sum1 + sum2) / 2.0, recon1, recon2, inter


def _microbatches(tensors, accum: int):
    b = tensors[0].shape[0]
    return tuple(x.reshape(accum, b // accum, *x.shape[1:])
                 for x in tensors)


class FewshotAEOut(NamedTuple):
    state: TrainState
    loss: torch.Tensor
    recon_losses: torch.Tensor     # (4,) per category
    inter_losses: torch.Tensor     # (2,) per group


def fewshot_ae_step(state: TrainState, g1_img1: torch.Tensor,
                    g1_img2: torch.Tensor, g2_img1: torch.Tensor,
                    g2_img2: torch.Tensor, accum: int = 1) -> FewshotAEOut:
    """One iteration of the domain-prompt autoencoder on two category pairs
    of NHWC images (group 1's and group 2's): the mean of the two pair
    losses, one update (`segFormer_fewshot_learning.py:268-279`). A loss
    that is not finite skips it.

    `accum > 1` runs the four batches' microbatches in turn and averages
    the losses and gradients over them: the MSE keeps the full batch's
    divisor (exact), the cosine terms are means over microbatches, whose
    intra losses pair the halves of each microbatch (so each keeps at least
    2 samples)."""
    b = g1_img1.shape[0]
    full_divisor = b * 3
    params = state.trainable_params

    def loss_and_grads(a1, a2, b1, b2):
        s1, r1a, r1b, i1 = pair_ae_loss(state.model, a1, a2, full_divisor)
        s2, r2a, r2b, i2 = pair_ae_loss(state.model, b1, b2, full_divisor)
        total = (s1 + s2) / 2.0
        grads = grads_of(total, params)
        return (total.detach(), torch.stack([r1a, r1b, r2a, r2b]).detach(),
                torch.stack([i1, i2]).detach(), grads)

    images = (g1_img1, g1_img2, g2_img1, g2_img2)
    if accum <= 1:
        loss, recons, inters, grads = loss_and_grads(*images)
    else:
        if b % accum:
            raise ValueError(f"few-shot batch {b} not divisible by "
                             f"accum={accum}")
        if b // accum < 2:
            raise ValueError(
                f"few-shot AE accum={accum} leaves microbatches of "
                f"{b // accum} < 2 samples — the intra-domain cosine "
                f"loss pairs the first/second half of each microbatch")

        def micro(stats, *x):
            total, recons, inters, g = loss_and_grads(*x)
            return g, None, {"loss": total, "recons": recons,
                             "inters": inters}, total

        dev = g1_img1.device
        zero = {"loss": torch.zeros((), device=dev),
                "recons": torch.zeros(4, device=dev),
                "inters": torch.zeros(2, device=dev)}
        gsum, _, sums, _ = accumulate_microbatches(
            micro, params, state.batch_stats, zero,
            _microbatches(images, accum))
        grads = {n: g / accum for n, g in gsum.items()}
        del gsum
        loss = sums["loss"] / accum
        recons, inters = sums["recons"] / accum, sums["inters"] / accum
    state.apply_gradients(grads, loss)
    del grads
    return FewshotAEOut(state, loss, recons, inters)


def pair_seg_loss(model, img1: torch.Tensor, mask1: torch.Tensor,
                  img2: torch.Tensor, mask2: torch.Tensor,
                  cls_loss_weight: float = 0.0):
    """(total, dice 1, dice 2, masks 1) of one category pair of the
    per-domain fine-tune; with `cls_loss_weight` w > 0 each category's term
    is (dice + w * inter + w * intra) / 3 (a Python branch, as in JAX)."""
    pred1, cls1, _ = forward_masks(model, img1)
    pred2, cls2, _ = forward_masks(model, img2)
    l1 = losses.dice_loss(pred1, mask1)
    l2 = losses.dice_loss(pred2, mask2)
    if cls_loss_weight > 0.0:
        inter, intra1, intra2 = _cls_terms(cls_activation(cls1),
                                           cls_activation(cls2))
        w = cls_loss_weight
        s1 = (l1 + w * inter + w * intra1) / 3.0
        s2 = (l2 + w * inter + w * intra2) / 3.0
    else:
        s1, s2 = l1, l2
    return (s1 + s2) / 2.0, l1, l2, pred1


class FewshotSegOut(NamedTuple):
    state: TrainState
    loss: torch.Tensor
    loss_1: torch.Tensor
    loss_2: torch.Tensor
    pred_1: torch.Tensor


def fewshot_seg_step(state: TrainState, img1: torch.Tensor,
                     mask1: torch.Tensor, img2: torch.Tensor,
                     mask2: torch.Tensor, cls_loss_weight: float = 0.0,
                     accum: int = 1) -> FewshotSegOut:
    """One supervised per-domain update on a category pair of NHWC images
    and (B, H, W) masks (`segFormer_fewshot_learning.py:88-121`): the mean
    of the two categories' dice losses; with `cls_loss_weight` w > 0 each
    category's is (dice + w * inter + w * intra) / 3, the reference's
    commented-out formula (`:98-108`). A loss that is not finite skips the
    update.

    `accum > 1` runs the microbatches of both categories in turn and
    averages the losses and gradients (the dice and the cosine terms are
    means over microbatches; with cosine terms each microbatch keeps at
    least 2 samples). `pred_1` is category 1's masks over the whole
    batch."""
    params = state.trainable_params

    def loss_and_grads(i1, m1, i2, m2):
        total, l1, l2, pred1 = pair_seg_loss(state.model, i1, m1, i2, m2,
                                             cls_loss_weight)
        grads = grads_of(total, params)
        return total.detach(), l1.detach(), l2.detach(), pred1.detach(), \
            grads

    if accum <= 1:
        loss, l1, l2, pred1, grads = loss_and_grads(img1, mask1, img2,
                                                    mask2)
    else:
        b = img1.shape[0]
        if b % accum:
            raise ValueError(f"few-shot batch {b} not divisible by "
                             f"accum={accum}")
        if cls_loss_weight > 0.0 and b // accum < 2:
            raise ValueError(
                f"few-shot seg accum={accum} with cls losses leaves "
                f"microbatches of {b // accum} < 2 samples")

        def micro(stats, *x):
            total, l1, l2, pred1, g = loss_and_grads(*x)
            return g, None, {"loss": total, "l1": l1, "l2": l2}, pred1

        zero = {k: torch.zeros((), device=img1.device)
                for k in ("loss", "l1", "l2")}
        gsum, _, sums, preds = accumulate_microbatches(
            micro, params, state.batch_stats, zero,
            _microbatches((img1, mask1, img2, mask2), accum))
        grads = {n: g / accum for n, g in gsum.items()}
        del gsum
        loss, l1, l2 = (sums[k] / accum for k in ("loss", "l1", "l2"))
        pred1 = preds.reshape(b, *preds.shape[2:])
    state.apply_gradients(grads, loss)
    del grads
    return FewshotSegOut(state, loss, l1, l2, pred1)
