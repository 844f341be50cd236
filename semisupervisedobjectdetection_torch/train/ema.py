"""The EMA (mean-teacher) semi-supervised step, the JAX package's
`train/ema.py` in PyTorch.

One step: a no-grad teacher forward over the unlabeled and labeled batches
(one concatenated forward when their shapes match), confidence-thresholded
pseudo-labels of the unlabeled batch (a quality metric and the kept count),
the denoised teacher mask of the labeled batch, one student forward and
backward on

    supervise_weight * dice(student, GT)
    + (1 - supervise_weight) * dice(student, denoised teacher mask),

an Adam update with NaN-skip, and the EMA of the teacher towards the
updated student on params and BatchNorm statistics. `accum > 1` splits both
batches into microbatch pairs whose student gradients are averaged before
the one update.

With `train_mode=True` (the CLI's default, the reference's quirk) the
student's forward runs in train mode: drop-path and classifier dropout
drawn from the step's `torch.Generator` (each microbatch draws its own),
and BatchNorm on batch statistics, whose running averages the student keeps
(threaded through the microbatches as sequential forwards would) and the
teacher's EMA then follows. The teacher's forward stays in eval mode.

The states are updated in place (the teacher's and student's models are
trained where they lie); the returned `EmaStepOut` holds the same states.
The int8 teacher (`ema_semi_step_int8`) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.train import pseudo
from semisupervisedobjectdetection_torch.train.common import (
    accumulate_microbatches,
    forward_masks,
    grads_of,
)
from semisupervisedobjectdetection_torch.train.state import TrainState
from semisupervisedobjectdetection_torch.train.teacher_student import (
    ema_update,
)


class EmaStepOut(NamedTuple):
    teacher_state: TrainState
    student_state: TrainState
    student_loss_total: torch.Tensor   # w*sup + (1-w)*self_sup
    student_sup_loss: torch.Tensor
    self_supervise_loss: torch.Tensor
    pseudo_loss: torch.Tensor          # NaN when no sample is kept
    n_kept: torch.Tensor               # unlabeled images passing the gate
    pseudo_mask: torch.Tensor          # (Bu, H, W) thresholded pseudo labels


@torch.no_grad()
def _teacher_soft_masks(teacher: TrainState, unlabeled: torch.Tensor,
                        images: torch.Tensor):
    """The teacher's soft masks of both batches, from one concatenated
    forward when the spatial shapes match."""
    if unlabeled.shape[1:] == images.shape[1:]:
        soft, _, _ = forward_masks(teacher.model,
                                   torch.cat([unlabeled, images]))
        return soft[:unlabeled.shape[0]], soft[unlabeled.shape[0]:]
    return (forward_masks(teacher.model, unlabeled)[0],
            forward_masks(teacher.model, images)[0])


def _targets(teacher, unlabeled, images, ground_truth, denoise_label,
             threshold, confident_threshold):
    u_soft, l_soft = _teacher_soft_masks(teacher, unlabeled, images)
    labels = pseudo.threshold_pseudo_masks(
        u_soft, threshold, confident_threshold, allow_throw_sample=True)
    teacher_mask = pseudo.denoise_labels(l_soft, ground_truth, threshold) \
        if denoise_label else l_soft
    return labels, teacher_mask


def _student_loss_and_grads(student: TrainState, images, ground_truth,
                            teacher_mask, supervise_weight, train_mode,
                            generator, stats=None):
    params = student.params
    pred, _, new_stats = forward_masks(student.model, images,
                                       train_mode=train_mode,
                                       generator=generator, stats=stats)
    sup = losses.dice_loss(pred, ground_truth)
    self_sup = losses.dice_loss(pred, teacher_mask)
    total = supervise_weight * sup + (1.0 - supervise_weight) * self_sup
    grads = grads_of(total, params)
    return total.detach(), sup.detach(), self_sup.detach(), grads, new_stats


@torch.no_grad()
def _set_batch_stats(state: TrainState, stats) -> None:
    if stats is not None:
        live = state.batch_stats
        for n, t in stats.items():
            live[n].copy_(t)


def _ema_semi_impl(teacher: TrainState, student: TrainState, unlabeled,
                   images, ground_truth, supervise_weight, ema_decay,
                   denoise_label, threshold, confident_threshold,
                   train_mode, generator) -> EmaStepOut:
    labels, teacher_mask = _targets(teacher, unlabeled, images,
                                    ground_truth, denoise_label, threshold,
                                    confident_threshold)
    total, sup, self_sup, grads, new_stats = _student_loss_and_grads(
        student, images, ground_truth, teacher_mask, supervise_weight,
        train_mode, generator)
    student.apply_gradients(grads, total)
    del grads
    _set_batch_stats(student, new_stats)
    ema_update(teacher, student, ema_decay)
    return EmaStepOut(teacher, student, total, sup, self_sup, labels.loss,
                      labels.n_kept, labels.pseudo_mask)


def _ema_semi_accum(teacher: TrainState, student: TrainState, unlabeled,
                    images, ground_truth, supervise_weight, ema_decay,
                    denoise_label, threshold, confident_threshold,
                    train_mode, generator, accum: int) -> EmaStepOut:
    """Both batches split into `accum` microbatch pairs, in order: student
    gradients and losses averaged, one update and one EMA. The pseudo-label
    metric pools as the full batch would (per-sample dice sums and kept
    counts are summed before the division by the kept count, NaN when no
    microbatch kept a sample). In train mode each microbatch draws its own
    masks from `generator` in turn, and the BatchNorm statistics thread
    through the microbatches."""
    bu, bl = unlabeled.shape[0], images.shape[0]
    if bu % accum or bl % accum:
        raise ValueError(f"batches ({bu} unlabeled, {bl} labeled) not "
                         f"divisible by accum={accum}")
    xs = (unlabeled.reshape(accum, bu // accum, *unlabeled.shape[1:]),
          images.reshape(accum, bl // accum, *images.shape[1:]),
          ground_truth.reshape(accum, bl // accum, *ground_truth.shape[1:]))

    def micro(stats, u_mb, i_mb, g_mb):
        labels, teacher_mask = _targets(teacher, u_mb, i_mb, g_mb,
                                        denoise_label, threshold,
                                        confident_threshold)
        total, sup, self_sup, g, new_stats = _student_loss_and_grads(
            student, i_mb, g_mb, teacher_mask, supervise_weight, train_mode,
            generator, stats)
        sums = dict(total=total, sup=sup, self_sup=self_sup,
                    p_sum=torch.where(labels.n_kept > 0,
                                      labels.loss * labels.n_kept,
                                      torch.zeros_like(labels.loss)),
                    kept=labels.n_kept)
        return g, new_stats, sums, labels.pseudo_mask

    z = torch.zeros((), device=images.device)
    sums_zero = dict(total=z, sup=z, self_sup=z, p_sum=z, kept=z)
    gsum, stats, sums, p_masks = accumulate_microbatches(
        micro, student.params, student.batch_stats, sums_zero, xs)
    grads = {n: g / accum for n, g in gsum.items()}
    del gsum
    total, sup, self_sup = (sums["total"] / accum, sums["sup"] / accum,
                            sums["self_sup"] / accum)
    n_kept = sums["kept"]
    pseudo_loss = torch.where(n_kept > 0,
                              sums["p_sum"] / n_kept.clamp_min(1.0),
                              torch.full_like(n_kept, float("nan")))
    student.apply_gradients(grads, total)
    del grads
    if train_mode:
        _set_batch_stats(student, stats)
    ema_update(teacher, student, ema_decay)
    return EmaStepOut(teacher, student, total, sup, self_sup, pseudo_loss,
                      n_kept, p_masks.reshape(bu, *p_masks.shape[2:]))


def ema_semi_step(teacher_state: TrainState, student_state: TrainState,
                  unlabeled: torch.Tensor, images: torch.Tensor,
                  ground_truth: torch.Tensor, supervise_weight,
                  ema_decay, denoise_label: bool = True,
                  threshold: float = pseudo.PSEUDO_MASK_THRESHOLD,
                  confident_threshold: float = pseudo.CONFIDENT_THRESHOLD,
                  train_mode: bool = False, accum: int = 1,
                  generator: Optional[torch.Generator] = None
                  ) -> EmaStepOut:
    """One EMA semi-supervised step on NHWC float images (unlabeled and
    labeled) and (B, H, W) ground truth, all on the states' device.
    `supervise_weight` and `ema_decay` are floats or float32 scalars; the
    models carry their configs. `generator` (on the images' device) draws
    the student's train-mode masks. Nothing in the step waits on the
    host."""
    dev = images.device
    supervise_weight = torch.as_tensor(supervise_weight, dtype=torch.float32,
                                       device=dev)
    ema_decay = torch.as_tensor(ema_decay, dtype=torch.float32, device=dev)
    args = (teacher_state, student_state, unlabeled, images, ground_truth,
            supervise_weight, ema_decay, denoise_label, threshold,
            confident_threshold, train_mode, generator)
    if accum > 1:
        return _ema_semi_accum(*args, accum)
    return _ema_semi_impl(*args)
