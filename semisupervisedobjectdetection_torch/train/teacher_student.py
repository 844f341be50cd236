"""The gradient teacher-student steps of the JAX package's
`train/teacher_student.py`, in PyTorch (the reference's
`main_segformer/segFormer_semi_teacherstudent_main.py`).

- Phase A, `pseudo_label_step`: the teacher pseudo-labels an unlabeled
  batch (confidence gate, `train/pseudo.py`) and, when `update_teacher` (a
  bool tensor on the device) is True, self-trains on the kept samples'
  dice loss; `pseudo_label_infer_step` is the same without an update or a
  backward (the reference's phase-A step is a no-op, so the CLI runs it
  under its quirks and on 3 epochs of 4).
- Phase B, `labeled_step`: one labeled batch updates both models. The
  teacher trains on dice(pred, denoised mask) (the prediction blended with
  0.2*GT - 0.1 and re-thresholded; with `denoise_label=False`, plain dice
  to GT), the student on supervise_weight * dice(student, GT) +
  (1 - supervise_weight) * dice(student, teacher mask), where the teacher
  mask comes from the teacher's forward BEFORE its update. Without
  denoising that mask is the prediction of the same forward (the JAX
  package's documented delta from the reference's fresh predict after the
  update).
- `copy_student_to_teacher`, the `--reset-teacher` hard copy, and
  `ema_update`, the mean-teacher EMA.

`accum > 1` splits the batch into microbatches run in turn: their
gradients are summed before any update, BatchNorm statistics thread
through them per model in train mode, and each model's update is gated on
its own loss (a NaN loss skips that model's update, on the device). The
states are updated in place, so nothing of a step waits on the host; a
model's update comes after every forward and backward of that model in the
step.
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


class PseudoStepOut(NamedTuple):
    teacher_state: TrainState
    loss: torch.Tensor          # teacher pseudo loss (NaN when none kept)
    n_kept: torch.Tensor        # images of the batch that pass the gate
    pseudo_mask: torch.Tensor   # (B, H, W) thresholded pseudo labels
    keep: torch.Tensor          # (B,) float32 {0, 1}


def _split(x: torch.Tensor, accum: int, what: str) -> torch.Tensor:
    b = x.shape[0]
    if b % accum:
        raise ValueError(f"{what} batch {b} not divisible by accum={accum}")
    return x.reshape(accum, b // accum, *x.shape[1:])


def _pseudo_labels(state, images, threshold, confident_threshold,
                   train_mode, generator, stats=None):
    soft, _, new_stats = forward_masks(state.model, images,
                                       train_mode=train_mode,
                                       generator=generator, stats=stats)
    labels = pseudo.threshold_pseudo_masks(
        soft, threshold, confident_threshold, allow_throw_sample=True)
    return labels, new_stats


def pseudo_label_step(teacher_state: TrainState, images: torch.Tensor,
                      update_teacher: torch.Tensor,
                      threshold: float = pseudo.PSEUDO_MASK_THRESHOLD,
                      confident_threshold: float =
                      pseudo.CONFIDENT_THRESHOLD,
                      train_mode: bool = False, accum: int = 1,
                      generator: Optional[torch.Generator] = None
                      ) -> PseudoStepOut:
    """Phase A on NHWC float images on the teacher's device: pseudo-label
    the batch and, gated by `update_teacher` (a bool tensor), one Adam
    step of the teacher on the kept samples' mean dice loss. In train mode
    the BatchNorm statistics move whatever the gate says.

    `accum > 1` runs microbatches in turn, each differentiating its
    undivided kept-sample dice sum (0 when it keeps nothing); the summed
    gradients over the pooled kept count are the full batch's gradient,
    and the loss is NaN when no microbatch kept a sample."""
    if accum > 1:
        return _pseudo_accum(teacher_state, images, update_teacher,
                             threshold, confident_threshold, train_mode,
                             generator, accum)
    labels, new_stats = _pseudo_labels(teacher_state, images, threshold,
                                       confident_threshold, train_mode,
                                       generator)
    grads = grads_of(labels.loss, teacher_state.trainable_params)
    loss = labels.loss.detach()
    teacher_state.apply_gradients(grads, loss, enable=update_teacher)
    del grads
    teacher_state.set_batch_stats(new_stats)
    return PseudoStepOut(teacher_state, loss, labels.n_kept,
                         labels.pseudo_mask, labels.keep)


def _pseudo_accum(teacher_state: TrainState, images, update_teacher,
                  threshold, confident_threshold, train_mode, generator,
                  accum: int) -> PseudoStepOut:
    xs = (_split(images, accum, "unlabeled"),)

    def micro(stats, i_mb):
        labels, new_stats = _pseudo_labels(
            teacher_state, i_mb, threshold, confident_threshold, train_mode,
            generator, stats)
        psum = torch.where(labels.n_kept > 0, labels.loss * labels.n_kept,
                           torch.zeros_like(labels.loss))
        g = grads_of(psum, teacher_state.trainable_params)
        sums = {"psum": psum.detach(), "kept": labels.n_kept}
        return g, new_stats, sums, (labels.pseudo_mask, labels.keep)

    z = torch.zeros((), device=images.device)
    gsum, new_stats, sums, (p_masks, keeps) = accumulate_microbatches(
        micro, teacher_state.trainable_params, teacher_state.batch_stats,
        {"psum": z, "kept": z}, xs)
    n_kept = sums["kept"]
    pooled = n_kept.clamp_min(1.0)
    grads = {n: g / pooled for n, g in gsum.items()}
    del gsum
    loss = torch.where(n_kept > 0, sums["psum"] / pooled,
                       torch.full_like(n_kept, float("nan")))
    teacher_state.apply_gradients(grads, loss, enable=update_teacher)
    del grads
    if train_mode:
        teacher_state.set_batch_stats(new_stats)
    b = images.shape[0]
    return PseudoStepOut(teacher_state, loss, n_kept,
                         p_masks.reshape(b, *p_masks.shape[2:]),
                         keeps.reshape(b))


@torch.no_grad()
def pseudo_label_infer_step(teacher_state: TrainState, images: torch.Tensor,
                            threshold: float = pseudo.PSEUDO_MASK_THRESHOLD,
                            confident_threshold: float =
                            pseudo.CONFIDENT_THRESHOLD,
                            train_mode: bool = False,
                            generator: Optional[torch.Generator] = None
                            ) -> PseudoStepOut:
    """Phase A without an update: one no-grad forward of the whole batch
    and its pseudo-labels (no backward, so no SR-attention backward). In
    train mode the BatchNorm statistics move, as any train-mode forward
    moves them."""
    labels, new_stats = _pseudo_labels(teacher_state, images, threshold,
                                       confident_threshold, train_mode,
                                       generator)
    teacher_state.set_batch_stats(new_stats)
    return PseudoStepOut(teacher_state, labels.loss, labels.n_kept,
                         labels.pseudo_mask, labels.keep)


class LabeledStepOut(NamedTuple):
    teacher_state: TrainState
    student_state: TrainState
    student_loss_total: torch.Tensor
    teacher_loss: torch.Tensor
    student_sup_loss: torch.Tensor
    self_supervise_loss: torch.Tensor


def _teacher_loss_and_grads(teacher: TrainState, images, ground_truth,
                            denoise_label, threshold, train_mode, generator,
                            stats=None):
    """The teacher's loss and gradients, and the student's target mask
    (detached, from this pre-update forward)."""
    pred, _, t_stats = forward_masks(teacher.model, images,
                                     train_mode=train_mode,
                                     generator=generator, stats=stats)
    if denoise_label:
        mask = pseudo.denoise_labels(pred.detach(), ground_truth, threshold)
        loss = losses.dice_loss(pred, mask)
    else:
        loss = losses.dice_loss(pred, ground_truth)
        mask = pred.detach()
    grads = grads_of(loss, teacher.trainable_params)
    return loss.detach(), mask, grads, t_stats


def _student_loss_and_grads(student: TrainState, images, ground_truth,
                            teacher_mask, supervise_weight, train_mode,
                            generator, stats=None):
    pred, _, s_stats = forward_masks(student.model, images,
                                     train_mode=train_mode,
                                     generator=generator, stats=stats)
    sup = losses.dice_loss(pred, ground_truth)
    self_sup = losses.dice_loss(pred, teacher_mask)
    total = supervise_weight * sup + (1.0 - supervise_weight) * self_sup
    grads = grads_of(total, student.trainable_params)
    return total.detach(), sup.detach(), self_sup.detach(), grads, s_stats


def labeled_step(teacher_state: TrainState, student_state: TrainState,
                 images: torch.Tensor, ground_truth: torch.Tensor,
                 supervise_weight, denoise_label: bool = True,
                 threshold: float = pseudo.PSEUDO_MASK_THRESHOLD,
                 train_mode: bool = False, accum: int = 1,
                 generator: Optional[torch.Generator] = None
                 ) -> LabeledStepOut:
    """Phase B on NHWC float images and (B, H, W) ground truth on the
    states' device: the teacher's forward, target mask and backward, the
    student's forward and backward on its mixed loss, one Adam step per
    model (each skipped when its own loss is not finite).
    `supervise_weight` is a float or a float32 scalar tensor. In train mode
    `generator` draws, for each microbatch in turn, the teacher's
    drop-path and dropout masks and then the student's."""
    supervise_weight = torch.as_tensor(supervise_weight, dtype=torch.float32,
                                       device=images.device)
    if accum > 1:
        return _labeled_accum(teacher_state, student_state, images,
                              ground_truth, supervise_weight, denoise_label,
                              threshold, train_mode, generator, accum)
    t_loss, teacher_mask, t_grads, t_stats = _teacher_loss_and_grads(
        teacher_state, images, ground_truth, denoise_label, threshold,
        train_mode, generator)
    teacher_state.apply_gradients(t_grads, t_loss)
    del t_grads
    teacher_state.set_batch_stats(t_stats)
    total, sup, self_sup, s_grads, s_stats = _student_loss_and_grads(
        student_state, images, ground_truth, teacher_mask, supervise_weight,
        train_mode, generator)
    student_state.apply_gradients(s_grads, total)
    del s_grads
    student_state.set_batch_stats(s_stats)
    return LabeledStepOut(teacher_state, student_state, total, t_loss, sup,
                          self_sup)


def _labeled_accum(teacher: TrainState, student: TrainState, images,
                   ground_truth, supervise_weight, denoise_label, threshold,
                   train_mode, generator, accum: int) -> LabeledStepOut:
    """Both models' microbatch gradients summed over every microbatch
    before either model updates (each microbatch's teacher mask comes from
    the pre-update teacher, as in the full-batch step); dice losses are
    the means of the microbatches' (dice is not linear in the batch)."""
    xs = (_split(images, accum, "labeled"),
          _split(ground_truth, accum, "labeled"))
    params = {**{"t." + n: p for n, p in teacher.trainable_params.items()},
              **{"s." + n: p for n, p in student.trainable_params.items()}}

    def micro(stats, i_mb, g_mb):
        t_loss, mask, t_g, t_stats = _teacher_loss_and_grads(
            teacher, i_mb, g_mb, denoise_label, threshold, train_mode,
            generator, stats["t"])
        total, sup, self_sup, s_g, s_stats = _student_loss_and_grads(
            student, i_mb, g_mb, mask, supervise_weight, train_mode,
            generator, stats["s"])
        grads = {**{"t." + n: g for n, g in t_g.items()},
                 **{"s." + n: g for n, g in s_g.items()}}
        new_stats = {"t": stats["t"] if t_stats is None else t_stats,
                     "s": stats["s"] if s_stats is None else s_stats}
        sums = {"t_loss": t_loss, "total": total, "sup": sup,
                "self_sup": self_sup}
        return grads, new_stats, sums, t_loss

    z = torch.zeros((), device=images.device)
    gsum, stats, sums, _ = accumulate_microbatches(
        micro, params, {"t": teacher.batch_stats, "s": student.batch_stats},
        dict.fromkeys(("t_loss", "total", "sup", "self_sup"), z), xs)
    t_loss, total, sup, self_sup = (sums[k] / accum for k in
                                    ("t_loss", "total", "sup", "self_sup"))
    for prefix, state, loss in (("t.", teacher, t_loss),
                                ("s.", student, total)):
        grads = {n: gsum.pop(prefix + n) / accum for n in state.mu}
        state.apply_gradients(grads, loss)
        del grads
        if train_mode:
            state.set_batch_stats(stats[prefix[0]])
    return LabeledStepOut(teacher, student, total, t_loss, sup, self_sup)


@torch.no_grad()
def copy_student_to_teacher(teacher_state: TrainState,
                            student_state: TrainState) -> TrainState:
    """The hard teacher reset of `--reset-teacher`, in place: the student's
    parameters and BatchNorm statistics copied into the teacher's own
    tensors (no aliasing), the teacher's Adam moments and count kept (the
    reference copies the state_dict only)."""
    s_params, s_stats = student_state.params, student_state.batch_stats
    for n, p in teacher_state.params.items():
        p.copy_(s_params[n])
    for n, b in teacher_state.batch_stats.items():
        b.copy_(s_stats[n])
    return teacher_state


@torch.no_grad()
def ema_update(teacher_state: TrainState, student_state: TrainState,
               decay=0.999) -> TrainState:
    """Mean-teacher EMA, in place: t <- decay*t + (1-decay)*s on every
    parameter and every BatchNorm statistic, in float32 (`decay` a float or
    a float32 scalar tensor)."""
    names = list(teacher_state.params)
    stats = list(teacher_state.batch_stats)
    t = [teacher_state.params[n] for n in names] + \
        [teacher_state.batch_stats[n] for n in stats]
    s_params, s_stats = student_state.params, student_state.batch_stats
    s = [s_params[n] for n in names] + [s_stats[n] for n in stats]
    decay = torch.as_tensor(decay, dtype=torch.float32, device=t[0].device)
    torch._foreach_mul_(t, decay)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - decay))
    return teacher_state
