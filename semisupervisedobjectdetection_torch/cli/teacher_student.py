"""Teacher-student semi-supervised training CLI of the PyTorch port, the
JAX package's `cli/teacher_student.py` (the reference's
`main_segformer/segFormer_semi_teacherstudent_main.py`).

    python -m semisupervisedobjectdetection_torch.cli.teacher_student \\
        --synthetic --variant b0 --img-size 64 --epochs 2 --device cpu

Two loops, each per epoch:

- the gradient loop (the default, the reference's own workload): phase A,
  every unlabeled batch through the teacher (`pseudo_label_step`, a
  self-training update on every 4th epoch without the reference's
  quirks; `pseudo_label_infer_step`, no update, otherwise); phase B, every
  labeled batch through `labeled_step`, which trains both models (the
  teacher on its denoised labels, the student on the ground truth and the
  teacher's mask); then both learning-rate schedules step, `--ema` > 0
  pulls the teacher towards the student once, and `--reset-teacher`
  copies the student into the teacher every 5 epochs;
- `--ema-mode`: every (labeled, unlabeled) batch pair takes one EMA
  mean-teacher step (`train/ema.py::ema_semi_step`); then both schedules
  step.

Batches are staged by a background thread (decode, upload, augmentation on
the device). After the train steps both models are evaluated
(binarised-dice loss, mIoU), a CSV row is written, each model's best
checkpoint is kept and, under `--resume`, both `_last` checkpoints are
written; each epoch prints an `epoch_report` JSON line. By default (the
reference's quirk) the forwards of the train steps run in train mode:
drop-path, classifier dropout and BatchNorm on batch statistics.
`--pretrain-weight` (a port checkpoint) and `--hf-weights` warm-start both
models with fresh Adam state at epoch 0.

It runs on the CUDA card unless `--device cpu` is given. Not ported yet, and
refused with a message naming ROADMAP.md: `--tune`, `--int8-teacher`,
`--async-checkpoint`, `--parallel` other than none, `--profile-dir`,
`--plot-curves` and `--ffn-impl`.
"""

from __future__ import annotations

import copy
import json
import time
from typing import List, Optional

import numpy as np
import torch

from semisupervisedobjectdetection_torch.checkpoint.convert import (
    load_torch_checkpoint,
)
from semisupervisedobjectdetection_torch.checkpoint.io import (
    BestCheckpointer,
    has_last,
    load_last,
    merge_restore,
    restore_weights,
    save_last,
)
from semisupervisedobjectdetection_torch.cli import common
from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
from semisupervisedobjectdetection_torch.data.prefetch import (
    fold_in,
    prefetch_paired_batches,
    prefetch_train_batches,
)
from semisupervisedobjectdetection_torch.eval.metrics import (
    binary_miou,
    per_image_miou,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    init_weights,
)
from semisupervisedobjectdetection_torch.train import teacher_student as ts
from semisupervisedobjectdetection_torch.train.ema import ema_semi_step
from semisupervisedobjectdetection_torch.train.state import TrainState
from semisupervisedobjectdetection_torch.train.supervised import eval_step
from semisupervisedobjectdetection_torch.utils import preemption
from semisupervisedobjectdetection_torch.utils.device import resolve_device
from semisupervisedobjectdetection_torch.utils.logging import MetricLogger


def _preempt_exit(args, teacher, student, epoch, best_s, best_t):
    """Mid-epoch preemption: save both `_last` checkpoints and exit 0
    (`--resume` redoes the epoch)."""
    common.preempt_exit(args, [("ts_teacher", teacher, best_t),
                               ("ts_student", student, best_s)], epoch)


@torch.no_grad()
def _warm_start(model, args) -> None:
    """--hf-weights, then --pretrain-weight, into `model` in place, before
    any train state is made for it: weights and BatchNorm statistics
    wherever name and shape match (a wider classifier through its channel
    0), by the partial-load rule of `checkpoint/io.py::restore_weights`."""
    if args.hf_weights:
        saved = load_torch_checkpoint(args.hf_weights, model.cfg)
        model.load_state_dict(merge_restore(model.state_dict(), saved),
                              strict=True)
    if args.pretrain_weight:
        restore_weights(args.pretrain_weight, model)


def train_run(args, dcfg, tc, loaders, cfg, logger, device, *, teacher_lr,
              student_lr, supervise_weight, threshold, epochs):
    """One teacher-student run from seeded weights, warm-started by
    --hf-weights and --pretrain-weight (weights and BatchNorm statistics
    into both models, fresh Adam, epoch 0), or from its `_last` checkpoints
    under --resume; returns the per-epoch reports of its loop."""
    model = init_weights(SegFormer(cfg),
                         torch.Generator().manual_seed(args.seed))
    if args.hf_weights or args.pretrain_weight:
        _warm_start(model, args)
        print("warm-started teacher+student from",
              args.pretrain_weight or args.hf_weights)
    teacher = TrainState.create(copy.deepcopy(model).to(device), tc,
                                lr=teacher_lr)
    student = TrainState.create(model.to(device), tc, lr=student_lr)
    ckpt_s = BestCheckpointer(args.checkpoint_dir, "ts_student")
    ckpt_t = BestCheckpointer(args.checkpoint_dir, "ts_teacher")
    start_epoch, best_s, best_t = _try_resume(args, teacher, student,
                                              ckpt_s, ckpt_t)
    loop = _ema_train_loop if args.ema_mode else _grad_train_loop
    return loop(args, dcfg, tc, loaders, logger, device, teacher=teacher,
                student=student, sup_w=supervise_weight,
                threshold=threshold, epochs=epochs, ckpt_s=ckpt_s,
                ckpt_t=ckpt_t, start_epoch=start_epoch, best_s=best_s,
                best_t=best_t, save_model=bool(args.checkpoint_dir))


def _eval_models(teacher, student, loaders, dcfg, device) -> dict:
    """Both models' binarised-dice eval losses and the student's mIoU over
    the eval tiles, read once; with the seconds and K1 launches."""
    k1 = common.kernel_launches()[0]
    t0 = time.perf_counter()
    ev_s, ev_t, mious, pi_mious = [], [], [], []
    for images_u8, masks_u8 in loaders["eval"]:
        imgs, masks = common.device_eval_batch(images_u8, masks_u8, dcfg,
                                               device)
        tl, _ = eval_step(teacher, imgs, masks)
        sl, pred = eval_step(student, imgs, masks)
        ev_t.append(tl)
        ev_s.append(sl)
        mious.append(binary_miou(pred, masks))
        pi_mious.append(per_image_miou(pred, masks))
    out = {k: float(np.mean(common.host_floats(v))) if v else 0.0
           for k, v in (("student", ev_s), ("teacher", ev_t),
                        ("miou", mious), ("miou_per_image", pi_mious))}
    out["s"] = time.perf_counter() - t0
    out["k1"] = common.kernel_launches()[0] - k1
    out["fps"] = len(loaders["eval"]) / max(out["s"], 1e-9)
    return out


def _keep_best(ckpt_s, ckpt_t, teacher, student, epoch, train_loss, ev,
               best_s, best_t, save_model):
    """Each model's best checkpoint on its own eval loss (ref `:175-186`):
    returns the new (best_s, best_t)."""
    if ev["student"] < best_s:
        best_s = ev["student"]
        if save_model:
            ckpt_s.maybe_save(student, epoch, train_loss, best_s, ev["fps"])
    if ev["teacher"] < best_t:
        best_t = ev["teacher"]
        if save_model:
            ckpt_t.maybe_save(teacher, epoch, train_loss, best_t, ev["fps"])
    return best_s, best_t


def _report(epoch, t_epoch, phases, images, ev, checkpoint_s, device,
            **extra) -> dict:
    """The epoch's `epoch_report`, printed and returned: the seconds of the
    epoch, of its train steps (`phases` summed) and of the waits on the
    prefetcher within them, of the eval and of the checkpoint writes, the
    train images per second, the peak device memory, and the launches of
    the SR-attention kernels in the train steps and in the eval."""
    train_s = sum(p["s"] for p in phases)
    report = {
        "epoch": epoch, "epoch_s": time.perf_counter() - t_epoch,
        "train_steps": sum(p["steps"] for p in phases),
        "train_s": train_s, "train_images": images,
        "train_img_per_s": images / max(train_s, 1e-9),
        "prefetch_wait_s": sum(p["wait_s"] for p in phases),
        "eval_s": ev["s"], "checkpoint_s": checkpoint_s,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
        "launches_train": [sum(p["launches"][i] for p in phases)
                           for i in range(2)],
        "launches_eval_k1": ev["k1"], **extra}
    print("epoch_report " + json.dumps(report), flush=True)
    return report


def _grad_train_loop(args, dcfg, tc, loaders, logger, device, *, teacher,
                     student, sup_w, threshold, epochs, ckpt_s, ckpt_t,
                     start_epoch=0, best_s=float("inf"),
                     best_t=float("inf"), save_model=True) -> List[dict]:
    """The gradient teacher-student loop (JAX `train_run`, `:106-213`).
    Phase A pseudo-labels the unlabeled loader; on an update epoch (every
    4th, without the reference's quirks, whose phase-A update is a no-op)
    the teacher self-trains on it. Phase B trains both models on the
    labeled loader. In train mode (the quirks) one generator per epoch
    draws every forward's masks, phase A's and then phase B's. Per-step
    metrics stay on the device until one read per epoch. Returns one
    report per epoch, with each phase's seconds, steps, waits and K1/K2
    launches and the teacher's Adam count after phase A."""
    train_mode = tc.reference_quirks
    accum = max(args.grad_accum, 1)
    sup_w = torch.tensor(sup_w, dtype=torch.float32, device=device)
    enable = torch.ones((), dtype=torch.bool, device=device)
    denoise = not args.no_denoise
    reports = []
    for epoch in range(start_epoch, epochs):
        # the epoch's draws come from (--seed, epoch) alone, so a resumed
        # epoch repeats them
        generator = torch.Generator(device=device).manual_seed(
            fold_in(args.seed, 3 * epoch + 2)) if train_mode else None
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t_epoch = time.perf_counter()
        update_epoch = epoch % 4 == 0 and not tc.reference_quirks
        kept, p_losses, s_losses, t_losses = [], [], [], []
        images = [0]

        def phase_a(u_imgs, _):
            if update_epoch:
                out = ts.pseudo_label_step(
                    teacher, u_imgs, enable, threshold=threshold,
                    train_mode=train_mode, accum=accum, generator=generator)
            else:
                out = ts.pseudo_label_infer_step(
                    teacher, u_imgs, threshold=threshold,
                    train_mode=train_mode, generator=generator)
            images[0] += u_imgs.shape[0]
            kept.append(out.n_kept)
            p_losses.append(out.loss)

        def phase_b(imgs, masks):
            out = ts.labeled_step(teacher, student, imgs, masks, sup_w,
                                  denoise_label=denoise, threshold=threshold,
                                  train_mode=train_mode, accum=accum,
                                  generator=generator)
            images[0] += imgs.shape[0]
            s_losses.append(out.student_loss_total)
            t_losses.append(out.teacher_loss)

        a = common.run_phase(prefetch_train_batches(
            loaders["pseudo"], fold_in(args.seed, 3 * epoch), dcfg, device,
            depth=args.prefetch), phase_a, device)
        a.update(update=update_epoch, teacher_adam_count=int(teacher.count))
        if preemption.stop_requested():
            _preempt_exit(args, teacher, student, epoch, best_s, best_t)
        images_used = int(sum(common.host_floats(kept)))
        print(f"epoch {epoch}: {images_used} unlabeled images used")
        b = common.run_phase(prefetch_train_batches(
            loaders["train"], fold_in(args.seed, 3 * epoch + 1), dcfg,
            device, depth=args.prefetch), phase_b, device)
        if preemption.stop_requested():
            _preempt_exit(args, teacher, student, epoch, best_s, best_t)
        teacher.scheduler_step()
        student.scheduler_step()
        if args.ema > 0:
            ts.ema_update(teacher, student, args.ema)
        s_losses = common.host_floats(s_losses)
        t_losses = common.host_floats(t_losses)
        p_losses = [x for x in common.host_floats(p_losses)
                    if np.isfinite(x)]

        ev = _eval_models(teacher, student, loaders, dcfg, device)
        train_loss = float(np.mean(s_losses)) if s_losses else 0.0
        logger.log(epoch, train_loss=train_loss, eval_loss=ev["student"],
                   teacher_train=(float(np.mean(t_losses)) if t_losses
                                  else 0.0),
                   teacher_eval=ev["teacher"], images_used=images_used,
                   miou=ev["miou"], miou_per_image=ev["miou_per_image"],
                   fps=ev["fps"])
        t0 = time.perf_counter()
        best_s, best_t = _keep_best(ckpt_s, ckpt_t, teacher, student, epoch,
                                    train_loss, ev, best_s, best_t,
                                    save_model)
        reset = args.reset_teacher and epoch != 0 and epoch % 5 == 0
        if reset:
            ts.copy_student_to_teacher(teacher, student)
            print("!!! teacher reset !!!")
        _save_lasts(args, teacher, student, epoch, best_s, best_t)
        reports.append(_report(
            epoch, t_epoch, (a, b), images[0], ev,
            time.perf_counter() - t0, device, phase_a=a, phase_b=b,
            pseudo_loss=(float(np.mean(p_losses)) if p_losses else None),
            teacher_reset=reset))
    return reports


def _ema_train_loop(args, dcfg, tc, loaders, logger, device, *, teacher,
                    student, sup_w, threshold, epochs, ckpt_s, ckpt_t,
                    start_epoch=0, best_s=float("inf"),
                    best_t=float("inf"), save_model=True) -> List[dict]:
    """The EMA mean-teacher loop. Unlabeled batches restart from their
    loader when the labeled loader is longer. Per-step metrics stay on the
    device until one read per epoch. Returns one report per epoch."""
    train_mode = tc.reference_quirks
    accum = max(args.grad_accum, 1)
    reports = []
    for epoch in range(start_epoch, epochs):
        # the epoch's draws come from (--seed, epoch) alone, so a resumed
        # epoch repeats them
        aug_seed = fold_in(args.seed, 2 * epoch)
        generator = torch.Generator(device=device).manual_seed(
            fold_in(args.seed, 2 * epoch + 1)) if train_mode else None
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        s_losses, p_losses, kept = [], [], []
        images = [0]
        t_epoch = time.perf_counter()

        def step(imgs, masks, u_imgs):
            out = ema_semi_step(
                teacher, student, u_imgs, imgs, masks, sup_w, args.ema,
                denoise_label=not args.no_denoise, threshold=threshold,
                train_mode=train_mode, accum=accum, generator=generator)
            images[0] += imgs.shape[0] + u_imgs.shape[0]
            s_losses.append(out.student_loss_total)
            kept.append(out.n_kept)
            p_losses.append(out.pseudo_loss)

        phase = common.run_phase(prefetch_paired_batches(
            loaders["train"], loaders["pseudo"], aug_seed, dcfg, device,
            depth=args.prefetch), step, device)
        if preemption.stop_requested():
            _preempt_exit(args, teacher, student, epoch, best_s, best_t)
        teacher.scheduler_step()
        student.scheduler_step()
        s_losses = common.host_floats(s_losses)
        images_used = int(sum(common.host_floats(kept)))
        p_losses = [x for x in common.host_floats(p_losses)
                    if np.isfinite(x)]

        ev = _eval_models(teacher, student, loaders, dcfg, device)
        train_loss = float(np.mean(s_losses)) if s_losses else 0.0
        logger.log(epoch, train_loss=train_loss, eval_loss=ev["student"],
                   teacher_eval=ev["teacher"], images_used=images_used,
                   pseudo_loss=float(np.mean(p_losses)) if p_losses
                   else 0.0,
                   miou=ev["miou"], miou_per_image=ev["miou_per_image"],
                   fps=ev["fps"])
        print(f"epoch {epoch}: {images_used} unlabeled images used "
              f"(ema), student eval {ev['student']:.4f}")
        t0 = time.perf_counter()
        best_s, best_t = _keep_best(ckpt_s, ckpt_t, teacher, student, epoch,
                                    train_loss, ev, best_s, best_t,
                                    save_model)
        _save_lasts(args, teacher, student, epoch, best_s, best_t)
        reports.append(_report(epoch, t_epoch, (phase,), images[0], ev,
                               time.perf_counter() - t0, device))
    return reports


def _try_resume(args, teacher, student, ckpt_s, ckpt_t):
    """Restore `ts_{teacher,student}_last` into the states when --resume is
    set and both exist: returns (start_epoch, best_s, best_t). The
    augmentation and train-mode draws of an epoch come from (--seed,
    epoch), so a resumed epoch repeats them."""
    if not (args.resume and args.checkpoint_dir and all(
            has_last(args.checkpoint_dir, p)
            for p in ("ts_teacher", "ts_student"))):
        return 0, float("inf"), float("inf")
    _, _, best_t = load_last(args.checkpoint_dir, "ts_teacher", teacher)
    _, start_epoch, best_s = load_last(args.checkpoint_dir, "ts_student",
                                       student)
    ckpt_t.best_loss, ckpt_s.best_loss = best_t, best_s
    print(f"resumed teacher+student from epoch {start_epoch} "
          f"(best student eval {best_s:.4f}, teacher {best_t:.4f})")
    return start_epoch, best_s, best_t


def _save_lasts(args, teacher, student, epoch, best_s, best_t):
    """Write both `_last` resume checkpoints (only under --resume: the B5
    full-state write costs seconds per epoch)."""
    if not (args.resume and args.checkpoint_dir):
        return
    save_last(args.checkpoint_dir, "ts_teacher", teacher, epoch, best_t)
    save_last(args.checkpoint_dir, "ts_student", student, epoch, best_s)


def parse_args(argv: Optional[List[str]] = None):
    """The CLI's flags; under --ema-mode an --ema of 0 takes the
    mean-teacher default decay 0.999 (the gradient loop keeps 0: no EMA)."""
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--teacher-lr", type=float, default=5e-7)
    p.add_argument("--student-lr", type=float, default=3e-5)
    p.add_argument("--supervise-weight", type=float, default=0.8)
    p.add_argument("--threshold", type=float, default=0.75,
                   help="pseudo-mask threshold")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--reset-teacher", action="store_true",
                   help="hard copy student->teacher every 5 epochs (the "
                        "gradient loop only)")
    p.add_argument("--ema", type=float, default=0.0,
                   help="EMA decay of the teacher (0 = 0.999 under "
                        "--ema-mode; no EMA in the gradient loop)")
    p.add_argument("--ema-mode", action="store_true",
                   help="run the mean-teacher loop (train/ema.py): a "
                        "per-step EMA with decay --ema, no teacher "
                        "gradients (default: the gradient loop)")
    p.add_argument("--int8-teacher", action="store_true",
                   help="int8 teacher forwards (not ported)")
    p.add_argument("--resume", action="store_true",
                   help="write ts_{teacher,student}_last checkpoints every "
                        "epoch and continue from them when present")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write the _last checkpoints on a background "
                        "thread (not ported)")
    p.add_argument("--tune", action="store_true",
                   help="grid over supervise_weight x threshold (not "
                        "ported)")
    args = p.parse_args(argv)
    if args.ema_mode and args.ema <= 0:
        args.ema = 0.999          # mean-teacher default decay
    return args


def main(argv: Optional[List[str]] = None) -> List[dict]:
    args = parse_args(argv)
    common.refuse_unported(args, (
        ("--tune", args.tune), ("--int8-teacher", args.int8_teacher),
        ("--async-checkpoint", args.async_checkpoint)))
    device = resolve_device(args.device)
    dcfg, tc = common.configs_from_args(args)
    dcfg = common.ensure_data(args, dcfg, need_unlabeled=True)
    loaders = common.make_loaders(dcfg, args.seed,
                                  flags=("train", "eval", "pseudo"))
    # both loops split the labeled and the unlabeled batches into
    # microbatches (the gradient loop's phase A on its update epochs)
    common.check_grad_accum(args, loaders["train"])
    common.check_grad_accum(args, loaders["pseudo"])
    cfg = common.apply_perf_preset(
        MIT_VARIANTS[args.variant](dtype=args.dtype), args)
    logger = MetricLogger(args.metrics_csv)
    try:
        return train_run(args, dcfg, tc, loaders, cfg, logger, device,
                         teacher_lr=args.teacher_lr,
                         student_lr=args.student_lr,
                         supervise_weight=args.supervise_weight,
                         threshold=args.threshold, epochs=tc.epochs)
    finally:
        logger.close()


if __name__ == "__main__":
    preemption.install()
    main()
