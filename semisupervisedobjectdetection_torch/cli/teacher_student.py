"""Teacher-student semi-supervised training CLI of the PyTorch port, the
`--ema-mode` loop of the JAX package's `cli/teacher_student.py`.

    python -m semisupervisedobjectdetection_torch.cli.teacher_student \\
        --ema-mode --synthetic --variant b0 --img-size 64 --epochs 2 \\
        --device cpu

Per epoch: every (labeled, unlabeled) batch pair, staged by a background
thread (decode, upload, augmentation on the device), takes one EMA
mean-teacher step (`train/ema.py::ema_semi_step`: the teacher's no-grad
forward, pseudo-labels and label denoising, the student's forward and
backward, Adam, the teacher's EMA of the student); then both learning-rate
schedules step, both models are evaluated (binarised-dice loss, mIoU), a
CSV row is written, each model's best checkpoint is kept and, under
`--resume`, both `_last` checkpoints are written. By default (the
reference's quirk) the student's forward runs in train mode: drop-path,
classifier dropout and BatchNorm on batch statistics.

It runs on the CUDA card unless `--device cpu` is given. Not ported yet, and
refused with a message naming ROADMAP.md: the gradient teacher-student loop
(no `--ema-mode`), `--tune`, `--int8-teacher`, `--async-checkpoint`,
`--reset-teacher`, `--parallel` other than none, `--pretrain-weight`,
`--hf-weights`, `--profile-dir`, `--plot-curves` and `--ffn-impl`.
"""

from __future__ import annotations

import copy
import json
import time
from typing import List, Optional

import numpy as np
import torch

from semisupervisedobjectdetection_torch.checkpoint.io import (
    BestCheckpointer,
    has_last,
    load_last,
    save_last,
)
from semisupervisedobjectdetection_torch.cli import common
from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
from semisupervisedobjectdetection_torch.data.prefetch import (
    fold_in,
    prefetch_paired_batches,
)
from semisupervisedobjectdetection_torch.eval.metrics import (
    binary_miou,
    per_image_miou,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    init_weights,
)
from semisupervisedobjectdetection_torch.ops.sr_attention import (
    sr_attention,
    sr_attention_bwd,
)
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


def train_run(args, dcfg, tc, loaders, cfg, logger, device, *, teacher_lr,
              student_lr, supervise_weight, threshold, epochs):
    """One teacher-student run from seeded weights (or its `_last`
    checkpoints under --resume); returns the per-epoch reports of
    `_ema_train_loop`."""
    model = init_weights(SegFormer(cfg),
                         torch.Generator().manual_seed(args.seed))
    teacher = TrainState.create(copy.deepcopy(model).to(device), tc,
                                lr=teacher_lr)
    student = TrainState.create(model.to(device), tc, lr=student_lr)
    ckpt_s = BestCheckpointer(args.checkpoint_dir, "ts_student")
    ckpt_t = BestCheckpointer(args.checkpoint_dir, "ts_teacher")
    start_epoch, best_s, best_t = _try_resume(args, teacher, student,
                                              ckpt_s, ckpt_t)
    return _ema_train_loop(args, dcfg, tc, loaders, logger, device,
                           teacher=teacher, student=student,
                           sup_w=supervise_weight, threshold=threshold,
                           epochs=epochs, ckpt_s=ckpt_s, ckpt_t=ckpt_t,
                           start_epoch=start_epoch, best_s=best_s,
                           best_t=best_t,
                           save_model=bool(args.checkpoint_dir))


def _launches():
    return sr_attention.launches, sr_attention_bwd.launches


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _ema_train_loop(args, dcfg, tc, loaders, logger, device, *, teacher,
                    student, sup_w, threshold, epochs, ckpt_s, ckpt_t,
                    start_epoch=0, best_s=float("inf"),
                    best_t=float("inf"), save_model=True) -> List[dict]:
    """The EMA mean-teacher loop. Unlabeled batches restart from their
    loader when the labeled loader is longer. Per-step metrics stay on the
    device until one read per epoch. Returns one report per epoch: the
    seconds of the epoch, of its train steps (ended by a device
    synchronisation), of the waits on the prefetcher within them, of the
    eval and of the checkpoint writes, the train images per second, the
    peak device memory, and the launches of the SR-attention kernels in the
    train steps and in the eval."""
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
        k1, k2 = _launches()
        wait_s, images = 0.0, 0
        t_epoch = t0 = time.perf_counter()
        batches = prefetch_paired_batches(
            loaders["train"], loaders["pseudo"], aug_seed, dcfg, device,
            depth=args.prefetch)
        try:
            while True:
                t = time.perf_counter()
                staged = next(batches, None)
                wait_s += time.perf_counter() - t
                if staged is None:
                    break
                imgs, masks, u_imgs = staged
                out = ema_semi_step(
                    teacher, student, u_imgs, imgs, masks, sup_w, args.ema,
                    denoise_label=not args.no_denoise, threshold=threshold,
                    train_mode=train_mode, accum=accum, generator=generator)
                images += imgs.shape[0] + u_imgs.shape[0]
                s_losses.append(out.student_loss_total)
                kept.append(out.n_kept)
                p_losses.append(out.pseudo_loss)
                if preemption.stop_requested():
                    break
        finally:
            batches.close()
        _sync(device)
        train_s = time.perf_counter() - t0
        train_k1, train_k2 = (a - b for a, b in zip(_launches(), (k1, k2)))
        if preemption.stop_requested():
            _preempt_exit(args, teacher, student, epoch, best_s, best_t)
        teacher.scheduler_step()
        student.scheduler_step()
        s_losses = common.host_floats(s_losses)
        images_used = int(sum(common.host_floats(kept)))
        p_losses = [x for x in common.host_floats(p_losses)
                    if np.isfinite(x)]

        k1 = _launches()[0]
        t0 = time.perf_counter()
        ev_s, ev_t, mious, pi_mious = [], [], [], []
        for images_u8, masks_u8 in loaders["eval"]:
            imgs, masks = common.device_eval_batch(images_u8, masks_u8,
                                                   dcfg, device)
            tl, _ = eval_step(teacher, imgs, masks)
            sl, pred = eval_step(student, imgs, masks)
            ev_t.append(tl)
            ev_s.append(sl)
            mious.append(binary_miou(pred, masks))
            pi_mious.append(per_image_miou(pred, masks))
        ev_t, ev_s = common.host_floats(ev_t), common.host_floats(ev_s)
        mious = common.host_floats(mious)
        pi_mious = common.host_floats(pi_mious)
        eval_s = time.perf_counter() - t0
        eval_k1 = _launches()[0] - k1
        fps = len(loaders["eval"]) / max(eval_s, 1e-9)

        train_loss = float(np.mean(s_losses)) if s_losses else 0.0
        eval_loss = float(np.mean(ev_s)) if ev_s else 0.0
        teacher_eval = float(np.mean(ev_t)) if ev_t else 0.0
        logger.log(epoch, train_loss=train_loss, eval_loss=eval_loss,
                   teacher_eval=teacher_eval, images_used=images_used,
                   pseudo_loss=float(np.mean(p_losses)) if p_losses
                   else 0.0,
                   miou=float(np.mean(mious)) if mious else 0.0,
                   miou_per_image=(float(np.mean(pi_mious))
                                   if pi_mious else 0.0),
                   fps=fps)
        print(f"epoch {epoch}: {images_used} unlabeled images used "
              f"(ema), student eval {eval_loss:.4f}")
        t0 = time.perf_counter()
        if eval_loss < best_s:
            best_s = eval_loss
            if save_model:
                ckpt_s.maybe_save(student, epoch, train_loss, eval_loss,
                                  fps)
        if teacher_eval < best_t:
            best_t = teacher_eval
            if save_model:
                ckpt_t.maybe_save(teacher, epoch, train_loss, teacher_eval,
                                  fps)
        _save_lasts(args, teacher, student, epoch, best_s, best_t)
        t1 = time.perf_counter()
        report = {
            "epoch": epoch, "epoch_s": t1 - t_epoch,
            "train_steps": len(s_losses),
            "train_s": train_s, "train_images": images,
            "train_img_per_s": images / max(train_s, 1e-9),
            "prefetch_wait_s": wait_s, "eval_s": eval_s,
            "checkpoint_s": t1 - t0,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "launches_train": [train_k1, train_k2],
            "launches_eval_k1": eval_k1}
        print("epoch_report " + json.dumps(report), flush=True)
        reports.append(report)
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


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--teacher-lr", type=float, default=5e-7)
    p.add_argument("--student-lr", type=float, default=3e-5)
    p.add_argument("--supervise-weight", type=float, default=0.8)
    p.add_argument("--threshold", type=float, default=0.75,
                   help="pseudo-mask threshold")
    p.add_argument("--no-denoise", action="store_true")
    p.add_argument("--reset-teacher", action="store_true",
                   help="hard copy student->teacher every 5 epochs (the "
                        "gradient loop's; not ported)")
    p.add_argument("--ema", type=float, default=0.0,
                   help="EMA decay of the teacher (0 = 0.999 under "
                        "--ema-mode)")
    p.add_argument("--ema-mode", action="store_true",
                   help="run the mean-teacher loop (train/ema.py): a "
                        "per-step EMA with decay --ema, no teacher "
                        "gradients (the only loop ported)")
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
    common.refuse_unported(args, (
        ("the gradient teacher-student loop (no --ema-mode)",
         not args.ema_mode),
        ("--tune", args.tune), ("--int8-teacher", args.int8_teacher),
        ("--async-checkpoint", args.async_checkpoint),
        ("--reset-teacher", args.reset_teacher)))
    device = resolve_device(args.device)
    if args.ema <= 0:
        args.ema = 0.999          # mean-teacher default decay
    dcfg, tc = common.configs_from_args(args)
    dcfg = common.ensure_data(args, dcfg, need_unlabeled=True)
    loaders = common.make_loaders(dcfg, args.seed,
                                  flags=("train", "eval", "pseudo"))
    # the EMA step splits both halves of the pair into microbatches
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
