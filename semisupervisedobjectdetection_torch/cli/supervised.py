"""Supervised SegFormer fine-tune CLI of the PyTorch port, the JAX package's
`cli/supervised.py` (the reference's `main_segformer/segFormer_main.py`).

    python -m semisupervisedobjectdetection_torch.cli.supervised \\
        --synthetic --variant b0 --img-size 64 --epochs 2 --device cpu

Per epoch: every labeled batch, staged by a background thread (decode,
upload, augmentation on the device), takes one supervised step
(`SegFormerModel.train_one_epoch`: forward, dice loss, backward, Adam with
NaN-skip, over --grad-accum microbatches); then the learning-rate schedule
steps, the model is evaluated (binarised-dice loss, dice, mIoU), a CSV row
is written, the best checkpoint is kept and, under --resume, the `_last`
checkpoint is written. Per-step metrics stay on the device until one read
per epoch. `--predict` evaluates a checkpoint (--pretrain-weight) instead
of training, and `--dump-masks` writes each eval tile's ground-truth and
predicted mask overlays. By default (the reference's quirk) the forward of
a train step runs in eval mode; --no-quirks runs it in train mode.

It runs on the CUDA card unless `--device cpu` is given. Not ported yet, and
refused with a message naming ROADMAP.md: `--loss bce`, `--int8`, `--fp8`,
`--int8-snapshot`, `--sliding-raster`, `--tune-lr`, `--async-checkpoint`,
`--parallel` other than none, `--profile-dir`, `--plot-curves` and
`--ffn-impl`.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint.io import (
    BestCheckpointer,
    save_last,
)
from semisupervisedobjectdetection_torch.cli import common
from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
from semisupervisedobjectdetection_torch.data.prefetch import (
    fold_in,
    prefetch_train_batches,
)
from semisupervisedobjectdetection_torch.eval.metrics import (
    binary_miou,
    dice_score,
    per_image_miou,
)
from semisupervisedobjectdetection_torch.utils import preemption
from semisupervisedobjectdetection_torch.utils.device import resolve_device
from semisupervisedobjectdetection_torch.utils.logging import MetricLogger

PREFIX = "segformer"


def _try_resume(args, model: SegFormerModel, ckpt: BestCheckpointer):
    """Restore `segformer_last` into the model when --resume is set and it
    exists: returns (start_epoch, best)."""
    got = None
    if args.resume and args.checkpoint_dir:
        got = model.resume(args.checkpoint_dir, PREFIX)
    if got is None:
        return 0, float("inf")
    start_epoch, best = got
    ckpt.best_loss = best
    print(f"resumed from epoch {start_epoch} (best eval {best:.4f})")
    return start_epoch, best


def train_loop(model: SegFormerModel, loaders, dcfg, tc, args,
               logger: MetricLogger, loss_type: str = "dice"
               ) -> List[dict]:
    """The epoch loop of the reference's `Train` (`segFormer_main.py:
    35-100`), from `segformer_last` under --resume. The augmentation of an
    epoch and its train-mode draws come from (--seed, epoch) alone, so a
    resumed epoch repeats them. Returns one report per epoch, also printed
    as an `epoch_report` JSON line: the seconds of the epoch, of its train
    steps (ended by a device synchronisation), of the waits on the
    prefetcher within them, of the eval and of the checkpoint writes, the
    train images per second, the peak device memory, the SR-attention
    launches in the train steps and in the eval, and the best eval loss."""
    device = model.device
    ckpt = BestCheckpointer(args.checkpoint_dir, prefix=PREFIX)
    start_epoch, best = _try_resume(args, model, ckpt)
    reports = []
    for epoch in range(start_epoch, tc.epochs):
        model.generator.manual_seed(fold_in(args.seed, 2 * epoch + 1))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        train_losses = []
        k1, k2 = common.kernel_launches()
        wait_s, images = 0.0, 0
        t_epoch = t0 = time.perf_counter()
        batches = prefetch_train_batches(
            loaders["train"], fold_in(args.seed, 2 * epoch), dcfg, device,
            depth=args.prefetch)
        try:
            while True:
                t = time.perf_counter()
                staged = next(batches, None)
                wait_s += time.perf_counter() - t
                if staged is None:
                    break
                imgs, masks = staged
                loss, _ = model.train_one_epoch(imgs, masks,
                                                use_loss=loss_type,
                                                lazy=True)
                images += imgs.shape[0]
                train_losses.append(loss)
                if preemption.stop_requested():
                    break
        finally:
            batches.close()
        common.sync(device)
        train_s = time.perf_counter() - t0
        train_k1, train_k2 = (a - b for a, b in
                              zip(common.kernel_launches(), (k1, k2)))
        if preemption.stop_requested():
            common.preempt_exit(args, [(PREFIX, model.state, best)], epoch)
        model.scheduler_step()
        train_losses = common.host_floats(train_losses)

        k1 = common.kernel_launches()[0]
        t0 = time.perf_counter()
        eval_losses, dices, mious, pi_mious = [], [], [], []
        for images_u8, masks_u8 in loaders["eval"]:
            imgs, masks = common.device_eval_batch(images_u8, masks_u8,
                                                   dcfg, device)
            loss, pred = model.eval_one_epoch(imgs, masks, lazy=True)
            eval_losses.append(loss)
            dices.append(dice_score(pred, masks))
            mious.append(binary_miou(pred, masks))
            pi_mious.append(per_image_miou(pred, masks))
        eval_losses = common.host_floats(eval_losses)
        dices, mious = common.host_floats(dices), common.host_floats(mious)
        pi_mious = common.host_floats(pi_mious)
        eval_s = time.perf_counter() - t0
        eval_k1 = common.kernel_launches()[0] - k1
        fps = len(loaders["eval"]) / max(eval_s, 1e-9)

        train_loss = float(np.mean(train_losses)) if train_losses else 0.0
        eval_loss = float(np.mean(eval_losses)) if eval_losses else 0.0
        logger.log(epoch, train_loss=train_loss, eval_loss=eval_loss,
                   dice=float(np.mean(dices)) if dices else 0.0,
                   miou=float(np.mean(mious)) if mious else 0.0,
                   miou_per_image=(float(np.mean(pi_mious))
                                   if pi_mious else 0.0),
                   fps=fps, lr=float(model.state.lr))
        t0 = time.perf_counter()
        if eval_loss < best:
            best = eval_loss
            if args.checkpoint_dir:
                ckpt.maybe_save(model.state, epoch, train_loss, eval_loss,
                                fps)
        if args.resume and args.checkpoint_dir:
            save_last(args.checkpoint_dir, PREFIX, model.state, epoch, best)
        t1 = time.perf_counter()
        report = {
            "epoch": epoch, "epoch_s": t1 - t_epoch,
            "train_steps": len(train_losses), "train_s": train_s,
            "train_images": images,
            "train_img_per_s": images / max(train_s, 1e-9),
            "prefetch_wait_s": wait_s, "eval_s": eval_s,
            "checkpoint_s": t1 - t0,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "launches_train": [train_k1, train_k2],
            "launches_eval_k1": eval_k1, "best_eval_loss": best,
            "best_path": ckpt.best_path}
        print("epoch_report " + json.dumps(report), flush=True)
        reports.append(report)
    return reports


def predict(model: SegFormerModel, loaders, dcfg, args) -> dict:
    """Evaluate the model on the eval tiles; with --dump-masks write each
    tile's ground-truth and predicted overlays there
    (`b{batch}_{i}_gt.png`, `..._pred.png`). Returns the mean eval loss
    and the number of tiles dumped."""
    losses, dumped = [], 0
    for bi, (images_u8, masks_u8) in enumerate(loaders["eval"]):
        imgs, masks = common.device_eval_batch(images_u8, masks_u8, dcfg,
                                               model.device)
        loss, pred = model.eval_one_epoch(imgs, masks)
        losses.append(float(loss))
        if args.dump_masks:
            host_imgs = imgs.cpu().numpy()
            host_masks = masks.cpu().numpy()
            for i in range(host_imgs.shape[0]):
                stem = os.path.join(args.dump_masks, f"b{bi:03d}_{i:02d}")
                model.show_mask(stem + "_gt.png", host_imgs[i],
                                host_masks[i])
                model.show_mask(stem + "_pred.png", host_imgs[i], pred[i])
                dumped += 1
    mean = float(np.mean(losses)) if losses else 0.0
    print(f"eval loss: {mean:.4f} (dice ~ {1 - mean:.4f})"
          + (f"; dumped {dumped} mask overlays" if dumped else ""))
    return {"eval_loss": mean, "dumped": dumped}


def main(argv: Optional[List[str]] = None):
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--loss", default="dice",
                   choices=["dice", "dice_argmax", "bce"])
    p.add_argument("--predict", action="store_true",
                   help="eval-only from --pretrain-weight")
    p.add_argument("--dump-masks",
                   help="with --predict: dir for GT/pred mask overlays")
    p.add_argument("--int8", action="store_true",
                   help="with --predict: int8 serving (not ported)")
    p.add_argument("--fp8", action="store_true",
                   help="with --predict: fp8 serving (not ported)")
    p.add_argument("--int8-snapshot",
                   help="persisted quantized snapshot (not ported)")
    p.add_argument("--sliding-raster",
                   help="with --predict: one large raster through "
                        "sliding windows (not ported)")
    p.add_argument("--resume", action="store_true",
                   help="write a <checkpoint-dir>/segformer_last "
                        "checkpoint (full state, epoch, best gate) every "
                        "epoch and continue from it when present")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write the _last checkpoint on a background "
                        "thread (not ported)")
    p.add_argument("--tune-lr",
                   help="comma-separated lrs for a grid search (not "
                        "ported)")
    args = p.parse_args(argv)
    common.refuse_unported(args, (
        ("--loss bce", args.loss == "bce"), ("--int8", args.int8),
        ("--fp8", args.fp8), ("--int8-snapshot", bool(args.int8_snapshot)),
        ("--sliding-raster", bool(args.sliding_raster)),
        ("--tune-lr", bool(args.tune_lr)),
        ("--async-checkpoint", args.async_checkpoint)))
    device = resolve_device(args.device)
    cfg = common.apply_perf_preset(
        MIT_VARIANTS[args.variant](dtype=args.dtype), args)
    common.check_kernel_shapes(cfg, args, device)
    dcfg, tc = common.configs_from_args(args)
    dcfg = common.ensure_data(args, dcfg)
    loaders = common.make_loaders(dcfg, args.seed)
    if not args.predict:
        common.check_grad_accum(args, loaders["train"])
    model = SegFormerModel(pretrain_weight=args.pretrain_weight,
                           train_config=tc, config=cfg,
                           hf_weights=args.hf_weights, seed=args.seed,
                           grad_accum=args.grad_accum, device=device)
    if args.predict:
        return predict(model, loaders, dcfg, args)
    logger = MetricLogger(args.metrics_csv)
    try:
        return train_loop(model, loaders, dcfg, tc, args, logger, args.loss)
    finally:
        logger.close()


if __name__ == "__main__":
    preemption.install()
    main()
