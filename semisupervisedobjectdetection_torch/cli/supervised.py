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
predicted mask overlays; with `--int8` or `--fp8` it serves the model's
quantized snapshot (`SegFormerModel.quantize`, or the file
`--int8-snapshot` when it exists, else written there), its loss the
binarised dice of `predict`. `--predict --sliding-raster PNG` instead
predicts one large raster through Hann-blended `--window` windows with
`--overlap` (`eval/sliding_window.py`, batches of 8) and writes
`<dump-masks>/raster_mask.png`; it reads no tiles. By default (the
reference's quirk) the forward of a train step runs in eval mode;
--no-quirks runs it in train mode.
`--tune-lr a,b,c` grid-searches the learning rate on an 80/20 split of the
train tiles (the reference's `Hyperparameter_Tuning`, `:103-144`): each
point trains a fresh model for max(epochs // 5, 1) epochs and writes no
checkpoint, and --resume is off.
`--async-checkpoint` (with --resume) writes the `_last` checkpoint on a
background thread (`checkpoint/io.py::save_last_async`), `--profile-dir`
traces the training loop with `torch.profiler`, and `--plot-curves` draws
the metrics CSV to a PNG after training.

It runs on the CUDA card unless `--device cpu` is given. `--loss bce` is
refused, as the JAX package's CLI cannot train with it: its
`segmentation_loss` has no "bce" branch (`losses.py:178`), so that CLI
raises at the first step (`predict(use_loss="bce")` computes it). Not
ported yet, and refused with a message naming ROADMAP.md: `--parallel`
other than none and `--ffn-impl`.
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
    save_last_async,
    wait_pending_saves,
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
from semisupervisedobjectdetection_torch.eval.sliding_window import (
    sliding_window_predict,
)
from semisupervisedobjectdetection_torch.utils import preemption
from semisupervisedobjectdetection_torch.utils.device import resolve_device
from semisupervisedobjectdetection_torch.utils.logging import (
    MetricLogger,
    profile_trace,
)

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
               logger: MetricLogger, loss_type: str = "dice",
               save_model: bool = True) -> List[dict]:
    """The epoch loop of the reference's `Train` (`segFormer_main.py:
    35-100`), from `segformer_last` under --resume. `save_model=False` (a
    `--tune` grid point) writes no checkpoint and neither resumes nor keeps
    a preempted state, as the reference's `Hyperparameter_Tuning(
    save_model=False)` (`:125-142`). The augmentation of an epoch and its
    train-mode draws come from (--seed, epoch) alone, so a resumed epoch
    repeats them. Returns one report per epoch, also printed
    as an `epoch_report` JSON line: the seconds of the epoch, of its train
    steps (ended by a device synchronisation), of the waits on the
    prefetcher within them, of the eval and of the checkpoint writes, the
    train images per second, the peak device memory, the SR-attention
    launches in the train steps and in the eval, and the best eval loss."""
    device = model.device
    ckpt = BestCheckpointer(args.checkpoint_dir, prefix=PREFIX)
    resume = save_model and args.resume and args.checkpoint_dir
    start_epoch, best = (_try_resume(args, model, ckpt) if resume
                         else (0, float("inf")))
    async_ckpt = getattr(args, "async_checkpoint", False)
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
            common.preempt_exit(args, [(PREFIX, model.state, best)], epoch,
                                tuning=not save_model)
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
            if save_model and args.checkpoint_dir:
                ckpt.maybe_save(model.state, epoch, train_loss, eval_loss,
                                fps)
        if resume:
            # the device-side snapshot now, the host copy and the write
            # overlapped with the next epoch under --async-checkpoint
            save = save_last_async if async_ckpt else save_last
            save(args.checkpoint_dir, PREFIX, model.state, epoch, best)
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
    if resume and async_ckpt:
        wait_pending_saves()
    return reports


def predict(model: SegFormerModel, loaders, dcfg, args) -> dict:
    """Evaluate the model on the eval tiles; with --dump-masks write each
    tile's ground-truth and predicted overlays there
    (`b{batch}_{i}_gt.png`, `..._pred.png`). A quantized model is
    evaluated through `predict` (the binarised dice of its masks), the
    float one through `eval_one_epoch`. Returns the mean eval loss and the
    number of tiles dumped."""
    losses, dumped = [], 0
    for bi, (images_u8, masks_u8) in enumerate(loaders["eval"]):
        imgs, masks = common.device_eval_batch(images_u8, masks_u8, dcfg,
                                               model.device)
        if model.quant != "none":
            loss, pred = model.predict(imgs, masks, use_loss="dice_argmax")
        else:
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


def predict_raster(model: SegFormerModel, args) -> dict:
    """--sliding-raster: the RGB raster's mask blended over windows of
    `model.predict` (`eval/sliding_window.py`, batches of 8), written as
    an 8-bit PNG to `<dump-masks>/raster_mask.png` (`figures/` without
    --dump-masks). Returns the path and the raster's size."""
    from PIL import Image

    img = np.asarray(Image.open(args.sliding_raster).convert("RGB"),
                     np.float32) / 255.0
    mask = sliding_window_predict(model.predict, img, window=args.window,
                                  overlap=args.overlap)
    out = args.dump_masks or "figures"
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "raster_mask.png")
    Image.fromarray((mask * 255).astype(np.uint8)).save(path)
    print(f"raster mask written: {path} ({img.shape[0]}x{img.shape[1]}, "
          f"window {args.window}, overlap {args.overlap}"
          + (f", {model.quant}" if model.quant != "none" else "") + ")")
    return {"path": path, "shape": img.shape[:2]}


def best_eval(reports: List[dict]) -> float:
    """A training run's objective: its best eval loss (inf without an
    epoch)."""
    return reports[-1]["best_eval_loss"] if reports else float("inf")


def tune_lr(args, cfg, dcfg, tc, loaders, device):
    """--tune-lr: per learning rate a fresh model trained on 80% of the
    train tiles and evaluated on the other 20% for max(epochs // 5, 1)
    epochs, without checkpoints; prints each point's best eval loss and
    the best point (`common.sweep_grid`). Returns (best, best point)."""
    sub = common.split_loaders(dcfg, loaders["train"].dataset, args.seed)
    common.check_grad_accum(args, sub["train"])

    def point(pt, plog):
        (lr,) = pt
        model = SegFormerModel(lr=lr, train_config=tc, config=cfg,
                               seed=args.seed, grad_accum=args.grad_accum,
                               device=device)
        return best_eval(train_loop(
            model, sub, dcfg, tc.replace(epochs=max(tc.epochs // 5, 1)),
            args, plog, args.loss, save_model=False))

    return common.sweep_grid(
        args, [(float(x),) for x in args.tune_lr.split(",") if x],
        point, tag_of=lambda p: f"lr{p[0]}",
        show_of=lambda p: f"lr={p[0]}",
        objective="best eval loss", empty_hint="check --tune-lr")


def main(argv: Optional[List[str]] = None):
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--loss", default="dice",
                   choices=["dice", "dice_argmax", "bce"])
    p.add_argument("--predict", action="store_true",
                   help="eval-only from --pretrain-weight")
    p.add_argument("--dump-masks",
                   help="with --predict: dir for GT/pred mask overlays")
    p.add_argument("--int8", action="store_true",
                   help="with --predict: serve the int8 snapshot "
                        "(SegFormerModel.quantize)")
    p.add_argument("--fp8", action="store_true",
                   help="with --predict: serve an fp8 (e4m3) snapshot")
    p.add_argument("--int8-snapshot",
                   help="with --int8/--fp8: snapshot file, loaded if it "
                        "exists (width from its dtypes), else written after "
                        "quantize()")
    p.add_argument("--sliding-raster",
                   help="with --predict: one large RGB raster, predicted "
                        "through Hann-blended sliding windows "
                        "(eval/sliding_window.py) into "
                        "<dump-masks>/raster_mask.png")
    p.add_argument("--window", type=int, default=512,
                   help="sliding-raster window size")
    p.add_argument("--overlap", type=int, default=64,
                   help="sliding-raster window overlap")
    p.add_argument("--resume", action="store_true",
                   help="write a <checkpoint-dir>/segformer_last "
                        "checkpoint (full state, epoch, best gate) every "
                        "epoch and continue from it when present")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="with --resume: write the _last checkpoint on a "
                        "background thread (a copy on the device now, the "
                        "host copy and the write overlapped with the next "
                        "epoch)")
    p.add_argument("--tune-lr",
                   help="comma-separated lrs for a grid search on an 80/20 "
                        "split")
    args = p.parse_args(argv)
    if args.loss == "bce":
        raise SystemExit(
            "--loss bce: the JAX package's supervised CLI offers it but "
            "cannot train with it: its losses.segmentation_loss has no "
            "'bce' branch (losses.py:178), so it raises at the first step; "
            "SegFormerModel.predict(use_loss='bce') computes the loss")
    common.refuse_unported(args)
    if args.int8 and args.fp8:
        raise SystemExit("--int8 and --fp8 are mutually exclusive")
    quant = "fp8" if args.fp8 else ("int8" if args.int8 else "none")
    if not args.predict and (quant != "none" or args.int8_snapshot
                             or args.sliding_raster):
        raise SystemExit("--int8, --fp8, --int8-snapshot and "
                         "--sliding-raster apply to --predict only")
    if args.int8_snapshot and quant == "none":
        raise SystemExit("--int8-snapshot needs --int8 or --fp8")
    device = resolve_device(args.device)
    cfg = common.apply_perf_preset(
        MIT_VARIANTS[args.variant](dtype=args.dtype), args)
    common.check_kernel_shapes(cfg, args, device)
    dcfg, tc = common.configs_from_args(args)
    loaders = None
    if not args.sliding_raster:   # a raster reads no tiles
        dcfg = common.ensure_data(args, dcfg)
        loaders = common.make_loaders(dcfg, args.seed)
    if not args.predict:
        common.check_grad_accum(args, loaders["train"])
    if args.tune_lr:
        return tune_lr(args, cfg, dcfg, tc, loaders, device)
    model = SegFormerModel(pretrain_weight=args.pretrain_weight,
                           train_config=tc, config=cfg,
                           hf_weights=args.hf_weights, seed=args.seed,
                           grad_accum=args.grad_accum, device=device)
    if args.predict:
        if quant != "none":
            model.load_or_quantize(quant, args.int8_snapshot)
        if args.sliding_raster:
            return predict_raster(model, args)
        return predict(model, loaders, dcfg, args)
    logger = MetricLogger(args.metrics_csv)
    try:
        with profile_trace(args.profile_dir):
            reports = train_loop(model, loaders, dcfg, tc, args, logger,
                                 args.loss)
    finally:
        logger.close()
    common.maybe_plot_curves(args)
    return reports


if __name__ == "__main__":
    preemption.install()
    main()
