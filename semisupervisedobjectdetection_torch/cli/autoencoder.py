"""Autoencoder pretraining CLI of the PyTorch port, the JAX package's
`cli/autoencoder.py` (the reference's
`main_segformer/segFormer_autoencoder_main.py`).

    python -m semisupervisedobjectdetection_torch.cli.autoencoder \\
        --synthetic --variant b0 --img-size 64 --epochs 2 --device cpu

A `num_labels=3` SegFormer learns to reconstruct tiles. Per epoch: every
labeled tile batch, then every unlabeled one (their masks unused), staged
by a background thread (decode, upload, augmentation on the device), takes
one train-mode reconstruction step
(`SegFormerModel.train_one_epoch_without_mask`: forward, the reference's
MSE, backward, Adam with NaN-skip, over --grad-accum microbatches); then
the learning-rate schedule steps, the eval tiles' MSE is taken in eval
mode, a CSV row is written, the best checkpoint is kept by train + eval
loss (the reference's gate, `:107-108`) and, under --resume, the
`segformer_autoencoder_last` checkpoint is written. Each epoch prints an
`epoch_report` JSON line. The best checkpoint warm-starts the transfer
CLI (`cli/transfer.py --pretrain-weight`), whose 1-label classifier takes
the reconstruction head's channel 0.

`--tune` sweeps lr x weight decay x scheduler gamma (--tune-lrs,
--tune-wds, --tune-gammas) on an 80/20 split of the labeled tiles as the
reference's `Hyperparameter_Tuning` (`:133-170`): the shuffled grid's first
--tune-max (9) points, each warm-started from --pretrain-weight and trained
for max(epochs // 5, 1) epochs on the labeled tiles only, without
checkpoints; --resume is ignored.

It runs on the CUDA card unless `--device cpu` is given.
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
    SUFFIX,
    best_checkpoint_name,
    save_last,
    save_state,
)
from semisupervisedobjectdetection_torch.cli import common
from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
from semisupervisedobjectdetection_torch.data.prefetch import (
    fold_in,
    prefetch_train_batches,
)
from semisupervisedobjectdetection_torch.utils import preemption
from semisupervisedobjectdetection_torch.utils.device import resolve_device
from semisupervisedobjectdetection_torch.utils.logging import MetricLogger

PREFIX = "segformer_autoencoder"


def _images_only(loader):
    """A loader's batches with their masks dropped: the autoencoder
    reconstructs the images (ref `:49-68`)."""
    return ((images_u8, None) for images_u8, _ in loader)


def train_loop(model: SegFormerModel, loaders, dcfg, tc, args,
               logger: MetricLogger, save_model: bool = True) -> List[dict]:
    """The reference's `Train` loop (`:30-131`), from
    `segformer_autoencoder_last` under --resume; the unlabeled pass runs
    where `loaders` has one. `save_model=False` (a `--tune` grid point)
    writes no checkpoint and neither resumes nor keeps a preempted state.
    The augmentation of an
    epoch and its train-mode draws come from (--seed, epoch) alone, so a
    resumed epoch repeats them. Returns one report per epoch, also printed
    as an `epoch_report` JSON line: the seconds of the epoch, of each
    loop's steps (ended by a device synchronisation) and of the waits on
    the prefetcher within them, of the eval and of the checkpoint writes,
    the train images per second, the peak device memory, the SR-attention
    launches per loop and in the eval, and the best train + eval loss with
    its checkpoint."""
    device = model.device
    best, best_path, start_epoch = float("inf"), None, 0
    resume = bool(save_model and args.resume and args.checkpoint_dir)
    if resume:
        got = model.resume(args.checkpoint_dir, PREFIX)
        if got is not None:
            start_epoch, best = got
            print(f"resumed from epoch {start_epoch} "
                  f"(best train+eval {best:.4f})")
    reports = []
    for epoch in range(start_epoch, tc.epochs):
        model.generator.manual_seed(fold_in(args.seed, 3 * epoch + 2))
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t_epoch = time.perf_counter()
        train_losses, phases, images = [], {}, [0]

        def step(imgs, _):
            loss, _ = model.train_one_epoch_without_mask(imgs, lazy=True)
            train_losses.append(loss)
            images[0] += imgs.shape[0]

        for i, flag in enumerate(("train", "unlabeled")):
            if flag not in loaders:
                continue
            batches = prefetch_train_batches(
                _images_only(loaders[flag]), fold_in(args.seed, 3 * epoch + i),
                dcfg, device, depth=args.prefetch)
            phases[flag] = common.run_phase(batches, step, device)
            if preemption.stop_requested():
                common.preempt_exit(args, [(PREFIX, model.state, best)],
                                    epoch, tuning=not save_model)
        model.scheduler_step()
        train_losses = common.host_floats(train_losses)

        k1 = common.kernel_launches()[0]
        t0 = time.perf_counter()
        eval_losses = []
        for images_u8, _ in loaders["eval"]:
            imgs, _ = common.device_eval_batch(images_u8, None, dcfg, device)
            loss, _ = model.eval_one_epoch_without_mask(imgs, lazy=True)
            eval_losses.append(loss)
        eval_losses = common.host_floats(eval_losses)
        eval_s = time.perf_counter() - t0
        eval_k1 = common.kernel_launches()[0] - k1
        # the reference logs seconds per batch here, not batches per second
        spb = eval_s / max(len(loaders["eval"]), 1)

        train_loss = float(np.mean(train_losses)) if train_losses else 0.0
        eval_loss = float(np.mean(eval_losses)) if eval_losses else 0.0
        logger.log(epoch, train_loss=train_loss, eval_loss=eval_loss,
                   sec_per_batch=spb)
        t0 = time.perf_counter()
        if train_loss + eval_loss < best:
            best = train_loss + eval_loss
            if save_model and args.checkpoint_dir:
                best_path = os.path.join(args.checkpoint_dir,
                                         best_checkpoint_name(
                                             PREFIX, epoch, train_loss,
                                             eval_loss, spb) + SUFFIX)
                save_state(best_path, model.state)
        if resume:
            save_last(args.checkpoint_dir, PREFIX, model.state, epoch, best)
        t1 = time.perf_counter()
        train_s = sum(p["s"] for p in phases.values())
        report = {
            "epoch": epoch, "epoch_s": t1 - t_epoch,
            "train_steps": sum(p["steps"] for p in phases.values()),
            "train_s": train_s, "train_images": images[0],
            "train_img_per_s": images[0] / max(train_s, 1e-9),
            "prefetch_wait_s": sum(p["wait_s"] for p in phases.values()),
            "eval_s": eval_s, "checkpoint_s": t1 - t0,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "launches_train": [sum(p["launches"][i]
                                   for p in phases.values())
                               for i in range(2)],
            "launches_eval_k1": eval_k1, "phases": phases,
            "train_loss": train_loss, "eval_loss": eval_loss,
            "best_train_plus_eval": best, "best_path": best_path}
        print("epoch_report " + json.dumps(report), flush=True)
        reports.append(report)
    return reports


def tune(args, cfg, dcfg, tc, device):
    """--tune: the labeled tiles split 80/20 (the unlabeled ones unused),
    then `common.run_tune_grid` with each point warm-started from
    --pretrain-weight, its objective the best train + eval loss. Returns
    (best, best point)."""
    dcfg = common.ensure_data(args, dcfg)
    loaders = common.make_loaders(dcfg, args.seed, flags=("train",))
    sub = common.split_loaders(dcfg, loaders["train"].dataset, args.seed)
    common.check_grad_accum(args, sub["train"])

    def run_point(tci, plog):
        model = SegFormerModel(pretrain_weight=args.pretrain_weight,
                               num_labels=3, train_config=tci, config=cfg,
                               hf_weights=args.hf_weights, seed=args.seed,
                               grad_accum=args.grad_accum, device=device)
        reports = train_loop(model, sub, dcfg, tci, args, plog,
                             save_model=False)
        return reports[-1]["best_train_plus_eval"] if reports \
            else float("inf")

    return common.run_tune_grid(args, tc, run_point,
                                objective="best train+eval")


def main(argv: Optional[List[str]] = None):
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--resume", action="store_true",
                   help="write a <checkpoint-dir>/segformer_autoencoder_last "
                        "checkpoint every epoch and continue from it when "
                        "present (ignored under --tune)")
    p.add_argument("--tune", action="store_true",
                   help="grid search lr x weight-decay x scheduler-gamma "
                        "on an 80/20 labeled split "
                        "(ref Hyperparameter_Tuning, `:133-170`)")
    p.add_argument("--tune-lrs", default="1e-4,5e-5,1e-5")
    p.add_argument("--tune-wds", default="5e-5")
    p.add_argument("--tune-gammas", default="0.97")
    p.add_argument("--tune-max", type=int, default=9,
                   help="cap on shuffled grid points (ref takes the "
                        "first 9, `:157`)")
    args = p.parse_args(argv)
    common.refuse_unported(args)
    if args.tune and args.resume:
        print("--resume is ignored under --tune (grid points must not "
              "share one _last checkpoint)")
        args.resume = False
    device = resolve_device(args.device)
    cfg = common.apply_perf_preset(
        MIT_VARIANTS[args.variant](num_labels=3, dtype=args.dtype), args)
    common.check_kernel_shapes(cfg, args, device)
    dcfg, tc = common.configs_from_args(args)
    if args.tune:
        return tune(args, cfg, dcfg, tc, device)
    dcfg = common.ensure_data(args, dcfg, need_unlabeled=True)
    loaders = common.make_loaders(dcfg, args.seed,
                                  flags=("train", "eval", "unlabeled"))
    common.check_grad_accum(args, loaders["train"])
    common.check_grad_accum(args, loaders["unlabeled"])
    model = SegFormerModel(pretrain_weight=args.pretrain_weight,
                           num_labels=3, train_config=tc, config=cfg,
                           hf_weights=args.hf_weights, seed=args.seed,
                           grad_accum=args.grad_accum, device=device)
    logger = MetricLogger(args.metrics_csv)
    try:
        return train_loop(model, loaders, dcfg, tc, args, logger)
    finally:
        logger.close()


if __name__ == "__main__":
    preemption.install()
    main()
