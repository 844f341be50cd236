"""Few-shot domain-prompting CLI of the PyTorch port, the JAX package's
`cli/fewshot.py` (the reference's
`main_segformer/segFormer_fewshot_learning.py`).

    python -m semisupervisedobjectdetection_torch.cli.fewshot \\
        --synthetic --variant b0 --img-size 64 --mode ae --device cpu

A SegFormer with one CLS token per stage learns domain prompts from tiles
grouped one directory per domain (`--labeled-classified`,
`--unlabeled-classified`; with --synthetic, three synthetic domains per
group). Each iteration draws two domains with `random.Random(--seed)` and
takes the next batch of each (`few_shot_batch_size`, 2; a domain's loader
restarts when it runs out), augmented on the device:

- `--mode ae` (the reference's `train_autoencoder`, `:240-344`): one pair
  from the labeled group and one from the unlabeled group, images only, a
  3-label reconstruction; loss recon + 100 * inter + 100 * intra per pair,
  the CLS losses on sigmoid of the last stage's CLS token; 101 iterations
  an epoch by default; eval is the reconstruction MSE of the eval tiles.
- `--mode seg` (the reference's `train`, `:44-133`): one labeled pair with
  masks, 1 label, the dice loss (plus the CLS losses with
  --cls-loss-weight > 0); 35 iterations an epoch by default; eval is the
  binarised dice of the eval tiles.

Every forward runs in eval mode (the reference's quirk) and the CLS tokens
train. Per epoch: the iterations (`train/fewshot.py`, one update each, over
--grad-accum microbatches), the learning-rate schedule's step, the eval, a
CSV row, the best checkpoint (`fewshot_<mode>_epoch_...`) and, under
--resume, `fewshot_<mode>_last`, then an `epoch_report` JSON line (seconds,
waits on the staging of batches, SR-attention launches). `--predict`
evaluates --pretrain-weight instead of training. --pretrain-weight is a
warm start: weights only, fresh Adam, epoch 0. --hf-weights is not read
here, as in the JAX CLI.

It runs on the CUDA card unless `--device cpu` is given. `--tune` (the lr x
weight-decay x gamma grid) is not ported yet and is refused with a message
naming ROADMAP.md.
"""

from __future__ import annotations

import json
import os
import random
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.checkpoint.io import (
    BestCheckpointer,
    load_last,
    restore_weights,
    save_last,
)
from semisupervisedobjectdetection_torch.cli import common
from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
from semisupervisedobjectdetection_torch.data.classified import (
    category_loaders,
)
from semisupervisedobjectdetection_torch.data.prefetch import (
    DevicePrefetcher,
    fold_in,
)
from semisupervisedobjectdetection_torch.data.synthetic import (
    write_synthetic_dataset,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    forward_logits,
    init_weights,
)
from semisupervisedobjectdetection_torch.train import fewshot as fw
from semisupervisedobjectdetection_torch.train.state import TrainState
from semisupervisedobjectdetection_torch.train.supervised import eval_step
from semisupervisedobjectdetection_torch.utils import preemption
from semisupervisedobjectdetection_torch.utils.device import resolve_device
from semisupervisedobjectdetection_torch.utils.logging import MetricLogger


class RoundRobin:
    """Per-domain iterators that restart a domain's loader when it runs out
    (ref `:70-81,193-204`)."""

    def __init__(self, loaders):
        self.loaders = loaders
        self.iters = [iter(l) for l in loaders]

    def next_from(self, idx):
        try:
            return next(self.iters[idx])
        except StopIteration:
            self.iters[idx] = iter(self.loaders[idx])
            return next(self.iters[idx])


def synth_classified(args, dcfg, n_domains: int = 3):
    """Write `n_domains` synthetic domains per group (the JAX CLI's sizes
    and seeds) and point the config at them."""
    root = tempfile.mkdtemp(prefix="sso_classified_")
    size = max(dcfg.canvas, 64)
    for grp, unlab in (("labeled", False), ("unlabeled", True)):
        for d in range(n_domains):
            write_synthetic_dataset(
                os.path.join(root, grp, f"domain{d}"),
                os.path.join(root, "masks") if not unlab else None,
                n=max(args.synthetic_n // 3, 6), size=size,
                seed=args.seed + 17 * d + (100 if unlab else 0),
                unlabeled=unlab)
    return dcfg.replace(labeled_classified=os.path.join(root, "labeled"),
                        unlabeled_classified=os.path.join(root,
                                                          "unlabeled"),
                        maskdir=os.path.join(root, "masks"))


def pair_schedule(mode: str, pyrng: random.Random, rr_lab: RoundRobin,
                  rr_unlab: RoundRobin, iters: int):
    """The host batches of an epoch's iterations, drawn in order: per
    iteration `pyrng.sample(range(n), 2)` domains of a group and the next
    batch of each. `ae`: a labeled then an unlabeled pair, images only;
    `seg`: a labeled pair with masks."""

    def draw_pair(rr):
        a, b = pyrng.sample(range(len(rr.loaders)), 2)
        return rr.next_from(a), rr.next_from(b)

    for _ in range(iters):
        if mode == "ae":
            (a1, _), (a2, _) = draw_pair(rr_lab)
            (b1, _), (b2, _) = draw_pair(rr_unlab)
            yield a1, a2, b1, b2
        else:
            (a1, m1), (a2, m2) = draw_pair(rr_lab)
            yield a1, m1, a2, m2


def staged_pairs(mode: str, host_batches, seed: int, dcfg,
                 device: torch.device, depth: int):
    """The iterations' batches augmented on `device`: batch j of iteration
    idx draws its choices from `fold_in(seed, 4 * idx + j)`, so every
    --prefetch depth (0 stages inline) gives the same batches."""

    def augment(idx, j, images_u8, masks_u8):
        g = torch.Generator().manual_seed(fold_in(seed, 4 * idx + j))
        return common.device_train_batch(g, images_u8, masks_u8, dcfg,
                                         device)

    def stage(idx, *host):
        if mode == "ae":
            return tuple(augment(idx, j, x, None)[0]
                         for j, x in enumerate(host))
        a1, m1, a2, m2 = host
        return augment(idx, 0, a1, m1) + augment(idx, 1, a2, m2)

    if depth < 1:
        return (stage(i, *h) for i, h in enumerate(host_batches))
    return iter(DevicePrefetcher(host_batches, stage, depth=depth))


def build_state(args, cfg, tc, device: torch.device) -> TrainState:
    """Seeded float32 weights on `device` and a fresh state with every
    parameter trained, the CLS tokens too (the JAX CLI's `_build_state`);
    --pretrain-weight overlays its weights (a warm start: fresh Adam,
    epoch 0)."""
    model = init_weights(SegFormer(cfg),
                         torch.Generator().manual_seed(args.seed))
    state = TrainState.create(model.to(device), tc)
    if args.pretrain_weight:
        restore_weights(args.pretrain_weight, state.model)
        print("Pretrained model loaded")
    return state


@torch.no_grad()
def eval_ae_recon(state: TrainState, images: torch.Tensor) -> torch.Tensor:
    """The few-shot autoencoder's eval: the reconstruction MSE only, no
    CLS terms (`segFormer_fewshot_learning.py:303-311`)."""
    logits, _ = forward_logits(state.model, images)
    return losses.mse_loss(images, logits, divisor=images.shape[0] * 3)


def _eval_losses(state, eval_loader, dcfg, device, recon: bool
                 ) -> List[float]:
    """The eval tiles' losses: the reconstruction MSE (`recon`, the ae
    mode's) or the binarised dice (`train/supervised.py::eval_step`)."""
    out = []
    for images_u8, masks_u8 in eval_loader:
        imgs, masks = common.device_eval_batch(images_u8, masks_u8, dcfg,
                                               device)
        out.append(eval_ae_recon(state, imgs) if recon
                   else eval_step(state, imgs, masks)[0])
    return common.host_floats(out)


def train_run(args, dcfg, tc, cfg, logger: MetricLogger, eval_loader, lab,
              unlab, iters: int, device: torch.device) -> List[dict]:
    """The few-shot training run of --mode, from `fewshot_<mode>_last`
    under --resume (the pair draws then restart from
    `random.Random(seed + start_epoch)`, as in the JAX CLI). Returns one
    report per epoch, also printed as an `epoch_report` JSON line."""
    accum = max(args.grad_accum, 1)
    prefix = f"fewshot_{args.mode}"
    state = build_state(args, cfg, tc, device)
    pyrng = random.Random(args.seed)
    rr_lab, rr_unlab = RoundRobin(lab), RoundRobin(unlab)
    ckpt = BestCheckpointer(args.checkpoint_dir, prefix=prefix)
    best, start_epoch = float("inf"), 0
    resume = bool(args.resume and args.checkpoint_dir)
    if resume:
        got = load_last(args.checkpoint_dir, prefix, state)
        if got is not None:
            _, start_epoch, best = got
            ckpt.best_loss = best
            pyrng = random.Random(args.seed + start_epoch)
            print(f"resumed from epoch {start_epoch} "
                  f"(best eval {best:.4f})")
    reports = []
    for epoch in range(start_epoch, tc.epochs):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t_epoch = time.perf_counter()
        train_losses, images = [], [0]

        def step(*staged):
            if args.mode == "ae":
                out = fw.fewshot_ae_step(state, *staged, accum=accum)
            else:
                out = fw.fewshot_seg_step(state, *staged,
                                          args.cls_loss_weight, accum=accum)
            train_losses.append(out.loss)
            images[0] += sum(x.shape[0] for x in staged if x.dim() == 4)

        batches = staged_pairs(
            args.mode, pair_schedule(args.mode, pyrng, rr_lab, rr_unlab,
                                     iters),
            fold_in(args.seed, epoch), dcfg, device, args.prefetch)
        phase = common.run_phase(batches, step, device)
        if preemption.stop_requested():
            common.preempt_exit(args, [(prefix, state, best)], epoch)
        state.scheduler_step()
        train_losses = common.host_floats(train_losses)

        k1 = common.kernel_launches()[0]
        t0 = time.perf_counter()
        eval_losses = _eval_losses(state, eval_loader, dcfg, device,
                                   recon=args.mode == "ae")
        eval_s = time.perf_counter() - t0
        eval_k1 = common.kernel_launches()[0] - k1
        fps = len(eval_loader) / max(eval_s, 1e-9)
        train_loss = float(np.mean(train_losses)) if train_losses else 0.0
        eval_loss = float(np.mean(eval_losses)) if eval_losses else 0.0
        logger.log(epoch, train_loss=train_loss, eval_loss=eval_loss,
                   fps=fps)
        t0 = time.perf_counter()
        if eval_loss < best:
            best = eval_loss
            if args.checkpoint_dir:
                ckpt.maybe_save(state, epoch, train_loss, eval_loss, fps)
        if resume:
            save_last(args.checkpoint_dir, prefix, state, epoch, best)
        t1 = time.perf_counter()
        report = {
            "epoch": epoch, "mode": args.mode, "epoch_s": t1 - t_epoch,
            "train_steps": phase["steps"], "train_s": phase["s"],
            "train_images": images[0],
            "train_img_per_s": images[0] / max(phase["s"], 1e-9),
            "prefetch_wait_s": phase["wait_s"], "eval_s": eval_s,
            "checkpoint_s": t1 - t0,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
            "launches_train": phase["launches"],
            "launches_eval_k1": eval_k1, "train_loss": train_loss,
            "eval_loss": eval_loss, "best_eval_loss": best,
            "best_path": ckpt.best_path}
        print("epoch_report " + json.dumps(report), flush=True)
        reports.append(report)
    return reports


def _check_fewshot_accum(args, dcfg) -> None:
    """The few-shot steps take `few_shot_batch_size` batches, not
    --batch-size: fail fast when --grad-accum does not divide it, or leaves
    microbatches too small for the intra-domain loss's halves."""
    accum = max(args.grad_accum, 1)
    if accum <= 1:
        return
    fsb = dcfg.few_shot_batch_size
    if fsb % accum:
        raise SystemExit(
            f"--grad-accum {accum} does not divide the few-shot "
            f"batch size {fsb} (DataConfig.few_shot_batch_size)")
    if fsb // accum < 2 and (args.mode == "ae" or args.cls_loss_weight > 0.0):
        raise SystemExit(
            f"--grad-accum {accum} leaves microbatches of "
            f"{fsb // accum} < 2 samples; the intra-domain cosine "
            f"loss pairs the first/second half of each microbatch")


def main(argv: Optional[List[str]] = None):
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--mode", default="ae", choices=["ae", "seg"])
    p.add_argument("--iterations", type=int, default=0,
                   help="iterations per epoch (0 = the reference's: 101 "
                        "for ae, 35 for seg)")
    p.add_argument("--labeled-classified",
                   help="dir of labeled tiles, one subdir per domain")
    p.add_argument("--unlabeled-classified",
                   help="dir of unlabeled tiles, one subdir per domain")
    p.add_argument("--cls-loss-weight", type=float, default=0.0,
                   help="--mode seg: weight of the inter/intra CLS losses "
                        "(0, the shipped reference, leaves them out)")
    p.add_argument("--predict", action="store_true",
                   help="eval-only from --pretrain-weight (the reference's "
                        "`prediction`, `:27-41`)")
    p.add_argument("--resume", action="store_true",
                   help="write a <checkpoint-dir>/fewshot_<mode>_last "
                        "checkpoint every epoch and continue from it when "
                        "present")
    p.add_argument("--tune", action="store_true",
                   help="grid search lr x weight-decay x scheduler-gamma "
                        "(not ported)")
    p.add_argument("--tune-lrs", help="not ported")
    p.add_argument("--tune-wds", help="not ported")
    p.add_argument("--tune-gammas", help="not ported")
    p.add_argument("--tune-max", type=int, help="not ported")
    args = p.parse_args(argv)
    common.refuse_unported(args, (
        ("--tune", args.tune), ("--tune-lrs", args.tune_lrs is not None),
        ("--tune-wds", args.tune_wds is not None),
        ("--tune-gammas", args.tune_gammas is not None),
        ("--tune-max", args.tune_max is not None)))
    device = resolve_device(args.device)
    dcfg, tc = common.configs_from_args(args)
    _check_fewshot_accum(args, dcfg)
    cfg = common.apply_perf_preset(MIT_VARIANTS[args.variant](
        num_labels=3 if args.mode == "ae" else 1, cls_tokens=(1, 1, 1, 1),
        dtype=args.dtype), args)
    common.check_kernel_shapes(cfg, args, device)
    if args.labeled_classified:
        dcfg = dcfg.replace(labeled_classified=args.labeled_classified,
                            unlabeled_classified=args.unlabeled_classified)
    else:
        dcfg = synth_classified(args, dcfg)
    dcfg2 = common.ensure_data(args, dcfg)
    dcfg = dcfg.replace(evalset=dcfg2.evalset, dataset=dcfg2.dataset,
                        maskdir=dcfg.maskdir or dcfg2.maskdir)
    eval_loader = common.make_loaders(dcfg, args.seed,
                                      flags=("eval",))["eval"]
    iters = args.iterations or (101 if args.mode == "ae" else 35)

    if args.predict:
        ev = _eval_losses(build_state(args, cfg, tc, device), eval_loader,
                          dcfg, device, recon=False)
        mean = float(np.mean(ev)) if ev else 0.0
        print(f"eval loss: {mean:.4f} (dice ~ {1 - mean:.4f})")
        return {"eval_loss": mean}

    lab = category_loaders(dcfg, "labeled", args.seed)
    unlab = category_loaders(dcfg, "unlabeled", args.seed)
    print(f"{len(lab)} labeled domains, {len(unlab)} unlabeled domains")
    logger = MetricLogger(args.metrics_csv)
    try:
        return train_run(args, dcfg, tc, cfg, logger, eval_loader, lab,
                         unlab, iters, device)
    finally:
        logger.close()


if __name__ == "__main__":
    preemption.install()
    main()
