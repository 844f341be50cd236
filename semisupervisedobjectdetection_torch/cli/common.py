"""Shared plumbing of the port's training CLIs, the part of the JAX
package's `cli/common.py` that the supervised, transfer, teacher-student
autoencoder and few-shot loops read: the argument parser (the same flags
and defaults, plus `--device`), the configs from the flags, synthetic data,
the tile loaders and the 80/20 split of the `--tune` paths, the `--tune`
sweep (`sweep_grid`, `run_tune_grid`), the batch checks, the check that
the SR-attention kernels take the configuration's shapes, the preemption
exit, the staging of host batches on the device, the timed run of a loop's
phase, and the kernel-launch counts of an epoch report.

Flags whose paths are not ported yet are refused by `refuse_unported`
with a `SystemExit` that names ROADMAP.md; none of them falls back to
something else.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, List, Tuple

import torch

from semisupervisedobjectdetection_torch.core.config import (
    DataConfig,
    MIT_VARIANTS,
    TrainConfig,
    product_grid,
)
from semisupervisedobjectdetection_torch.data.augment import (
    augment_batch,
    eval_batch,
)
from semisupervisedobjectdetection_torch.data.loader import (
    TileLoader,
    split_dataset,
)
from semisupervisedobjectdetection_torch.data.prefetch import upload
from semisupervisedobjectdetection_torch.data.synthetic import (
    write_synthetic_dataset,
)
from semisupervisedobjectdetection_torch.data.tiles import TileDataset
from semisupervisedobjectdetection_torch.utils.logging import MetricLogger


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--dataset", help="labeled train tile dir")
    p.add_argument("--evalset", help="labeled eval tile dir")
    p.add_argument("--maskdir", help="mask dir")
    p.add_argument("--unlabeledset", help="unlabeled tile dir")
    p.add_argument("--pseudoset", help="unlabeled tiles for pseudo-labels")
    p.add_argument("--synthetic", action="store_true",
                   help="generate synthetic tiles (no real data needed)")
    p.add_argument("--synthetic-n", type=int, default=24)
    p.add_argument("--variant", default="b0", choices=sorted(MIT_VARIANTS),
                   help="MiT encoder size (the reference uses b5)")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=0,
                   help="0 = DataConfig default")
    p.add_argument("--epochs", type=int, default=0,
                   help="0 = TrainConfig default (50)")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--scheduler", type=float, default=None,
                   help="ExponentialLR gamma")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--pretrain-weight",
                   help="port checkpoint (.pt) to warm-start from: weights "
                        "and BatchNorm statistics, fresh Adam, epoch 0")
    p.add_argument("--hf-weights",
                   help="local torch .pth/.safetensors SegFormer weights "
                        "(HF key layout)")
    p.add_argument("--metrics-csv", help="CSV metrics path")
    p.add_argument("--plot-curves", action="store_true",
                   help="render --metrics-csv to a PNG (not ported yet)")
    p.add_argument("--profile-dir", help="profiler trace dir (not ported "
                   "yet; utils/profile_forward.py profiles the step)")
    p.add_argument("--no-quirks", action="store_true",
                   help="disable reference-quirk parity (the student's "
                        "forward runs in eval mode)")
    p.add_argument("--reference-eval-aug", action="store_true",
                   help="quirk: run the random augmentation chain at eval "
                        "time too, as the reference does")
    p.add_argument("--skip-bad-tiles", action="store_true",
                   help="substitute a readable tile (with a one-time "
                        "warning) when one fails to decode, instead of "
                        "stopping the run")
    p.add_argument("--cache-tiles", type=float, default=0.0, metavar="MB",
                   help="LRU-cache decoded tiles in host RAM up to this "
                        "many megabytes, one budget shared by all the "
                        "run's datasets (~1 MB per 512² labeled tile)")
    p.add_argument("--perf", action="store_true",
                   help="throughput preset: tanh-approximate GELU, the "
                        "benched config (exact-erf GELU stays the default "
                        "for mIoU-parity runs)")
    p.add_argument("--prefetch", type=int, default=1,
                   help="train-batch prefetch depth: a background thread "
                        "decodes, uploads and augments this many batches "
                        "ahead of the running step; 0 stages inline")
    p.add_argument("--parallel", default="none",
                   choices=["none", "dp", "fsdp", "tp", "pp", "dp_pp"],
                   help="multi-device strategy; only 'none' is ported")
    p.add_argument("--tp", type=int, default=2,
                   help="tp-axis size for --parallel tp (not ported)")
    p.add_argument("--dp", type=int, default=2,
                   help="replica groups for --parallel dp_pp (not ported)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient accumulation: split each batch into N "
                        "microbatches run in turn before one optimizer "
                        "step (the activation memory of one microbatch)")
    p.add_argument("--ffn-impl", default=None,
                   choices=["xla", "collective"],
                   help="MixFFN dataflow override (not ported)")
    return p


def refuse_unported(args, extra: Tuple[Tuple[str, bool], ...] = ()) -> None:
    """Raise SystemExit naming ROADMAP.md when a flag asks for a path the
    port does not have yet. `extra` adds (flag, is_set) pairs of one CLI."""
    asked = [
        ("--parallel " + str(args.parallel), args.parallel != "none"),
        ("--ffn-impl", args.ffn_impl is not None),
        ("--profile-dir", bool(args.profile_dir)),
        ("--plot-curves", args.plot_curves),
    ] + list(extra)
    refused = [flag for flag, on in asked if on]
    if refused:
        raise SystemExit(
            f"{', '.join(refused)}: not ported to the PyTorch package yet; "
            "ROADMAP.md lists what waits (Queue 1)")


def check_kernel_shapes(cfg, args, device: torch.device) -> None:
    """SystemExit, before any model is built, when the SR-attention kernels
    would refuse `cfg`'s shapes at --img-size on `device` (a head width
    they do not take; both dtypes take any Nk). The CLIs never fall back to
    the plain attention on the card."""
    from semisupervisedobjectdetection_torch.models.segformer import (
        check_attention_kernels,
    )

    try:
        check_attention_kernels(cfg, args.img_size, args.img_size, device)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def kernel_launches() -> Tuple[int, int]:
    """The launches of SR-attention's forward and backward kernels so
    far."""
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention,
        sr_attention_bwd,
    )

    return sr_attention.launches, sr_attention_bwd.launches


def sync(device: torch.device) -> None:
    """Wait for the card, so that a host clock read after it covers the
    queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_phase(batches, step: Callable, device: torch.device) -> dict:
    """Feed every staged batch of `batches` to `step` until they end or a
    preemption is asked for. Returns the seconds (ended by a device
    synchronisation), the seconds waited on the prefetcher within them,
    the steps, and the K1 and K2 launches."""
    from semisupervisedobjectdetection_torch.utils import preemption

    k0 = kernel_launches()
    wait_s, steps = 0.0, 0
    t0 = time.perf_counter()
    try:
        while True:
            t = time.perf_counter()
            staged = next(batches, None)
            wait_s += time.perf_counter() - t
            if staged is None:
                break
            step(*staged)
            steps += 1
            if preemption.stop_requested():
                break
    finally:
        batches.close()
    sync(device)
    return {"s": time.perf_counter() - t0, "wait_s": wait_s,
            "steps": steps,
            "launches": [a - b for a, b in
                         zip(kernel_launches(), k0)]}


def apply_perf_preset(cfg, args):
    """--perf, the benched config: the tanh-approximate GELU. (The JAX
    package's preset also sets a scan unroll, which has no PyTorch
    meaning.)"""
    if args.perf:
        cfg = cfg.replace(gelu_approx=True)
    return cfg


def configs_from_args(args) -> Tuple[DataConfig, TrainConfig]:
    dcfg = DataConfig(
        dataset=args.dataset, evalset=args.evalset, maskdir=args.maskdir,
        unlabeledset=args.unlabeledset, pseudoset=args.pseudoset,
        img_h=args.img_size, img_w=args.img_size,
        canvas=max(args.img_size, 64),
        crop=max(int(args.img_size * 500 / 512), 32),
    )
    if args.batch_size:
        dcfg = dcfg.replace(batch_size=args.batch_size)
    if args.reference_eval_aug:
        dcfg = dcfg.replace(reference_eval_aug=True)
    if args.skip_bad_tiles:
        dcfg = dcfg.replace(bad_tile_policy="substitute")
    if args.cache_tiles > 0:
        dcfg = dcfg.replace(cache_mb=args.cache_tiles)
    tc = TrainConfig()
    if args.epochs:
        tc = tc.replace(epochs=args.epochs)
    if args.lr is not None:
        tc = tc.replace(lr=args.lr)
    if args.weight_decay is not None:
        tc = tc.replace(weight_decay=args.weight_decay)
    if args.scheduler is not None:
        tc = tc.replace(lr_decay=args.scheduler)
    if args.no_quirks:
        tc = tc.replace(reference_quirks=False)
    return dcfg, tc


def ensure_data(args, dcfg: DataConfig, need_unlabeled: bool = False
                ) -> DataConfig:
    """Write synthetic datasets to a temporary directory when --synthetic
    (or no dataset) is given."""
    if not args.synthetic and dcfg.dataset:
        return dcfg
    root = tempfile.mkdtemp(prefix="sso_synth_")
    size = max(dcfg.canvas, 64)
    write_synthetic_dataset(os.path.join(root, "train"),
                            os.path.join(root, "masks"),
                            n=args.synthetic_n, size=size, seed=args.seed)
    write_synthetic_dataset(os.path.join(root, "eval"),
                            os.path.join(root, "masks"),
                            n=max(args.synthetic_n // 3, 4), size=size,
                            seed=args.seed + 1)
    upd = dict(dataset=os.path.join(root, "train"),
               evalset=os.path.join(root, "eval"),
               maskdir=os.path.join(root, "masks"))
    if need_unlabeled:
        write_synthetic_dataset(os.path.join(root, "unlabeled"), None,
                                n=args.synthetic_n, size=size,
                                seed=args.seed + 2, unlabeled=True)
        upd["unlabeledset"] = os.path.join(root, "unlabeled")
        upd["pseudoset"] = os.path.join(root, "unlabeled")
    print(f"synthetic dataset at {root}")
    return dcfg.replace(**upd)


def check_grad_accum(args, train_loader) -> None:
    """Fail fast on a batch the training step cannot divide: --batch-size
    not a multiple of --grad-accum, a batch clamped to a small dataset's
    size by `make_loaders`, or a partial final batch under
    drop_last=False."""
    accum = max(args.grad_accum, 1)
    if accum <= 1:
        return
    label = f"--grad-accum {accum}"
    bs = train_loader.batch_size
    if bs % accum:
        raise SystemExit(
            f"{label} does not divide the effective train batch {bs} (a "
            f"--batch-size smaller than the dataset may have been clamped "
            f"to the dataset size); use a divisor of the effective batch")
    if (not train_loader.drop_last and train_loader.num_shards == 1
            and len(train_loader.dataset) % bs):
        raise SystemExit(
            f"{label} with drop_last=False would hit a partial final batch "
            f"of {len(train_loader.dataset) % bs}; enable drop_last")


def preempt_exit(args, saves, epoch: int, *, tuning: bool = False):
    """Checkpoint and exit 0 after a preemption signal stopped a training
    loop mid-epoch (`utils/preemption.py`; the loops poll
    `preemption.stop_requested()` between batches).

    `saves` is [(prefix, state, best_loss), ...] and `epoch` the
    interrupted epoch: the `_last` sidecar records epoch - 1, so a
    `--resume` restart redoes the partial epoch from its start, with the
    same augmentation (the loops derive it from the seed and the epoch).
    Saved even without --resume: preemption is when the state must
    survive. A `--tune` grid point (`tuning`, passed by each caller) is a
    throwaway run: its state is not written, so no later `--resume` starts
    from it."""
    from semisupervisedobjectdetection_torch.checkpoint.io import save_last
    from semisupervisedobjectdetection_torch.utils import preemption

    if tuning:
        saves = []
    wrote = []
    if args.checkpoint_dir:
        for prefix, state, best in saves:
            save_last(args.checkpoint_dir, prefix, state, epoch - 1, best)
            wrote.append(f"{prefix}_last")
    msg = f"preempted ({preemption.signal_name()}) during epoch {epoch}: "
    if wrote:
        msg += (f"wrote {', '.join(wrote)} to {args.checkpoint_dir}; "
                f"restart with --resume to continue from epoch {epoch}")
    elif tuning:
        msg += "tune grid point state NOT saved (rerun the sweep)"
    else:
        msg += "no --checkpoint-dir set, training state NOT saved"
    print(msg, flush=True)
    raise SystemExit(0)


def make_loaders(dcfg: DataConfig, seed: int = 0,
                 flags=("train", "eval")) -> dict:
    """Python tile loaders by flag. (The JAX package's native C++ loader is
    not ported yet; ROADMAP.md Queue 1.)"""
    out = {}
    for flag in flags:
        if flag == "train":
            ds = TileDataset(dcfg.dataset, dcfg.maskdir, canvas=dcfg.canvas,
                             cache_mb=dcfg.cache_mb)
        elif flag == "eval":
            ds = TileDataset(dcfg.evalset, dcfg.maskdir, canvas=dcfg.canvas,
                             cache_mb=dcfg.cache_mb)
        elif flag == "unlabeled":
            ds = TileDataset(dcfg.unlabeledset, None, canvas=dcfg.canvas,
                             has_mask=False, cache_mb=dcfg.cache_mb)
        elif flag == "pseudo":
            ds = TileDataset(dcfg.pseudoset, None, canvas=dcfg.canvas,
                             has_mask=False, cache_mb=dcfg.cache_mb)
        else:
            raise ValueError(flag)
        # drop_last would give an empty loader when the dataset is smaller
        # than one batch (tiny synthetic runs): clamp the batch instead
        bs = min(dcfg.batch_size, max(len(ds), 1))
        out[flag] = TileLoader(ds, bs, shuffle=dcfg.shuffle,
                               drop_last=dcfg.drop_last, seed=seed,
                               on_bad_tile=dcfg.bad_tile_policy)
    return out


def split_loaders(dcfg: DataConfig, dataset, seed: int) -> dict:
    """80/20 train/eval loaders over one labeled dataset, the split of the
    `--tune` paths (the reference's hyperparameter-tuning split)."""
    tr, va = split_dataset(dataset, 0.8, seed)
    return {name: TileLoader(ds, min(dcfg.batch_size, max(len(ds), 1)),
                             shuffle=dcfg.shuffle, drop_last=dcfg.drop_last,
                             seed=seed, on_bad_tile=dcfg.bad_tile_policy)
            for name, ds in (("train", tr), ("eval", va))}


def tune_point_logger(args, tag: str) -> MetricLogger:
    """A grid point's MetricLogger: --metrics-csv with the point's tag
    before its extension, so each point has a CSV of its own (one shared
    file would mix the points' rows and repeat their epochs)."""
    if not args.metrics_csv:
        return MetricLogger(None)
    root, ext = os.path.splitext(args.metrics_csv)
    return MetricLogger(f"{root}.{tag}{ext or '.csv'}")


def sweep_grid(args, grid, run_point, *, tag_of, show_of=None,
               objective: str = "best eval", empty_hint: str = ""):
    """The `--tune` sweep of every grid CLI: each point of `grid` (a list
    of tuples) runs as `run_point(point, logger)` with its own CSV
    (`tune_point_logger`; `tag_of(point)` names every axis) and returns its
    objective; one line per point, then the best. An empty grid exits at
    once; a sweep without a finite objective says so. Returns (best,
    best point or None)."""
    if not grid:
        raise SystemExit("--tune grid is empty" +
                         (f" ({empty_hint})" if empty_hint else ""))
    show_of = show_of or tag_of
    best, best_pt = float("inf"), None
    for pt in grid:
        plog = tune_point_logger(args, tag_of(pt))
        try:
            loss = run_point(pt, plog)
        finally:
            plog.close()
        print(f"{show_of(pt)}: {objective} {loss:.4f}")
        if loss < best:
            best, best_pt = loss, pt
    if best_pt is None:
        print(f"tune: no grid point produced a finite {objective} "
              f"({len(grid)} points tried)")
    else:
        print(f"best: {show_of(best_pt)} loss={best:.4f}")
    return best, best_pt


def run_tune_grid(args, tc: TrainConfig, run_point,
                  objective: str = "best eval"):
    """The lr x weight-decay x scheduler-gamma sweep (`--tune-lrs`,
    `--tune-wds`, `--tune-gammas`): the shuffled cartesian grid
    (`product_grid`, seeded by --seed), its first --tune-max points, each
    trained by `run_point(train_config, logger)` at max(epochs // 5, 1)
    epochs. Returns (best, best point or None)."""
    grid = product_grid(
        [float(x) for x in args.tune_lrs.split(",")],
        [float(x) for x in args.tune_wds.split(",")],
        [float(x) for x in args.tune_gammas.split(",")],
        shuffle=True, seed=args.seed)[:args.tune_max]

    def point(pt, plog):
        lr, wd, gamma = pt
        print(f"tuning: lr={lr} weight_decay={wd} scheduler={gamma}")
        tci = tc.replace(lr=lr, weight_decay=wd, lr_decay=gamma,
                         epochs=max(tc.epochs // 5, 1))
        return run_point(tci, plog)

    return sweep_grid(
        args, grid, point,
        tag_of=lambda p: f"lr{p[0]}_wd{p[1]}_g{p[2]}",
        show_of=lambda p: (f"lr={p[0]} weight_decay={p[1]} "
                           f"scheduler={p[2]}"),
        objective=objective,
        empty_hint="check --tune-lrs / --tune-wds / --tune-gammas / "
                   "--tune-max")


def host_floats(xs) -> List[float]:
    """Scalars as Python floats, with one device-to-host read for the
    lot: the loops keep per-step metrics on the device and read them once
    per epoch, so no step waits on the host."""
    if not xs:
        return []
    return torch.stack([x.float().reshape(()) for x in xs]).cpu().tolist()


def device_train_batch(generator: torch.Generator, images_u8, masks_u8,
                       dcfg: DataConfig, device: torch.device):
    """Host uint8 -> augmented float batch on `device` (train chain), the
    per-sample choices drawn from `generator` (a CPU generator)."""
    return augment_batch(upload(images_u8, device), upload(masks_u8, device),
                         crop=dcfg.crop, out_h=dcfg.img_h, out_w=dcfg.img_w,
                         prob=dcfg.aug_prob, generator=generator)


_EVAL_AUG_COUNTER = [0]


def device_eval_batch(images_u8, masks_u8, dcfg: DataConfig,
                      device: torch.device):
    """Host uint8 -> float batch on `device` (eval chain). With
    `dcfg.reference_eval_aug` the random train chain runs instead (the
    reference's quirk), its choices seeded from a process-local counter,
    so eval stays deterministic per run order."""
    imgs, masks = upload(images_u8, device), upload(masks_u8, device)
    if dcfg.reference_eval_aug:
        _EVAL_AUG_COUNTER[0] += 1
        generator = torch.Generator().manual_seed(_EVAL_AUG_COUNTER[0])
        return augment_batch(imgs, masks, crop=dcfg.crop, out_h=dcfg.img_h,
                             out_w=dcfg.img_w, prob=dcfg.aug_prob,
                             generator=generator)
    return eval_batch(imgs, masks, out_h=dcfg.img_h, out_w=dcfg.img_w)

