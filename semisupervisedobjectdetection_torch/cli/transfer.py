"""Prompt-tuning transfer CLI of the PyTorch port, the JAX package's
`cli/transfer.py` (the reference's
`main_segformer/segFormer_transfer_learning_main.py`).

    python -m semisupervisedobjectdetection_torch.cli.transfer \\
        --synthetic --variant b0 --img-size 64 --epochs 2 --device cpu \\
        --frozen 0,1 --prompt-tokens 10,10,10,10

Warm-starts from a checkpoint (--pretrain-weight, a port checkpoint such as
the supervised CLI's best) or HF-layout weights (--hf-weights), freezes the
layers of the --frozen encoder stages, adds --prompt-tokens prompt tokens
per stage (one set per stage, or per layer with --per-layer-prompts) and
fine-tunes with the supervised loop (`cli/supervised.py::train_loop`, ref
`:199-206`). By default (the reference's quirk) the prompt tokens stay
frozen and the forward runs in eval mode; --no-quirks trains them, in train
mode.

`--tune` sweeps lr (--tune-lrs) x frozen set ({--frozen, (0, 1, 2)}) x
prompt tokens per stage (--tune-tokens, the reference's {1, 10, 100}) as
the reference's `Hyperparameter_Tuning` (`:107-160`), in the JAX CLI's
shuffled order: each point trains a fresh warm-started model for
max(epochs // 5, 1) epochs and writes no checkpoint; --resume is ignored.
The SR-attention kernels take any prefix (100 tokens per stage at 512x512:
Nk 356). It runs on the CUDA card unless `--device cpu` is given.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.cli import common
from semisupervisedobjectdetection_torch.cli.supervised import (
    best_eval,
    train_loop,
)
from semisupervisedobjectdetection_torch.core.config import (
    MIT_VARIANTS,
    product_grid,
)
from semisupervisedobjectdetection_torch.utils import preemption
from semisupervisedobjectdetection_torch.utils.device import resolve_device
from semisupervisedobjectdetection_torch.utils.logging import MetricLogger


def build_model(args, tc, cfg, frozen: Sequence[int],
                tokens: Sequence[int], same_per_layer: bool = True,
                lr: Optional[float] = None, device=None) -> SegFormerModel:
    """The warm-started model with its frozen stages and prompt tokens."""
    model = SegFormerModel(pretrain_weight=args.pretrain_weight,
                           train_config=tc, config=cfg, lr=lr,
                           hf_weights=args.hf_weights, seed=args.seed,
                           grad_accum=args.grad_accum, device=device)
    if frozen:
        model.frozen_encoder(layers=frozen)
    if any(tokens):
        model.add_prompt_token(tokens, isSamePerLayer=same_per_layer)
    return model


def tune(args, cfg, dcfg, tc, loaders, frozen: Sequence[int], device):
    """--tune: the shuffled lr x {--frozen, (0, 1, 2)} x tokens grid, each
    point a model warm-started as `build_model` makes it, with (tok,) * 4
    prompt tokens, trained for max(epochs // 5, 1) epochs without
    checkpoints (`common.sweep_grid`). Returns (best, best point)."""
    lrs = [float(x) for x in args.tune_lrs.split(",") if x]
    toks = [int(x) for x in args.tune_tokens.split(",") if x != ""]
    grid = product_grid(lrs, [tuple(frozen), (0, 1, 2)], toks,
                        shuffle=True, seed=args.seed)

    def point(pt, plog):
        lr, fz, tok = pt
        model = build_model(args, tc, cfg, list(fz), (tok,) * 4, lr=lr,
                            device=device)
        return best_eval(train_loop(
            model, loaders, dcfg, tc.replace(epochs=max(tc.epochs // 5, 1)),
            args, plog, save_model=False))

    return common.sweep_grid(
        args, grid, point,
        tag_of=lambda p: (f"lr{p[0]}_fz{'-'.join(map(str, p[1]))}"
                          f"_tok{p[2]}"),
        show_of=lambda p: f"lr={p[0]} frozen={p[1]} tokens={p[2]}",
        empty_hint="check --tune-lrs / --tune-tokens")


def main(argv: Optional[List[str]] = None):
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--frozen", default="0,1",
                   help="comma-separated encoder stages to freeze")
    p.add_argument("--prompt-tokens", default="10,10,10,10")
    p.add_argument("--per-layer-prompts", action="store_true")
    p.add_argument("--tune", action="store_true",
                   help="grid search lr x frozen x token count")
    p.add_argument("--tune-lrs", default="1e-4,5e-5,1e-5")
    p.add_argument("--tune-tokens", default="1,10,100",
                   help="token counts for --tune (reference grid "
                        "{1,10,100}, `:181-184`)")
    p.add_argument("--resume", action="store_true",
                   help="write a <checkpoint-dir>/segformer_last "
                        "checkpoint every epoch and continue from it when "
                        "present (ignored under --tune: grid points must "
                        "not share one _last)")
    args = p.parse_args(argv)
    common.refuse_unported(args)
    if args.tune and args.resume:
        print("--resume is ignored under --tune (each grid point would "
              "otherwise restore the previous point's _last checkpoint)")
        args.resume = False
    device = resolve_device(args.device)
    frozen = [int(x) for x in args.frozen.split(",") if x != ""]
    tokens = tuple(int(x) for x in args.prompt_tokens.split(","))
    cfg = common.apply_perf_preset(
        MIT_VARIANTS[args.variant](dtype=args.dtype), args)
    common.check_kernel_shapes(
        cfg.replace(prompt_tokens=tokens,
                    prompt_per_layer=args.per_layer_prompts),
        args, device)
    dcfg, tc = common.configs_from_args(args)
    dcfg = common.ensure_data(args, dcfg)
    loaders = common.make_loaders(dcfg, args.seed)
    common.check_grad_accum(args, loaders["train"])
    if args.tune:
        return tune(args, cfg, dcfg, tc, loaders, frozen, device)
    model = build_model(args, tc, cfg, frozen, tokens,
                        not args.per_layer_prompts, device=device)
    logger = MetricLogger(args.metrics_csv)
    try:
        reports = train_loop(model, loaders, dcfg, tc, args, logger)
    finally:
        logger.close()
    common.maybe_plot_curves(args)
    return reports


if __name__ == "__main__":
    preemption.install()
    main()
