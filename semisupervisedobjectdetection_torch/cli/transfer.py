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

On the card the SR-attention kernels take at most 288 keys, so at 512x512 a
stage takes at most 32 prompt tokens; a larger prefix is refused before any
model is built. It runs on the CUDA card unless `--device cpu` is given.
`--tune` (the lr x frozen x tokens grid) is not ported yet and is refused
with a message naming ROADMAP.md.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.cli import common
from semisupervisedobjectdetection_torch.cli.supervised import train_loop
from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
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


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = common.base_parser(__doc__.split("\n\n")[0])
    p.add_argument("--frozen", default="0,1",
                   help="comma-separated encoder stages to freeze")
    p.add_argument("--prompt-tokens", default="10,10,10,10")
    p.add_argument("--per-layer-prompts", action="store_true")
    p.add_argument("--tune", action="store_true",
                   help="grid search lr x frozen x token count (not "
                        "ported)")
    p.add_argument("--resume", action="store_true",
                   help="write a <checkpoint-dir>/segformer_last "
                        "checkpoint every epoch and continue from it when "
                        "present")
    args = p.parse_args(argv)
    common.refuse_unported(args, (("--tune", args.tune),))
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
    model = build_model(args, tc, cfg, frozen, tokens,
                        not args.per_layer_prompts, device=device)
    logger = MetricLogger(args.metrics_csv)
    try:
        return train_loop(model, loaders, dcfg, tc, args, logger)
    finally:
        logger.close()


if __name__ == "__main__":
    preemption.install()
    main()
