"""Export a serving artifact from a trained checkpoint, the JAX package's
`cli/export.py` on PyTorch.

    python -m semisupervisedobjectdetection_torch.cli.export \\
        --pretrain-weight CKPT --out model.ssod [--int8 | --fp8] \\
        [--platforms cuda,cpu] [--device cpu]

It builds the model (seeded weights, then `--hf-weights` and
`--pretrain-weight`, local files only), optionally quantizes it, exports
the eval-mode predict at one pinned batch shape with `torch.export` for
each platform, and writes one file (`checkpoint/serving_export.py`). Serve
it with `cli.serve --artifact model.ssod` or load it with `load_serving`:
no checkpoint or model build is needed at serving time, only the port's
operator library. The model is built on `--device` (the CUDA card unless
`--device cpu`); a "cuda" platform needs the card.
"""

from __future__ import annotations


def main(argv=None):
    import argparse
    import os

    p = argparse.ArgumentParser(
        description="Export a serving artifact (torch.export of predict).")
    p.add_argument("--variant", default="b5")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--pretrain-weight",
                   help="checkpoint (.pt) written by one of this package's "
                        "training CLIs")
    p.add_argument("--hf-weights",
                   help="local torch .pth/.safetensors SegFormer weights")
    p.add_argument("--int8", action="store_true",
                   help="quantize to the int8 serving snapshot first")
    p.add_argument("--fp8", action="store_true",
                   help="quantize to the fp8 (e4m3) serving snapshot first")
    p.add_argument("--batch", type=int, default=8,
                   help="exported batch size (smaller requests are padded "
                        "at serving time; larger ones rejected)")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated platforms to export for (cuda, "
                        "cpu)")
    p.add_argument("--perf", action="store_true",
                   help="tanh-approx GELU preset (the benched config)")
    p.add_argument("--device", default="cuda",
                   help="device to build the model on (default cuda; 'cpu' "
                        "to run without a card)")
    p.add_argument("--out", required=True, help="artifact path to write")
    args = p.parse_args(argv)
    if args.int8 and args.fp8:
        raise SystemExit("--int8 and --fp8 are mutually exclusive")

    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS

    cfg = MIT_VARIANTS[args.variant](dtype=args.dtype,
                                     gelu_approx=args.perf)
    model = SegFormerModel(pretrain_weight=args.pretrain_weight,
                           config=cfg, hf_weights=args.hf_weights,
                           device=args.device)
    if not (args.pretrain_weight or args.hf_weights):
        print("WARNING: exporting randomly initialized weights "
              "(no --pretrain-weight / --hf-weights)")
    if args.int8 or args.fp8:
        model.quantize("fp8" if args.fp8 else "int8")
    header = model.export_serving(
        args.out, batch_size=args.batch, img_size=args.img_size,
        platforms=tuple(s for s in args.platforms.split(",") if s))
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB): "
          f"{header}", flush=True)
    return header


if __name__ == "__main__":
    main()
