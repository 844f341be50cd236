"""Read the full-depth MiT-B5 quantized masks through two paths: the card's
(K1 and the library's int8 and fp8 GEMMs) and the port's plain path on the
CPU (the plain attention and the plain int8 and fp8 products), on the same
seeded weights and images.

    python3 scripts/fp8_depth_witness.py [--images 2] \\
        [--out chiprun_out/fp8_depth_witness.json]

The model and images are chip_smoke's quant_serve ones: MiT-B5 at 512x512,
bfloat16 with the tanh GELU, weights from seed 0 (made on the CPU, so both
paths hold the same bits), the first `--images` of its batch of 8 images
from seed 20. Each path predicts them with the float32 model, the bfloat16
serving copy and the int8 and fp8 snapshots of the float32 masters. The
JSON line gives each width's binarised agreement with float32 and its
largest |dp| on each path, and the agreement of the two paths with each
other per width: if fp8 agrees with float32 about as well on the CPU as on
the card, its distance from float32 comes from the e4m3 format on this
untrained model and not from the card's path. Then the card's name and
power limit. Needs a card; exits 2 without one.

    python3 scripts/fp8_depth_witness.py --weights-digest

prints, on any machine, the torch release, a SHA-256 of the seeded float32
weights (every tensor of the state dict by name, in order) and the mean
float32 logit of the first image on the CPU: whether two machines' torch
releases draw the same seeded model.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

SEED, IMG, BATCH = 0, 512, 8
WIDTHS = ("float32", "bfloat16", "int8", "fp8")


def masks_by_width(cfg, x, device):
    """{width: masks} of the seeded model on `device`, and the seconds each
    predict took."""
    import torch

    from semisupervisedobjectdetection_torch.api import SegFormerModel

    out, secs = {}, {}
    for width in WIDTHS:
        dtype = "float32" if width == "float32" else "bfloat16"
        model = SegFormerModel(config=cfg.replace(dtype=dtype), seed=SEED,
                               device=device)
        if width in ("int8", "fp8"):
            model.quantize(width)
        t0 = time.perf_counter()
        out[width] = model.predict(x)
        secs[width] = time.perf_counter() - t0
        del model
        if device == "cuda":
            torch.cuda.empty_cache()
    return out, secs


def agreement(a, b) -> float:
    return float(((a > 0.5) == (b > 0.5)).mean())


def weights_digest(cfg, x) -> dict:
    import hashlib

    import torch

    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.models.segformer import (
        forward_logits,
    )

    model = SegFormerModel(config=cfg.replace(dtype="float32"), seed=SEED,
                           device="cpu")
    h = hashlib.sha256()
    for name, t in model._net.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().contiguous().numpy().tobytes())
    with torch.no_grad():
        logits = forward_logits(model.model, torch.from_numpy(x[:1]))[0]
    return {"torch": torch.__version__, "weights_sha256": h.hexdigest(),
            "mean_logit_image_0": float(logits.float().mean())}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--images", type=int, default=2)
    p.add_argument("--out")
    p.add_argument("--weights-digest", action="store_true",
                   help="print the seeded weights' digest and exit")
    args = p.parse_args()

    import torch

    if args.weights_digest:
        from semisupervisedobjectdetection_torch.core.config import mit_b5

        torch.set_num_threads(os.cpu_count() or 1)
        x = np.random.default_rng(SEED + 20).uniform(
            size=(1, IMG, IMG, 3)).astype(np.float32)
        print(json.dumps(weights_digest(
            mit_b5(dtype="bfloat16", gelu_approx=True), x)), flush=True)
        return

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        sys.exit(2)
    from semisupervisedobjectdetection_torch.core.config import mit_b5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = mit_b5(dtype="bfloat16", gelu_approx=True)
    rng = np.random.default_rng(SEED + 20)
    x = rng.uniform(size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    x = x[:args.images]
    paths, secs = {}, {}
    for device in ("cuda", "cpu"):
        paths[device], secs[device] = masks_by_width(cfg, x, device)
    row = {"variant": "b5", "img": IMG, "images": args.images,
           "predict_s": secs}
    for device, m in paths.items():
        row[device] = {w: {"agree_vs_float32": agreement(m[w], m["float32"]),
                           "max_abs_dp_vs_float32": float(
                               np.abs(m[w] - m["float32"]).max()),
                           "finite": bool(np.isfinite(m[w]).all())}
                       for w in WIDTHS[1:]}
    row["cuda_vs_cpu"] = {w: {"agree": agreement(paths["cuda"][w],
                                                 paths["cpu"][w]),
                              "max_abs_dp": float(np.abs(
                                  paths["cuda"][w] - paths["cpu"][w]).max())}
                          for w in WIDTHS}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    row["card"] = smi
    line = json.dumps(row)
    print(line, flush=True)
    print(smi, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
