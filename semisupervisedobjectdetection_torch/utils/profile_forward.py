"""Where a served SegFormer batch spends its time on the card.

    python -m semisupervisedobjectdetection_torch.utils.profile_forward \
        [--variant b5] [--img-size 512] [--batch 8] [--dtype bfloat16] \
        [--iters 10] [--out prof/]

Prints JSON lines with the card's name and power limit beside every number:

- `predict`: host-clock time of `SegFormerModel.predict` on a float32 NHWC
  batch (upload, forward, mask download; synchronised by the download);
- `forward`: device time of the forward alone, by CUDA events;
- `profile`: from `torch.profiler` over `--iters` predicts, the device
  busy time, the wall time of the window and the idle share, the top
  kernels by device time, and the SR-attention kernel's share.

With `--out`, the profiler's table and a Chrome trace are written there.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "?"


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> None:
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
    from semisupervisedobjectdetection_torch.models.segformer import (
        forward_masks,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", default="b5")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward runs on a CUDA card")
    card = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = MIT_VARIANTS[args.variant](dtype=args.dtype)
    model = SegFormerModel(config=cfg, seed=0)
    x = np.random.default_rng(0).uniform(
        size=(args.batch, args.img_size, args.img_size, 3)).astype(np.float32)
    for _ in range(3):
        model.predict(x)

    t0 = time.perf_counter()
    for _ in range(args.iters):
        model.predict(x)
    predict_ms = (time.perf_counter() - t0) / args.iters * 1e3
    print(json.dumps({"predict": {"ms": predict_ms, "batch": args.batch,
                                  "img_per_s": args.batch / predict_ms * 1e3,
                                  "card": card}}), flush=True)

    images = torch.from_numpy(x).cuda()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        forward_masks(model.model, images)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        for _ in range(args.iters):
            forward_masks(model.model, images)
        e1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / args.iters * 1e3
    print(json.dumps({"forward": {
        "device_ms": e0.elapsed_time(e1) / args.iters,
        "host_ms": host_ms, "batch": args.batch, "card": card}}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            model.predict(x)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    kernels.sort(key=_device_us, reverse=True)
    top = [{"name": e.key[:90], "ms_per_iter": _device_us(e) / 1e3
            / args.iters, "calls_per_iter": e.count / args.iters}
           for e in kernels[:20]]
    attn_us = sum(_device_us(e) for e in kernels
                  if "sr_attention_fwd" in e.key)
    print(json.dumps({"profile": {
        "iters": args.iters, "wall_ms_per_iter": wall_ms / args.iters,
        "device_busy_ms_per_iter": busy_us / 1e3 / args.iters,
        "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "sr_attention_ms_per_iter": attn_us / 1e3 / args.iters,
        "kernel_launches_per_iter": sum(e.count for e in kernels)
        / args.iters,
        "top": top, "card": card}}), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "table.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=60))
        prof.export_chrome_trace(os.path.join(args.out, "trace.json"))


if __name__ == "__main__":
    main()
