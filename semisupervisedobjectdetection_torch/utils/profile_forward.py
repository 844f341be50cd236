"""Where a served SegFormer batch, or an EMA or supervised training step,
spends its time on the card.

    python -m semisupervisedobjectdetection_torch.utils.profile_forward \
        [--step predict|ema|supervised] [--variant b5] [--img-size 512] \
        [--batch 8] [--dtype bfloat16] [--grad-accum 2] [--iters 10] \
        [--out prof/]

Prints JSON lines with the card's name and power limit beside every number.
`--step predict` (the default):

- `predict`: host-clock time of `SegFormerModel.predict` on a float32 NHWC
  batch (upload, forward, mask download; synchronised by the download);
- `forward`: device time of the forward alone, by CUDA events;
- `profile`: from `torch.profiler` over `--iters` predicts, the device
  busy time, the wall time of the window and the idle share, the top
  kernels by device time, and the SR-attention kernel's share.

`--step ema`: the EMA step of the port's bench at its flagship point
(MiT-B5 512x512 bf16, `--batch` images per phase, default 32, in
`--grad-accum` microbatches, default 2), two warm-up steps, then:

- `ema_step`: host-clock ms per step over `--iters` steps (default 3), each
  ended by reading the loss, and the peak memory;
- `ema_profile`: from `torch.profiler` over one more step, the device busy
  time, the idle share, the kernel launches, the SR-attention kernels' time
  and launches, the top kernels by device time and the top host operators
  by their own CPU time.

`--step supervised`: `SegFormerModel.train_one_epoch` at the same point
(`--batch` images per step, default 32, in `--grad-accum` microbatches, the
reference-quirks eval-mode forward), printed as `supervised_step` and
`supervised_profile` lines of the same fields.

With `--out`, the profiler's table and a Chrome trace are written there.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


def _kernel_summary(prof, iters: int) -> dict:
    """Device time, idle share inputs and the top kernels of a profile,
    per iteration."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(_device_us(e) for e in kernels)
    kernels.sort(key=_device_us, reverse=True)

    def named(part):
        hit = [e for e in kernels if part in e.key]
        return {"ms_per_iter": sum(_device_us(e) for e in hit) / 1e3 / iters,
                "launches_per_iter": sum(e.count for e in hit) / iters}

    return {
        "device_busy_ms_per_iter": busy_us / 1e3 / iters,
        "kernel_launches_per_iter": sum(e.count for e in kernels) / iters,
        "sr_attention_fwd": named("sr_attention_fwd"),
        "sr_attention_bwd": named("sr_attention_bwd"),
        "top": [{"name": e.key[:90],
                 "ms_per_iter": _device_us(e) / 1e3 / iters,
                 "calls_per_iter": e.count / iters} for e in kernels[:25]]}


def kernels_launched(fn, match: str):
    """(`fn()`'s result, the device kernels whose names hold `match` that
    the call ran, in start order), as `torch.profiler` saw them on the
    card: each name is the kernel's own (`match` through `_kernel`), its
    namespace, template arguments and parameters dropped.

    The call runs 20 ms after the profiler starts and the profiler stops
    20 ms after the call's kernels end: on an H100 without that margin
    some profiles lacked the first kernels of the call."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.02)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    found = sorted((e.time_range.start, m.group(0)) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and (m := re.search(match + r"[a-z0-9_]*?_kernel",
                                       e.name)))
    return out, [name for _, name in found]


def kernel_times_us(fn, match: str, iters: int = 5) -> dict:
    """{kernel name: mean device microseconds per call} of the kernels whose
    names hold `match` over `iters` calls of `fn()`, as `torch.profiler`
    saw them on the card (names as `kernels_launched` gives them)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total: dict = {}
    for e in prof.events():
        m = re.search(match + r"[a-z0-9_]*?_kernel", e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            total[m.group(0)] = total.get(m.group(0), 0.0) + (
                e.time_range.end - e.time_range.start)
    return {name: us / iters for name, us in total.items()}


def _write(prof, out: str) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "table.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


def _profile_step(name: str, step, images_per_step: int, args, card: str,
                  **fields) -> None:
    """Time `step()` (which ends by reading its loss on the host): two
    warm-up calls, `--iters` timed ones and one under `torch.profiler`;
    prints the `{name}_step` and `{name}_profile` lines."""
    dev = torch.device("cuda")
    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats(dev)
    iters = args.iters or 3
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    print(json.dumps({f"{name}_step": {
        "ms": step_ms, "images_per_step": images_per_step,
        "img_per_s": images_per_step / step_ms * 1e3, **fields,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
        "card": card}}), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    summary = _kernel_summary(prof, 1)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(json.dumps({f"{name}_profile": {
        "wall_ms_per_step": wall_ms,
        "idle_share": 1.0 - summary["device_busy_ms_per_iter"] / wall_ms,
        **summary,
        "host_top": [{"name": e.key[:90],
                      "self_cpu_ms": e.self_cpu_time_total / 1e3,
                      "calls": e.count} for e in host[:25]],
        "card": card}}), flush=True)
    if args.out:
        _write(prof, args.out)


def profile_ema(args, card: str) -> None:
    from semisupervisedobjectdetection_torch.bench import (
        flagship_config,
        make_workload,
    )

    accum = args.grad_accum
    batch = args.batch or 16 * accum
    w = make_workload(flagship_config(), batch, args.img_size, accum,
                      torch.device("cuda"))
    _profile_step("ema", lambda: float(w.step().student_loss_total),
                  w.images_per_step, args, card, batch=batch,
                  grad_accum=accum)


def profile_supervised(args, card: str) -> None:
    """`SegFormerModel.train_one_epoch` at the flagship point: `--batch`
    images per step (default 32) in `--grad-accum` microbatches, the
    reference-quirks forward (eval mode), seeded random weights and
    images."""
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.bench import flagship_config

    accum = args.grad_accum
    batch = args.batch or 16 * accum
    model = SegFormerModel(config=flagship_config(), seed=0,
                           grad_accum=accum)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(
        batch, args.img_size, args.img_size, 3)).astype(np.float32)).cuda()
    y = torch.from_numpy((rng.uniform(size=(
        batch, args.img_size, args.img_size)) > 0.7).astype(
            np.float32)).cuda()
    _profile_step("supervised",
                  lambda: float(model.train_one_epoch(x, y, lazy=True)[0]),
                  batch, args, card, batch=batch, grad_accum=accum)


def main(argv=None) -> None:
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS
    from semisupervisedobjectdetection_torch.models.segformer import (
        forward_masks,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--step", default="predict",
                   choices=["predict", "ema", "supervised"])
    p.add_argument("--variant", default="b5")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--batch", type=int, default=0,
                   help="predict: 8; ema: 16 * grad-accum per phase; "
                        "supervised: 16 * grad-accum")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--grad-accum", type=int, default=2)
    p.add_argument("--iters", type=int, default=0,
                   help="predict: 10; ema and supervised: 3")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward runs on a CUDA card")
    card = _smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.step in ("ema", "supervised"):
        (profile_ema if args.step == "ema" else profile_supervised)(args,
                                                                    card)
        return
    args.batch = args.batch or 8
    args.iters = args.iters or 10

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
    summary = _kernel_summary(prof, args.iters)
    print(json.dumps({"profile": {
        "iters": args.iters, "wall_ms_per_iter": wall_ms / args.iters,
        "idle_share": 1.0 - summary["device_busy_ms_per_iter"]
        * args.iters / wall_ms,
        **summary, "card": card}}), flush=True)
    if args.out:
        _write(prof, args.out)


if __name__ == "__main__":
    main()
