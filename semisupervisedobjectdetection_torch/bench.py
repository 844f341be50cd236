"""Benchmark of the EMA mean-teacher semi-supervised step of the port.

    python -m semisupervisedobjectdetection_torch.bench [--quick] \
        [--device cpu] [--batch N] [--grad-accum A] [--size S] [--iters N] \
        [--int8-teacher | --serving]

Times `train/ema.py::ema_semi_step` at the flagship point of the JAX
package's bench.py (`--mode ema`): MiT-B5 at 512x512 in bfloat16 with the
tanh GELU, microbatch 16 x `--grad-accum` 2, so 32 labeled and 32 unlabeled
images per step, `train_mode=False`, denoising on, default thresholds,
supervise weight 0.8, EMA decay 0.999. Inputs and weights come from seed 0
(numpy for the images and masks, a `torch.Generator` for the weights). Two
warm-up steps, then `max(2, iters // 2)` windows of 8 steps, each ended by
one device-to-host read of the loss; the median window gives the step time.

Prints exactly one JSON line, in bench.py's shape:
  {"metric": ..., "value": N, "unit": "images/sec/chip", "vs_baseline": N}
(2 * batch images per step; vs_baseline against the same 17.2 img/s), and
one line on stderr with the device, the step times and the peak memory.
`--quick` runs a tiny config (CPU-safe, with `--device cpu`). Without
`--device` it runs on the CUDA card and raises when there is none.

`--int8-teacher` times `ema_semi_step_int8` instead: the teacher's forwards
on an int8 snapshot of the teacher, taken once before the timed steps (a
training run takes one an epoch). `--serving` times the int8 predict
instead of a train step, as the JAX package's `bench.py --serving`: the
forward of the int8 snapshot of the seeded model and the mask sigmoid on a
batch already on the device (`--batch`, default 16), in windows of 8
forwards each ended by a host read; it prints the same JSON line with
images per second.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
    mit_b0,
    mit_b5,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    cast_to_compute_dtype,
    forward_masks,
    init_weights,
)
from semisupervisedobjectdetection_torch.ops.quant import (
    quantize_dense_params,
)
from semisupervisedobjectdetection_torch.train.ema import (
    EmaStepOut,
    ema_semi_step,
    ema_semi_step_int8,
    make_teacher_int8_snapshot,
)
from semisupervisedobjectdetection_torch.train.state import TrainState
from semisupervisedobjectdetection_torch.utils.device import (
    device_name,
    resolve_device,
)

REFERENCE_IMAGES_PER_SEC = 17.2
SUPERVISE_WEIGHT = 0.8
EMA_DECAY = 0.999
TEACHER_LR = 5e-7
STUDENT_LR = 3e-5


def flagship_config() -> MiTConfig:
    return mit_b5(dtype="bfloat16", gelu_approx=True)


def quick_config() -> MiTConfig:
    return mit_b0(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
                  num_heads=(1, 2, 4, 8), decoder_hidden=32)


@dataclasses.dataclass
class Workload:
    """A teacher/student pair and one step's inputs, on one device."""

    teacher: TrainState
    student: TrainState
    unlabeled: torch.Tensor
    images: torch.Tensor
    masks: torch.Tensor
    accum: int
    # the teacher's int8 snapshot: `step` runs `ema_semi_step_int8` on it
    teacher_int8: Optional[torch.nn.Module] = None

    @property
    def images_per_step(self) -> int:
        return self.unlabeled.shape[0] + self.images.shape[0]

    def step(self) -> EmaStepOut:
        if self.teacher_int8 is not None:
            return ema_semi_step_int8(
                self.teacher_int8, self.teacher, self.student,
                self.unlabeled, self.images, self.masks, SUPERVISE_WEIGHT,
                EMA_DECAY, accum=self.accum)
        return ema_semi_step(self.teacher, self.student, self.unlabeled,
                             self.images, self.masks, SUPERVISE_WEIGHT,
                             EMA_DECAY, accum=self.accum)


def make_workload(cfg: MiTConfig, batch: int, size: int, accum: int,
                  device: torch.device, seed: int = 0) -> Workload:
    """bench.py's seeded synthetic inputs (labeled images, masks with ~30%
    foreground, unlabeled images, in that order from one numpy generator)
    and a teacher and student that start from the same seeded weights."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    masks = (rng.uniform(0, 1, (batch, size, size)) > 0.7).astype(np.float32)
    unlabeled = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    model = init_weights(SegFormer(cfg), torch.Generator().manual_seed(seed))
    tc = TrainConfig()
    teacher = TrainState.create(copy.deepcopy(model).to(device), tc,
                                lr=TEACHER_LR)
    student = TrainState.create(model.to(device), tc, lr=STUDENT_LR)
    return Workload(teacher, student,
                    torch.from_numpy(unlabeled).to(device),
                    torch.from_numpy(images).to(device),
                    torch.from_numpy(masks).to(device), accum)


def time_serving(cfg: MiTConfig, batch: int, size: int,
                 device: torch.device, windows: int, inner: int = 8,
                 seed: int = 0) -> dict:
    """The int8 predict of the seeded model (`quantize_dense_params` of its
    float32 weights, the rest cast once) on `batch` seeded images on the
    device: one warm-up forward, then `windows` windows of `inner`
    forwards, each ended by reading one mask value on the host. Returns the
    median seconds per forward, every window's, and the warm-up's."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (batch, size, size, 3))
                              .astype(np.float32)).to(device)
    model = init_weights(SegFormer(cfg), torch.Generator().manual_seed(seed))
    qmodel = cast_to_compute_dtype(
        quantize_dense_params(model.to(device), "int8"))
    del model
    with torch.inference_mode():
        t0 = time.perf_counter()
        float(forward_masks(qmodel, images)[0][0, 0, 0])
        warmup_s = time.perf_counter() - t0
        times: List[float] = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(inner):
                pred = forward_masks(qmodel, images)[0]
            float(pred[0, 0, 0])
            times.append((time.perf_counter() - t0) / inner)
    return {"step_s": float(np.median(times)), "times": times,
            "warmup_s": warmup_s}


def time_steps(w: Workload, warmup: int = 2, windows: int = 4,
               inner: int = 8) -> dict:
    """Run `warmup` steps, then `windows` windows of `inner` steps, each
    window ended by reading the last loss on the host. Returns the median
    seconds per step, every window's, the warm-up seconds and the last
    step's output."""
    t0 = time.perf_counter()
    for _ in range(warmup):
        out = w.step()
        float(out.student_loss_total)
    warmup_s = time.perf_counter() - t0
    times: List[float] = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = w.step()
        float(out.student_loss_total)
        times.append((time.perf_counter() - t0) / inner)
    return {"step_s": float(np.median(times)), "times": times,
            "warmup_s": warmup_s, "out": out}


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--quick", action="store_true",
                   help="tiny config smoke run (CPU-safe with --device cpu)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--batch", type=int, default=0,
                   help="images per phase and step (0 = 16 * grad-accum; "
                   "2 with --quick)")
    p.add_argument("--grad-accum", type=int, default=0,
                   help="microbatches per step (0 = 2; 1 with --quick)")
    p.add_argument("--size", type=int, default=0)
    p.add_argument("--iters", type=int, default=8)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--int8-teacher", action="store_true",
                      help="time ema_semi_step_int8: the teacher's forwards "
                           "on its int8 snapshot")
    mode.add_argument("--serving", action="store_true",
                      help="time the int8 predict instead of a train step")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.serving:
        return _serving(args, device)
    if args.quick:
        cfg, accum = quick_config(), args.grad_accum or 1
        size, batch = args.size or 64, args.batch or 2
        windows, inner = 2, 2
    else:
        cfg, accum = flagship_config(), args.grad_accum or 2
        size, batch = args.size or 512, args.batch or 16 * accum
        windows, inner = max(2, args.iters // 2), 8
    if batch % accum:
        sys.exit(f"--batch {batch} not divisible by --grad-accum {accum}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    w = make_workload(cfg, batch, size, accum, device)
    if args.int8_teacher:
        w.teacher_int8 = make_teacher_int8_snapshot(w.teacher)
    r = time_steps(w, warmup=2, windows=windows, inner=inner)
    ips = w.images_per_step / r["step_s"]
    name = "EMA teacher-student semi-supervised step" + (
        " (int8 teacher)" if args.int8_teacher else "")
    print(json.dumps({
        "metric": f"{name}, MiT-B5 {size}x{size} bf16"
                  if device.type == "cuda" and not args.quick else
                  f"{name} (quick/cpu config)",
        "value": round(ips, 3),
        "unit": "images/sec/chip",
        "vs_baseline": round(ips / REFERENCE_IMAGES_PER_SEC, 3),
    }), flush=True)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    print(f"# device={device_name(device)} batch={batch} size={size} "
          f"grad_accum={accum} step_s={r['step_s']:.4f} "
          f"warmup_s={r['warmup_s']:.1f} "
          f"times={['%.4f' % t for t in r['times']]} "
          f"max_memory_allocated={peak}", file=sys.stderr)


def _serving(args, device: torch.device) -> None:
    """--serving: the int8 predict's images per second, one JSON line."""
    if args.quick:
        cfg, size, batch, windows = quick_config(), args.size or 64, \
            args.batch or 2, 2
    else:
        cfg, size, batch = flagship_config(), args.size or 512, \
            args.batch or 16
        windows = max(2, args.iters // 2)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    r = time_serving(cfg, batch, size, device, windows)
    ips = batch / r["step_s"]
    print(json.dumps({
        "metric": f"int8 predict, MiT-B5 {size}x{size}"
                  if device.type == "cuda" and not args.quick else
                  "int8 predict (quick/cpu config)",
        "value": round(ips, 3),
        "unit": "images/sec/chip",
        "vs_baseline": round(ips / REFERENCE_IMAGES_PER_SEC, 3),
    }), flush=True)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    print(f"# serving device={device_name(device)} batch={batch} "
          f"size={size} step_s={r['step_s']:.4f} "
          f"warmup_s={r['warmup_s']:.1f} "
          f"times={['%.4f' % t for t in r['times']]} "
          f"max_memory_allocated={peak}", file=sys.stderr)


if __name__ == "__main__":
    main()
