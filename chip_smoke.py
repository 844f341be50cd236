#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as JSON lines with its seconds; any failure exits
non-zero before the final line:

1. device     - the card's name, count and power limit (no CUDA: exit 2).
2. build      - compile both kernels from `csrc/` at once, one nvcc each;
                for every kernel instantiation its registers, stack and
                spills (from `-Xptxas -v`) and its count of tensor-core
                instructions (HMMA, HGMMA) in the SASS of the built library
                (`cuobjdump --dump-sass`), ptxas's warnings, each design's
                shared memory, K1's bf16 CTAs per SM and each dtype's Nk
                limit (bf16 288, float32 none). Every tensor-core kernel
                must show HGMMA and no HMMA, and neither a stack frame nor
                spills: K1's and K2's bf16 wgmma kernels (four
                instantiations each), K1's float32 3xTF32 kernel and K2's
                float32 row and key passes (two each, d 32/64).
3. kernel     - `sr_attention_fwd` (K1) against its plain PyTorch version:
                the bf16 kernel at the four MiT-B5 512x512 stage shapes at
                batch 8 (serving), 16 (student) and 32 (teacher), at two
                shapes with a prompt/CLS prefix at batch 8, at the transfer
                step's four shapes (10 prompt tokens per stage, Nk 266) at
                batch 16 and at the few-shot step's four shapes (Nq = H*W +
                1, Nk 257) at batch 2; the float32 kernel at the stage and
                prefix shapes at batch 8, at the few-shot and transfer
                shapes at batch 2, and past the bf16 limit at batch 2 at the
                four Nk-356 shapes (100 prompt tokens per stage) and at Nk
                300, and at Nk 1024 (stage 1 at 1024x1024) at batch 1: max
                abs error against a stated tolerance, bit-equal reruns, the
                error against float64, and CUDA-event device times (queued
                behind a sleep kernel, so not paced by the host) of the
                kernel, the plain version and
                `F.scaled_dot_product_attention` (a yardstick only; the port
                never calls it), the host microseconds of a call, beside the
                bound from shapes (each byte in and out once at 3.35 TB/s;
                flops at 989 TFLOP/s bf16 and at 495 / 3 = 165 TFLOP/s
                float32, the 3xTF32 rate; each row names its rate).
4. kernel_bwd - `sr_attention_bwd` (K2) against its plain version at the
                four stage shapes and the two prefix shapes at batch 16, in
                bfloat16 and float32, at the rest of the transfer step's
                shapes (Nk 266) in bfloat16, at the four few-shot shapes (a
                CLS query row and key per stage) at batch 2 in both types,
                and in float32 at batch 2 at the transfer shapes, the Nk-356
                shapes and Nk 300, and at Nk 1024 at batch 1: max error
                against a stated tolerance (float32 also against float64),
                bit-equality of two launches, the kernels one call launched
                as the profiler saw them against its launch plan's (bf16:
                the wgmma kernel, and the split sum where its grid splits a
                (batch, head); float32: the row pass, the key pass and the
                split sum where the key pass splits) and against the count
                its C launcher reported, the plan's grid or splits, the
                host microseconds of a call, and the times of the kernels,
                the plain version and the autograd backward of
                `F.scaled_dot_product_attention`, beside the bound.
5. model      - MiT-B5 at 512x512 in float32, TF32 off: the kernel path and
                the plain path agree on a batch of two images.
6. serve      - the port's InferenceServer (MiT-B5, 512x512, bfloat16,
                max_batch 8, seeded random weights) answers 16 concurrent raw
                requests and 2 PNG requests over HTTP; every request succeeds
                with a finite mask of the right shape, K1 ran exactly 52
                times per batch served (3+6+40+3 layers), all on its bf16
                kernel; and the serve gate: the same 16 raw images through
                the plain bf16 path and the float32 model (plain attention,
                TF32 off) in batches of 8 (`utils/serve_gate.py`), the
                served masks no further from float32 than the plain bf16
                path's (pixel flips, mean error) and within a bound of the
                plain path.
7. grad       - MiT-B5 512x512 float32, TF32 off, batch 2: the EMA step's
                student loss backward through the kernels and through the
                plain path give the same gradient for every parameter
                tensor, with K2 launched exactly 52 times.
8. train      - the EMA mean-teacher step at the flagship point (MiT-B5
                512x512 bf16, 32 labeled + 32 unlabeled images per step in
                2 microbatches) through the port bench's functions: 2
                warm-up and 4 timed steps with finite losses, K1 (its
                tensor-core kernel) launched 312 and K2 104 times per step,
                the teacher moved by exactly
                the EMA of the student, and two steps from one state through
                the kernels and through the plain path agreeing on the
                losses and kept counts.
9. train_mode - the student's train-mode forward (drop-path 0.1,
                classifier dropout 0.1, BatchNorm on batch statistics) at
                MiT-B5 512x512: in float32 (TF32 off) at batch 2, one
                backward through the kernels and through the plain path
                with the same masks gives the same gradient for every
                parameter tensor and the same new BatchNorm statistics;
                at the flagship point (bf16, 2 x (16 + 16)), two train-mode
                EMA steps from one state and one generator seed through the
                kernels and the plain path agree on the losses and kept
                counts, with K1 launched 312 and K2 104 times per step.
10. augment   - `augment_batch` (batch 32, canvas 512, crop 500, out 512)
                and `eval_batch` on the card against the same functions on
                the CPU with the same choices, and their times on the card.
11. cli       - the `--ema-mode` teacher-student CLI
                (`cli/teacher_student.py::main`, in this process) at the
                flagship point: MiT-B5 512x512 bf16, 32 synthetic tiles
                (CLI_TILES; one step an epoch, as in every CLI phase),
                batch 32 in 2 microbatches, train mode (the default), 2
                epochs with --resume: 2 finite CSV rows, K1 312 and K2 104
                launches per train step and 52 K1 launches per model per
                eval batch, the student's BatchNorm statistics moved, best
                and `_last` checkpoints of both models, `load_last` giving
                back what was saved, and a second run with --epochs 3
                --resume starting at epoch 2 (its batches staged inline,
                --prefetch 0, beside the first run's prefetch thread). Per
                epoch: seconds, train images per second, eval and
                checkpoint seconds, the wait on the prefetcher and the peak
                device memory.

12. supervised - the supervised `train_step` (`train/supervised.py`) at the
                flagship point (MiT-B5 512x512 bf16, tanh GELU, 32 images per
                step in 2 microbatches of 16, seeded random weights), in eval
                mode (the reference-quirks default) and in train mode: two
                steps from one state through the kernels and through the
                plain path agree on the losses, with K1 (tensor-core)
                launched 208 and K2 104 times per step (forward and
                recompute, and backward, of 52 layers in 2 microbatches), the
                plain path none; ms per step and peak memory.
13. transfer_grad - the float32 B5 transfer configuration through
                `SegFormerModel`: stages 0 and 1 frozen, 10 shared prompt
                tokens per stage, quirks off (the prompts train, train-mode
                forward), batch 2, TF32 off. Gradients through the kernels
                agree with the plain path per tensor; the frozen layers have
                no gradient and no moments; the prompt tokens and the stage-0
                and stage-1 patch embeddings get non-zero gradients (through
                the frozen layers above them, so K2 runs in all 52 layers);
                every K1 and K2 launch has Nk = 266.
13b. transfer_grad_nk356 - transfer_grad's configuration with 100 prompt
                tokens per stage (the transfer grid's largest), so every K1
                and K2 launch has Nk = 356, which the float32 kernels take
                and bf16 refuses: the same checks at GRAD_F32_TOL.
14. transfer_step - the transfer CLI's step in bfloat16 through
                `SegFormerModel.train_one_epoch` at the flagship point (the
                configuration of transfer_grad, 32 images per step in 2
                microbatches of 16): two steps through the kernels and
                through the plain path agree on the losses, with K1
                (tensor-core) launched 208 and K2 104 times per step, every
                launch at Nk = 266, the plain path none.
15. sup_cli     - `cli/supervised.py::main` at the flagship point: 32
                synthetic tiles, batch 32 in 2 microbatches, 2 epochs with
                --resume, then a resumed third epoch, then `--predict
                --dump-masks` from the best checkpoint: finite CSV rows, best
                and `_last` checkpoints, the resume at epoch 2, 10 pairs of
                mask PNGs, 208 K1 and 104 K2 launches per train step and 52
                K1 per eval batch; per epoch its seconds, step time, eval and
                checkpoint seconds and peak memory.
16. transfer_cli - `cli/transfer.py::main` at the same point with --frozen
                0,1 --prompt-tokens 10,10,10,10 --no-quirks, warm-started
                from sup_cli's best checkpoint, 2 epochs: the frozen layers'
                weights equal the warm start bit for bit after training, the
                prompt tokens moved from their seeded init, the same launch
                counts per step; and --prompt-tokens 40,40,40,40 (Nk = 296)
                refused before any model or data is made.

17. ts_step    - the gradient teacher-student steps
                (`train/teacher_student.py`) at the flagship point (MiT-B5
                512x512 bf16, tanh GELU, 32 labeled + 32 unlabeled images,
                microbatch 16 x accum 2, eval-mode forwards, a seeded pair
                with the classifier bias at 2 so the pseudo-label gate keeps
                every sample): pseudo_label_step with the gate on, then off
                (the teacher's parameters, moments and count bit-equal
                across it), two pseudo_label_infer_steps and two
                labeled_steps, through the kernels and through the plain
                path: losses within TRAIN_LOSS_TOL, kept counts within 1,
                launches per call (pseudo_label_step 208 K1 and 104 K2, the
                infer step 52 and 0, labeled_step 416 and 208, 104 of them
                in the teacher's backward), the plain path none; ms per call
                and peak memory.
18. ts_cli     - `cli/teacher_student.py::main` without --ema-mode at the
                CLI point: 2 epochs --no-quirks --resume warm-started by
                --pretrain-weight from those seeded weights (epoch 0 updates
                the teacher in phase A, epoch 1 only pseudo-labels), then 1
                epoch in the default quirks mode (train mode) in a fresh
                directory: launches per phase from `epoch_report`, the
                teacher's Adam count after phase A, finite CSV rows,
                `load_last` exact for both models, the train-mode student's
                BatchNorm statistics moved.
19. ae_step    - two autoencoder steps (`train/autoencoder.py`, num_labels
                3, train mode) at the flagship point through the kernels and
                the plain path, then `ae_eval_step`: the MSE losses per
                element within TRAIN_LOSS_TOL, 208 K1 and 104 K2 per step
                and 52 K1 in the eval, the plain path none.
20. ae_cli     - `cli/autoencoder.py::main` at the CLI point, 2 epochs with
                --resume (the labeled, then the unlabeled tiles), then
                `cli/transfer.py::main --pretrain-weight <its best>` for 1
                epoch: at the transfer model's first use its encoder and
                decoder equal the checkpoint's and its classifier the
                checkpoint's channel 0; launches per train step and eval.

21. serve_ckpt - (run right after sup_cli) `cli/serve.py::main
                --pretrain-weight <sup_cli's best checkpoint>` at MiT-B5
                512x512 bf16: the server's weights equal the checkpoint's,
                and the masks it serves over HTTP equal
                `SegFormerModel.load(<checkpoint>).predict` of the same
                padded batches bit for bit, 52 wgmma K1 launches per batch.
22. fewshot_grad - MiT-B5 512x512 float32 (TF32 off) with a CLS token per
                stage, batch 2: the gradients of the autoencoder's pair loss
                (3 labels; recon + 100 x the cosine losses on the CLS token)
                and of the seg pair loss with cls_loss_weight 1.0 through
                the float32 kernels and through the plain path agree per
                tensor (GRAD_F32_TOL); every CLS token's gradient is
                non-zero; 208 K1 and 104 K2 launches per loss.
23. fewshot_step - at the flagship point (bf16, tanh GELU) with CLS tokens:
                two `fewshot_ae_step`s and two `fewshot_seg_step`s
                (cls_loss_weight 0, then 1.0) on batches of 2, through the
                kernels and through the plain path from one seeded state
                each: the losses within TRAIN_LOSS_TOL (the reconstruction
                MSE per element), 416/208 and 208/104 K1/K2 launches per
                step, the plain path none; ms per call and peak memory.
24. fewshot_cli - `cli/fewshot.py::main --synthetic --variant b5 --img-size
                512 --perf --iterations 4`: `--mode ae` 2 epochs with
                --resume, then a resumed third epoch; `--mode seg` 1 epoch,
                then `--predict` from its best checkpoint: CSV rows,
                checkpoint names, and the `epoch_report` launches per step
                and per eval batch.

Then the `kernels` summary line, the `nvidia-smi` name/power-limit line and,
last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12
# The operations rate of each dtype's kernels: bf16 on the tensor cores;
# float32 as 3xTF32 on the tensor cores (three TF32 products per float32
# product at 495 TFLOP/s), the least time the card could take since the
# float32 products run there.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
PEAK_RATE_NAME = {"bfloat16": "bf16 tensor cores, 989 TFLOP/s",
                  "float32": "3xTF32 on the TF32 tensor cores, 495 / 3 = "
                             "165 TFLOP/s"}
SEED = 0
# cuda_ms's sleep kernel: ~20 ms at the H100's 1.5-2 GHz clock.
SLEEP_CYCLES = 35_000_000
BATCH = 8
IMG = 512
B5_DEPTHS = (3, 6, 40, 3)
# The flagship EMA step: 2 microbatches of 16 labeled + 16 unlabeled images;
# the teacher runs one forward over 32, the student a forward, a recompute
# and a backward over 16.
ACCUM = 2
MICRO = 16
TEACHER_BATCH = 2 * MICRO
K1_PER_STEP = ACCUM * 3 * sum(B5_DEPTHS)      # 312
K2_PER_STEP = ACCUM * sum(B5_DEPTHS)          # 104
# (Nq, Nk, C, heads) of SR-attention at MiT-B5 512x512, one per stage.
STAGE_SHAPES = ((16384, 256, 64, 1), (4096, 256, 128, 2),
                (1024, 256, 320, 5), (256, 256, 512, 8))
# A 10-token prompt prefix at stage 1, a CLS token at stage 3.
PREFIX_SHAPES = ((16394, 266, 64, 1), (1025, 257, 320, 5))
# Kernel vs plain version. float32: both sum the same products in another
# order (2e-5, the CPU tests' bound). bfloat16: the output is rounded to
# bf16 (half an ulp is 2**-9 at magnitude 1), and a sum that lands on the
# other side of a rounding step flips one ulp; 1e-2 allows two ulps.
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# K2 vs its plain version, as a share of the largest gradient magnitude of
# each output. float32: dk and dv are sums over up to 16k query rows, which
# the kernel takes in splits and the plain version in one sequence; one
# sequential float32 sum of 16k terms is off by about sqrt(16k) * 2**-24
# ~ 1e-5 of its size, so two orders may differ by that much (a float64
# evaluation shows which side is closer). bfloat16: outputs one or two ulps
# (2**-7 relative) apart.
KERNEL_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# B5 in float32 through 52 layers: kernel vs plain mask probabilities.
MODEL_F32_TOL = 1e-4
# The serve gate: served bf16 masks are held to the float32 model (plain
# attention, TF32 off) no less closely than the plain bf16 path is. Every
# layer rounds to bf16, so one-ulp differences in attention outputs travel
# through 52 residual layers; two bf16 paths that sum in different orders
# are equally far from float32 but not bit-equal to each other.
# (1) The share of pixels whose 0.5-thresholded mask differs from float32's
# may exceed the plain path's share by at most this margin (a thousandth of
# the pixels, the margin the gate once gave against the plain path).
SERVE_MASK_DISAGREE = 1e-3
# (2) The mean |p - p_f32| may be at most this multiple of the plain
# path's: two bf16 roundings of equal size, and 10% covers their spread
# over 16 images.
SERVE_MEAN_ERR_RATIO = 1.10
# (3) The largest |p - p_plain| against the plain bf16 path.
SERVE_PROB_TOL = 5e-2
# B5 float32 gradients, kernels vs plain path, per parameter tensor as a
# share of its largest gradient: float32 sums in another order in K2,
# carried back through 52 layers. A tensor's scale is taken as at least a
# thousandth of the model's largest gradient: the key biases' gradient is
# zero in exact arithmetic (softmax ignores a shift shared by all keys), so
# both paths give rounding noise there, which this floor bounds.
GRAD_F32_TOL = 1e-3
GRAD_SCALE_FLOOR = 1e-3
# Two flagship bf16 steps, kernels vs plain path: the dice losses are means
# over 32 x 512 x 512 pixels of probabilities that differ by bf16 rounding
# carried through 52 layers; a sample at the pseudo-label gate's edge may
# flip, so kept counts may differ by one.
TRAIN_LOSS_TOL = 5e-3
TRAIN_KEPT_TOL = 1
# The train-mode BatchNorm statistics, kernels vs plain path in float32, as
# a share of each tensor's largest magnitude (at least 1): float32 means
# over 2 x 128 x 128 pixels of inputs that differ by the attention's
# rounding carried through 52 layers.
TRAIN_MODE_BN_TOL = 1e-5
# Augmentation, card vs CPU on the same choices: float32 resize weights
# summed in another order (images); gathers and nearest resizes (masks,
# exact).
AUGMENT_TOL = 1e-5
# The CLI phases: bench.py's flagship point through the CLIs, one train
# step (of TEACHER_BATCH tiles) per epoch and loop, which keeps every check
# within the script's time limit.
CLI_TILES = 32
CLI_EVAL_BATCH = max(CLI_TILES // 3, 4)        # 10 eval tiles, one batch
CLI_STEPS_PER_EPOCH = CLI_TILES // TEACHER_BATCH
# The supervised step: each of the 2 microbatches of 16 runs a forward, a
# recompute (full remat) and a backward through the 52 layers.
SUP_K1_PER_STEP = ACCUM * 2 * sum(B5_DEPTHS)   # 208
SUP_K2_PER_STEP = ACCUM * sum(B5_DEPTHS)       # 104
# The transfer configuration: stages 0 and 1 frozen, 10 shared prompt tokens
# per stage, so every layer's SR-attention sees 256 + 10 keys at 512x512.
TRANSFER_FROZEN = (0, 1)
TRANSFER_TOKENS = (10, 10, 10, 10)
TRANSFER_NK = 266
# (Nq, Nk, C, heads) of the transfer step's SR-attention: the prompt tokens
# join each stage's queries and keys.
TRANSFER_SHAPES = tuple((nq + t, nk + t, c, h) for (nq, nk, c, h), t
                        in zip(STAGE_SHAPES, TRANSFER_TOKENS))
TRANSFER_REFUSED_TOKENS = (40, 40, 40, 40)     # Nk = 296 > 288 in bf16
# The transfer grid's largest prompt (100 tokens per stage at 512x512: every
# layer's Nk is 356), which the float32 kernels take and bf16 refuses.
NK356_TOKENS = (100, 100, 100, 100)
NK356 = 356
NK356_SHAPES = tuple((nq + t, nk + t, c, h) for (nq, nk, c, h), t
                     in zip(STAGE_SHAPES, NK356_TOKENS))
# More float32 shapes past the bf16 limit: a 44-token prefix at stage 1
# (Nk 300), and stage 1 of a 1024x1024 input (Nq 65536, Nk 1024).
NK300_SHAPE = (16384 + 44, 300, 64, 1)
NK1024_SHAPE = (65536, 1024, 64, 1)
FROZEN_PREFIXES = tuple(f"segformer.encoder.block.{i}."
                        for i in TRANSFER_FROZEN)
# The gradient teacher-student steps at the flagship point (ts_step): a
# model's forward and recompute of a microbatch of 16 run K1 in each of the
# 52 layers, its backward K2. pseudo_label_step: the teacher over 2
# microbatches; pseudo_label_infer_step: one no-grad forward of 32;
# labeled_step: both models over 2 microbatches.
PSEUDO_K = (ACCUM * 2 * sum(B5_DEPTHS), ACCUM * sum(B5_DEPTHS))   # 208, 104
INFER_K = (sum(B5_DEPTHS), 0)                                   # 52, 0
LABELED_K = (2 * PSEUDO_K[0], 2 * PSEUDO_K[1])                  # 416, 208
# The CLI defaults of the two models' learning rates; the classifier bias of
# the ts phases' seeded weights, which puts the soft masks near 0.88 so the
# pseudo-label gate keeps every sample and phase A's update really moves
# the teacher.
TEACHER_LR, STUDENT_LR = 5e-7, 3e-5
TS_CLS_BIAS = 2.0
# The autoencoder: 3 labels; its CLI takes the labeled and then the
# unlabeled tiles, CLI_STEPS_PER_EPOCH train steps each.
AE_LABELS = 3
# Few-shot domain prompting (train/fewshot.py, cli/fewshot.py): batches of
# DataConfig.few_shot_batch_size, one CLS token per stage, so every layer's
# SR-attention has the CLS query row and one CLS key: Nq = H*W + 1 and
# Nk = 256 + 1 at 512x512.
FEW_BATCH = 2
FEW_CLS = (1, 1, 1, 1)
FEWSHOT_SHAPES = tuple((nq + 1, nk + 1, c, h) for nq, nk, c, h
                       in STAGE_SHAPES)
# A seg step runs 2 categories, the AE step 4 (two pairs): each a forward
# and a recompute (full remat) and a backward through the 52 layers.
FEWSHOT_SEG_K = (2 * 2 * sum(B5_DEPTHS), 2 * sum(B5_DEPTHS))   # 208, 104
FEWSHOT_AE_K = (2 * FEWSHOT_SEG_K[0], 2 * FEWSHOT_SEG_K[1])    # 416, 208
# The few-shot CLI phase: 6 synthetic tiles per domain (3 domains per
# group), 4 eval tiles in one batch, 4 iterations an epoch.
FEWSHOT_CLI_TILES = 6
FEWSHOT_CLI_ITERS = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn()` in ms, by CUDA events after warm-up. The
    timed calls are queued behind a sleep kernel (~20 ms, longer than the
    host takes to issue them), so the events see the device run them back
    to back rather than the host's pace of issuing them: a launch shorter
    than its host call (~40 us for `sr_attention`) is not timed as the
    host call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_us(fn, iters: int = 50) -> float:
    """Mean host microseconds of one call of `fn()` (the device runs
    behind: no synchronisation inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    us = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return us


def _bound(n_bytes, flops, dtype_name):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(b, nq, nk, c, dtype_name):
    """(bound ms, "bytes" or "operations") of SR-attention at a shape:
    q, k, v read once and the output written once; 4*B*Nq*Nk*C flops at
    the rate of the dtype's kernel (`PEAK_FLOPS`, `PEAK_RATE_NAME`)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    return _bound((2 * b * nq * c + 2 * b * nk * c) * elem,
                  4 * b * nq * nk * c, dtype_name)


def attention_bwd_bound(b, nq, nk, c, dtype_name):
    """(bound ms, "bytes" or "operations") of the SR-attention backward: q,
    g and dq (B*Nq*C each) and k, v, dk and dv (B*Nk*C each) moved once;
    10*B*Nq*Nk*C flops (five products) at the rate of the dtype's kernels
    (`PEAK_FLOPS`)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    return _bound((3 * b * nq * c + 4 * b * nk * c) * elem,
                  10 * b * nq * nk * c, dtype_name)


def _attention_f64(q, k, v, h):
    import torch

    b, nq, c = q.shape
    d = c // h
    qh, kh, vh = (t.double().reshape(b, -1, h, d) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) / d ** 0.5,
                      dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, nq, c)


def _attention_bwd_f64(q, k, v, g, h):
    """The exact backward in float64 (no rounding of ds): an independent
    check of the kernel and the plain version in float32."""
    import torch

    b, nq, c = q.shape
    d = c // h
    qh, kh, vh, gh = (t.double().reshape(b, -1, h, d) for t in (q, k, v, g))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) / d ** 0.5,
                      dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / d ** 0.5
    del p, dp
    return (torch.einsum("bhqk,bkhd->bqhd", ds, kh).reshape(b, nq, c),
            torch.einsum("bhqk,bqhd->bkhd", ds, qh).reshape(b, -1, c),
            dv.reshape(b, -1, c))


def _rel_err(got, ref):
    """Largest error over the outputs, each as a share of its largest
    magnitude."""
    return max((a.double() - r.double()).abs().max().item()
               / r.double().abs().max().item() for a, r in zip(got, ref))


def _heads(t, h):
    """(B, N, C) -> the (B, h, N, d) view `F.scaled_dot_product_attention`
    takes."""
    b, n, c = t.shape
    return t.view(b, n, h, c // h).transpose(1, 2)


def _reset_counts():
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention,
        sr_attention_bwd,
    )

    sr_attention.launches = 0
    sr_attention.mma_launches = 0
    sr_attention_bwd.launches = 0


def _counts():
    """Launches of K1 (all), K2, and K1's wgmma kernel."""
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention,
        sr_attention_bwd,
    )

    return (sr_attention.launches, sr_attention_bwd.launches,
            sr_attention.mma_launches)


def phase_device():
    import torch

    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "nvidia_smi": nvidia_smi_line()})


def _ptxas_kernels(log: str) -> dict:
    """{kernel symbol: registers, stack and spill bytes} from nvcc's
    `-Xptxas -v` output."""
    kernels, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = kernels.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = kernels.get(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return kernels


def _sass_tensor_ops(lib_path: str) -> dict:
    """{kernel symbol: {"HMMA": n, "HGMMA": n}} counted in the SASS of a
    built library."""
    from semisupervisedobjectdetection_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    out = subprocess.run([tool, "--dump-sass", lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = counts.setdefault(m.group(1), {"HMMA": 0, "HGMMA": 0})
        elif cur is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", ln):
                    cur[op] += 1
                    break
    return counts


def _demangle(symbols):
    """Readable kernel names (namespace and argument list dropped), by
    cu++filt or c++filt where one is found, else the symbols as they are."""
    from semisupervisedobjectdetection_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cu++filt")
    if not os.path.isfile(tool):
        tool = shutil.which("c++filt")
    if tool is None:
        return dict(zip(symbols, symbols))
    out = subprocess.run([tool], input="\n".join(symbols), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    if len(out) != len(symbols):
        return dict(zip(symbols, symbols))
    return {sym: re.sub(r"^void |\(anonymous namespace\)::|<unnamed>::|"
                        r"\(int\)", "", name).split("(")[0]
            for sym, name in zip(symbols, out)}


def _design(sym: str) -> str:
    """A kernel's design from its symbol: the bf16 wgmma kernels, the
    float32 3xTF32 ones (products on wgmma too), or a split sum."""
    if "_wgmma_kernel" in sym:
        return "wgmma"
    if "_f32_" in sym and "_sum_" not in sym:
        return "3xtf32"
    return "sum"


def phase_build():
    from semisupervisedobjectdetection_torch.ops import _build
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        _BWD_SOURCE,
        _SOURCE,
        MAX_NK,
        _bwd_lib,
        _lib,
    )

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        lib, bwd = [f.result() for f in [pool.submit(_lib),
                                         pool.submit(_bwd_lib)]]
    seconds = time.perf_counter() - t0
    # the CLIs refuse, before building a model, what the kernels of the
    # config's dtype refuse: bf16 Nk > MAX_NK, float32 nothing (0)
    limits = {"bfloat16": (lib.sr_attention_fwd_max_nk(2),
                           bwd.sr_attention_bwd_max_nk(2)),
              "float32": (lib.sr_attention_fwd_max_nk(4),
                          bwd.sr_attention_bwd_max_nk(4))}
    if limits != {"bfloat16": (MAX_NK, MAX_NK), "float32": (0, 0)}:
        raise AssertionError(f"kernels take Nk <= {limits} (0: any); the "
                             f"wrapper's bf16 MAX_NK is {MAX_NK}")
    rows = []
    for source in (_SOURCE, _BWD_SOURCE):
        info = _build.BUILD_INFO[source]
        # ptxas reports static shared memory only; the kernels' is dynamic
        extra = {}
        if source == _SOURCE:
            smem = {f"nk{nk}_d64_{name}":
                    lib.sr_attention_fwd_smem_bytes(nk, 64, elem)
                    for nk in (256, 266) for name, elem in (
                        ("bf16_wgmma", 2), ("f32_3xtf32", 4))}
            # the wgmma kernel's CTAs per SM (shared memory and its 384
            # threads at 168 registers allow one)
            extra["wgmma_ctas_per_sm"] = {
                f"nk{nk}_d{d}": lib.sr_attention_fwd_wgmma_ctas_per_sm(nk, d)
                for nk in (256, 266) for d in (32, 64)}
        else:
            smem = {f"nk{nk}_d64_{name}":
                    bwd.sr_attention_bwd_smem_bytes(nk, 64, elem)
                    for nk in (256, 266) for name, elem in (
                        ("bf16_wgmma", 2), ("f32_3xtf32", 4))}
        extra["nk_limit"] = limits
        emit({"phase": "build", "source": source,
              "seconds": round(seconds, 3),
              "nvcc_seconds": round(info["seconds"], 3),
              "sources_hashed": [p.name for p in _build.source_files(
                  _build.CSRC / source)],
              "dynamic_smem_bytes": smem, **extra,
              "ptxas_warnings": [ln.strip() for ln in info["log"].splitlines()
                                 if "warning" in ln.lower()]})
        ptxas = _ptxas_kernels(info["log"])
        sass = _sass_tensor_ops(info["path"])
        names = _demangle(sorted(sass))
        for sym in sorted(sass):
            row = {"phase": "build", "source": source, "kernel": names[sym],
                   "design": _design(sym),
                   "tensor_core_instructions": sass[sym],
                   **ptxas.get(sym, {})}
            emit(row)
            rows.append(row)
    # every tensor-core kernel on wgmma (HGMMA and no HMMA): K1's and K2's
    # bf16 kernels, four instantiations each (d 32/64 by Nk <= 256/288);
    # K1's float32 kernel and K2's float32 row and key passes, two each
    # (d 32/64)
    want = {(_SOURCE, "wgmma"): 4, (_BWD_SOURCE, "wgmma"): 4,
            (_SOURCE, "3xtf32"): 2, (_BWD_SOURCE, "3xtf32"): 4}
    tensor = [r for r in rows if r["design"] in ("wgmma", "3xtf32")]
    for (source, design), n in want.items():
        mine = [r for r in tensor
                if (r["source"], r["design"]) == (source, design)]
        if len(mine) != n or any(
                r["tensor_core_instructions"]["HGMMA"] == 0
                or r["tensor_core_instructions"]["HMMA"] for r in mine):
            raise AssertionError(f"{source}: {design} kernels without HGMMA "
                                 f"or with HMMA, or not {n}: {mine}")
    # their tiles live in registers: a stack frame or spills would put
    # them in local memory
    local = [r for r in tensor if r.get("stack_bytes", 1)
             or r.get("spill_store_bytes", 1)]
    if local:
        raise AssertionError(f"tensor-core kernels with local memory: "
                             f"{local}")
    return rows


def _k1_cases():
    """(batch, shape, dtype, design) of the K1 checks: the bf16 kernel
    (wgmma) at the stage shapes at the serving, student and teacher
    batches, at the prefix shapes at the serving batch, at the transfer
    step's shapes at the student batch and at the few-shot shapes (batch
    2); the float32 kernel (3xTF32) at the stage and prefix shapes at the
    serving batch, at the few-shot and transfer shapes at batch 2 (as
    fewshot_grad and transfer_grad run them), and past the bf16 limit: the
    Nk-356 shapes (100 prompt tokens per stage, transfer_grad_nk356) at
    batch 2, Nk 300 at batch 2 and Nk 1024 (stage 1 at 1024x1024) at
    batch 1."""
    cases = [(b, s, "bfloat16", "wgmma")
             for b in (BATCH, MICRO, TEACHER_BATCH) for s in STAGE_SHAPES]
    cases += [(BATCH, s, "float32", "3xtf32")
              for s in STAGE_SHAPES + PREFIX_SHAPES]
    cases += [(BATCH, s, "bfloat16", "wgmma") for s in PREFIX_SHAPES]
    cases += [(MICRO, s, "bfloat16", "wgmma") for s in TRANSFER_SHAPES]
    cases += [(FEW_BATCH, s, d, design) for s in FEWSHOT_SHAPES
              for d, design in (("bfloat16", "wgmma"),
                                ("float32", "3xtf32"))]
    cases += [(FEW_BATCH, s, "float32", "3xtf32")
              for s in TRANSFER_SHAPES + NK356_SHAPES + (NK300_SHAPE,)]
    cases += [(1, NK1024_SHAPE, "float32", "3xtf32")]
    return cases


def phase_kernel():
    import torch
    import torch.nn.functional as F

    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention,
        sr_attention_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for b, shape, dtype_name, design in _k1_cases():
        nq, nk, c, h = shape
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn(b, n, c, device="cuda", generator=gen)
                   .to(dtype) for n in (nq, nk, nk))
        out = sr_attention(q, k, v, h)
        again = sr_attention(q, k, v, h)
        torch.cuda.synchronize()
        ref = sr_attention_reference(q, k, v, h)
        err = (out.float() - ref.float()).abs().max().item()
        ne_plain = (out != ref).float().mean().item()
        rerun_equal = bool(torch.equal(out, again))
        ok = bool(torch.isfinite(out).all().item()) \
            and err <= KERNEL_TOL[dtype_name] and rerun_equal
        # the exact function in float64 (no bf16 rounding of p): an
        # independent check of both versions
        f64 = _attention_f64(q, k, v, h)
        err64 = (out.double() - f64).abs().max().item()
        del f64
        qs, ks, vs = (_heads(t, h) for t in (q, k, v))
        bound, by = attention_bound(b, nq, nk, c, dtype_name)
        row = {"phase": "kernel", "name": "sr_attention_fwd",
               "B": b, "Nq": nq, "Nk": nk, "C": c, "heads": h,
               "dtype": dtype_name, "design": design, "max_abs_err": err,
               "share_ne_plain": ne_plain, "rerun_bit_equal": rerun_equal,
               "tol": KERNEL_TOL[dtype_name], "ok": ok,
               "max_abs_err_vs_f64": err64,
               "ms": cuda_ms(lambda: sr_attention(q, k, v, h)),
               "host_us_per_call": host_us(lambda: sr_attention(q, k, v, h)),
               "plain_ms": cuda_ms(
                   lambda: sr_attention_reference(q, k, v, h), iters=5),
               "library_ms": cuda_ms(
                   lambda: F.scaled_dot_product_attention(qs, ks, vs)),
               "bound_ms": bound, "bound_by": by,
               "bound_rate": PEAK_RATE_NAME[dtype_name]}
        emit(row)
        rows.append(row)
        del q, k, v, out, again, ref, qs, ks, vs
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version or "
                             f"with its rerun: {bad}")
    return rows


def phase_kernel_bwd():
    import torch
    import torch.nn.functional as F

    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        _sm_count,
        bwd_f32_plan,
        bwd_launch_plan,
        sr_attention_backward_reference,
        sr_attention_bwd,
    )
    from semisupervisedobjectdetection_torch.utils.profile_forward import (
        kernels_launched,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    # every stage and prefix shape in both types; the transfer step's shapes
    # not among them in bf16; the few-shot shapes at batch 2 in both types;
    # in float32 at batch 2 the transfer shapes (transfer_grad's), the
    # Nk-356 shapes (transfer_grad_nk356's) and Nk 300, and Nk 1024 at
    # batch 1
    cases = [(MICRO, s, d) for s in STAGE_SHAPES + PREFIX_SHAPES
             for d in ("bfloat16", "float32")]
    cases += [(MICRO, s, "bfloat16") for s in TRANSFER_SHAPES
              if s not in PREFIX_SHAPES]
    cases += [(FEW_BATCH, s, d) for s in FEWSHOT_SHAPES
              for d in ("bfloat16", "float32")]
    cases += [(FEW_BATCH, s, "float32")
              for s in TRANSFER_SHAPES + NK356_SHAPES + (NK300_SHAPE,)]
    cases += [(1, NK1024_SHAPE, "float32")]
    for b, shape, dtype_name in cases:
        nq, nk, c, h = shape
        dtype = getattr(torch, dtype_name)
        q, k, v, g = (torch.randn(b, n, c, device="cuda",
                                  generator=gen).to(dtype)
                      for n in (nq, nk, nk, nq))
        got = sr_attention_bwd(q, k, v, g, h)
        again = sr_attention_bwd(q, k, v, g, h)
        torch.cuda.synchronize()
        ref = sr_attention_backward_reference(q, k, v, g, h)
        errs = [(a.float() - r.float()).abs().max().item()
                for a, r in zip(got, ref)]
        scales = [r.float().abs().max().item() for r in ref]
        rel = _rel_err(got, ref)
        vs_f64 = {}
        if dtype_name == "float32":
            f64 = _attention_bwd_f64(q, k, v, g, h)
            vs_f64 = {"rel_err_vs_f64": _rel_err(got, f64),
                      "plain_rel_err_vs_f64": _rel_err(ref, f64)}
            del f64
        same = all(torch.equal(a, a2) for a, a2 in zip(got, again))
        finite = all(bool(torch.isfinite(a).all().item()) for a in got)
        # the kernels one call ran on the card, as the profiler saw them,
        # against those its design launches: the bf16 wgmma kernel (and the
        # split sum where the plan splits a (batch, head)), or the float32
        # row and key passes (and their split sum), and nothing of an
        # earlier design; their number against the count the C launcher
        # reported
        _, kernels = kernels_launched(
            lambda: sr_attention_bwd(q, k, v, g, h), "sr_attention_bwd")
        if dtype_name == "bfloat16":
            plan = bwd_launch_plan(b, nq, nk, c, h, _sm_count(0))
            want = list(plan["kernels"])
            design = {"design": "wgmma", "grid": plan["grid"],
                      "split": plan["split"],
                      "host_us_per_call": host_us(
                          lambda: sr_attention_bwd(q, k, v, g, h))}
        else:
            plan = bwd_f32_plan(b, nq, nk, c, h, _sm_count(0))
            want = list(plan["kernels"])
            design = {"design": "3xtf32",
                      "row_ctas_per_pair": plan["row_ctas_per_pair"],
                      "key_groups": plan["key_groups"],
                      "key_pass_splits": plan["splits"],
                      "host_us_per_call": host_us(
                          lambda: sr_attention_bwd(q, k, v, g, h))}
        if kernels != want or sr_attention_bwd.last_launches != len(want):
            raise AssertionError(
                f"{dtype_name} K2 ran {kernels} on the card and its launcher "
                f"counted {sr_attention_bwd.last_launches}; its design "
                f"launches {want}")
        del got, again, ref
        # the yardstick: the autograd backward of SDPA on the same
        # q, k, v, g (flash/efficient kernels; the port never calls it)
        qs, ks, vs = (_heads(t, h).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        gs = _heads(g, h)
        bound, by = attention_bwd_bound(b, nq, nk, c, dtype_name)
        row = {"phase": "kernel_bwd", "name": "sr_attention_bwd",
               "B": b, "Nq": nq, "Nk": nk, "C": c, "heads": h,
               "dtype": dtype_name, **design, "kernels": kernels,
               "launches_per_call": len(kernels),
               "max_abs_err": max(errs),
               "max_abs_err_dq_dk_dv": errs, "ref_max_dq_dk_dv": scales,
               "rel_err": rel, "tol_rel": KERNEL_BWD_TOL[dtype_name],
               **vs_f64, "bit_identical_rerun": same,
               "ok": finite and same and
               rel <= KERNEL_BWD_TOL[dtype_name],
               "ms": cuda_ms(lambda: sr_attention_bwd(q, k, v, g, h),
                             iters=10),
               "plain_ms": cuda_ms(
                   lambda: sr_attention_backward_reference(q, k, v, g,
                                                           h), iters=3),
               "library_ms": cuda_ms(
                   lambda: torch.autograd.grad(out, (qs, ks, vs), gs,
                                               retain_graph=True),
                   iters=10),
               "bound_ms": bound, "bound_by": by,
               "bound_rate": PEAK_RATE_NAME[dtype_name]}
        emit(row)
        rows.append(row)
        del q, k, v, g, qs, ks, vs, out, gs
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version or is "
                             f"not deterministic: {bad}")
    return rows


def phase_model_f32():
    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import mit_b5

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mit_b5(dtype="float32")
    imgs = np.random.default_rng(SEED).uniform(
        size=(2, IMG, IMG, 3)).astype(np.float32)
    kern = SegFormerModel(config=cfg, seed=SEED).predict(imgs)
    plain = SegFormerModel(config=cfg.replace(attn_impl="plain"),
                           seed=SEED).predict(imgs)
    err = float(np.abs(kern - plain).max())
    emit({"phase": "model", "variant": "b5", "img": IMG, "dtype": "float32",
          "batch": 2, "max_abs_err": err, "tol": MODEL_F32_TOL})
    if not (np.isfinite(kern).all() and kern.shape == (2, IMG, IMG)
            and err <= MODEL_F32_TOL):
        raise AssertionError("float32 B5 kernel path disagrees with the "
                             "plain path")
    torch.cuda.empty_cache()


def _png(arr_u8) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr_u8).save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, raw):
    headers = {"Content-Type": "application/octet-stream"} if raw else {}
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, dict(r.headers), r.read()


def phase_serve(smi: str):
    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.cli.serve import InferenceServer
    from semisupervisedobjectdetection_torch.core.config import mit_b5
    from semisupervisedobjectdetection_torch.utils import serve_gate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mit_b5(dtype="bfloat16")
    per_forward = sum(cfg.depths)
    model = SegFormerModel(config=cfg, seed=SEED)
    srv = InferenceServer(model, img_size=IMG, max_batch=BATCH,
                          batch_window_ms=50.0, variant="b5")
    port = srv.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        rng = np.random.default_rng(SEED)
        n_raw = 16
        imgs = rng.integers(0, 256, (n_raw + 2, IMG, IMG, 3), dtype=np.uint8)
        results = [None] * (n_raw + 2)

        def client(i):
            if i < n_raw:
                results[i] = _post(base + "/predict?format=npy",
                                   imgs[i].tobytes(), raw=True)
            else:
                results[i] = _post(base + "/predict", _png(imgs[i]),
                                   raw=False)

        torch.cuda.reset_peak_memory_stats()
        before = srv.snapshot_stats()
        _reset_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_raw + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches, _, mma_launches = _counts()
        after = srv.snapshot_stats()
    finally:
        srv.stop()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("a request did not finish")
    batches = after["batches"] - before["batches"]
    statuses = [r[0] for r in results]
    probs = np.stack([np.load(io.BytesIO(r[2])) for r in results[:n_raw]])
    from PIL import Image

    pngs = [np.asarray(Image.open(io.BytesIO(r[2]))) for r in
            results[n_raw:]]
    del model
    # the gate's other paths on the same raw images, in batches of 8
    x = imgs[:n_raw].astype(np.float32) / 255.0
    dev = torch.device("cuda")
    paths = {"served": probs,
             "plain": serve_gate.masks(cfg.replace(attn_impl="plain"), x,
                                       SEED, dev)}
    f32 = serve_gate.masks(cfg.replace(dtype="float32", attn_impl="plain"),
                           x, SEED, dev)
    gate = serve_gate.readings(paths, f32)
    flips, mean_err = (gate["mask_flip_vs_float32"],
                       gate["mean_abs_err_vs_float32"])
    checks = {
        "flips_vs_float32": flips["served"]
        <= flips["plain"] + SERVE_MASK_DISAGREE,
        "mean_err_vs_float32": mean_err["served"]
        <= SERVE_MEAN_ERR_RATIO * mean_err["plain"],
        "max_err_vs_plain": gate["max_abs_err_vs_plain"]["served"]
        <= SERVE_PROB_TOL}
    row = {"phase": "serve", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "max_batch": BATCH, "requests": n_raw + 2,
           "statuses": sorted(set(statuses)), "batches": batches,
           "launches": launches, "launches_expected": per_forward * batches,
           "launches_mma": mma_launches,
           "wall_s": wall, "img_per_s": (n_raw + 2) / wall,
           "latency_ms": after.get("latency_ms"),
           "mean_batch_fill": after["mean_batch_fill"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "healthz": health, "gate": gate, "gate_checks": checks,
           "gate_bounds": {"mask_flip_margin": SERVE_MASK_DISAGREE,
                           "mean_err_ratio": SERVE_MEAN_ERR_RATIO,
                           "max_abs_err_vs_plain": SERVE_PROB_TOL},
           "card": smi}
    emit(row)
    torch.cuda.empty_cache()
    if set(statuses) != {200}:
        raise AssertionError(f"non-200 responses: {statuses}")
    if probs.shape != (n_raw, IMG, IMG) or not np.isfinite(probs).all():
        raise AssertionError(f"bad served masks: {probs.shape}")
    if any(p.shape != (IMG, IMG) for p in pngs):
        raise AssertionError("bad PNG masks")
    if batches < 1 or launches != per_forward * batches or \
            mma_launches != launches:
        raise AssertionError(f"{launches} kernel launches ({mma_launches} "
                             f"wgmma) for {batches} batches; expected "
                             f"{per_forward} wgmma per batch")
    if health.get("platform") != "cuda":
        raise AssertionError(f"/healthz reports {health}")
    if not all(checks.values()):
        raise AssertionError(f"served masks fail the serve gate: {checks}")
    return row


def phase_grad():
    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch import losses
    from semisupervisedobjectdetection_torch.core.config import mit_b5
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.common import (
        forward_masks,
        grads_of,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mit_b5(dtype="float32")
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.uniform(size=(2, IMG, IMG, 3))
                         .astype(np.float32)).cuda()
    gt, tm = (torch.from_numpy((rng.uniform(size=(2, IMG, IMG)) > p)
                               .astype(np.float32)).cuda()
              for p in (0.7, 0.5))
    grads, launches = {}, {}
    for impl in ("kernel", "plain"):
        model = init_weights(SegFormer(cfg.replace(attn_impl=impl)),
                             torch.Generator().manual_seed(SEED)).cuda()
        _reset_counts()
        pred, _, _ = forward_masks(model, x)
        loss = 0.8 * losses.dice_loss(pred, gt) + \
            0.2 * losses.dice_loss(pred, tm)
        grads[impl] = grads_of(loss, dict(model.named_parameters()))
        torch.cuda.synchronize()
        launches[impl] = _counts()[:2]
        del model, pred, loss
    scales = {n: g.abs().max().item() for n, g in grads["plain"].items()}
    floor = GRAD_SCALE_FLOOR * max(scales.values())
    rel = {n: (gk - grads["plain"][n]).abs().max().item()
           / max(scales[n], floor) for n, gk in grads["kernel"].items()}
    worst = [(n, r, scales[n]) for n, r in
             sorted(rel.items(), key=lambda kv: -kv[1])[:5]]
    finite = all(bool(torch.isfinite(g).all().item())
                 for g in grads["kernel"].values())
    row = {"phase": "grad", "variant": "b5", "img": IMG, "dtype": "float32",
           "batch": 2, "tensors": len(rel), "max_rel_diff": worst[0][1],
           "worst_name_rel_scale": worst, "tol_rel": GRAD_F32_TOL,
           "scale_floor": floor,
           "median_rel_diff": float(np.median(list(rel.values()))),
           "launches_k1_k2": launches["kernel"],
           "launches_plain_path": launches["plain"]}
    emit(row)
    del grads
    torch.cuda.empty_cache()
    per = sum(cfg.depths)
    if launches["kernel"] != (2 * per, per) or launches["plain"] != (0, 0):
        raise AssertionError(f"launches {launches}: expected K1 {2 * per} "
                             f"(forward and recompute) and K2 {per}")
    if not finite or worst[0][1] > GRAD_F32_TOL:
        raise AssertionError("B5 float32 gradients through the kernels "
                             "disagree with the plain path")
    return row


def _step_losses(out):
    return [float(x) for x in (out.student_loss_total, out.student_sup_loss,
                               out.self_supervise_loss, out.pseudo_loss)]


def phase_train(smi: str):
    import math

    import torch

    from semisupervisedobjectdetection_torch import bench

    dev = torch.device("cuda")
    cfg = bench.flagship_config()
    batch = ACCUM * MICRO
    w = bench.make_workload(cfg, batch, IMG, ACCUM, dev, seed=SEED)
    t0 = time.perf_counter()
    for _ in range(2):
        float(w.step().student_loss_total)
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    r = bench.time_steps(w, warmup=0, windows=1, inner=4)
    k1, k2, k1_mma = _counts()
    peak = torch.cuda.max_memory_allocated(dev)
    out = r["out"]
    losses = _step_losses(out)
    n_kept = float(out.n_kept)

    # the teacher moves by exactly decay*t + (1-decay)*s of the new student
    t0_vars = {n: p.detach().clone() for n, p in
               list(w.teacher.params.items())
               + list(w.teacher.batch_stats.items())}
    _reset_counts()
    w.step()
    one_k1, one_k2, _ = _counts()
    decay = torch.tensor(bench.EMA_DECAY, dtype=torch.float32, device=dev)
    s_vars = {**w.student.params, **w.student.batch_stats}
    t_vars = {**w.teacher.params, **w.teacher.batch_stats}
    ema_err = max((t_vars[n] - (decay * t0 + (1.0 - decay) * s_vars[n]))
                  .abs().max().item() for n, t0 in t0_vars.items())
    del w, t0_vars, s_vars, t_vars
    torch.cuda.empty_cache()

    # two steps from one state through the kernels and the plain path
    compare = {}
    for impl in ("kernel", "plain"):
        wi = bench.make_workload(cfg.replace(attn_impl=impl), batch, IMG,
                                 ACCUM, dev, seed=SEED)
        compare[impl] = []
        for _ in range(2):
            o = wi.step()
            compare[impl].append(_step_losses(o) + [float(o.n_kept)])
        del wi, o
        torch.cuda.empty_cache()
    loss_diff = max(abs(a - b) for sk, sp in zip(compare["kernel"],
                                                 compare["plain"])
                    for a, b in zip(sk[:3], sp[:3]))
    kept_diff = max(abs(sk[4] - sp[4]) for sk, sp in zip(compare["kernel"],
                                                         compare["plain"]))
    pseudo_ok = all(
        (math.isnan(sk[3]) and math.isnan(sp[3]))
        or abs(sk[3] - sp[3]) <= TRAIN_LOSS_TOL
        or sk[4] != sp[4]
        for sk, sp in zip(compare["kernel"], compare["plain"]))
    step_s = r["step_s"]
    row = {"phase": "train", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "gelu": "tanh", "micro_batch": MICRO,
           "accum": ACCUM, "images_per_step": 2 * batch,
           "warmup_s": warmup_s, "timed_steps": 4, "step_ms": step_s * 1e3,
           "img_per_s": 2 * batch / step_s,
           "max_memory_allocated_bytes": peak,
           "launches_k1": k1, "launches_k2": k2, "launches_k1_mma": k1_mma,
           "launches_per_step": [k1 / 4, k2 / 4],
           "launches_expected_per_step": [K1_PER_STEP, K2_PER_STEP],
           "losses_total_sup_selfsup_pseudo": losses, "n_kept": n_kept,
           "ema_max_abs_err": ema_err, "ema_step_launches": [one_k1, one_k2],
           "kernel_vs_plain_steps": compare,
           "loss_max_abs_diff": loss_diff, "loss_tol": TRAIN_LOSS_TOL,
           "kept_max_diff": kept_diff, "kept_tol": TRAIN_KEPT_TOL,
           "card": smi}
    emit(row)
    if (k1, k2) != (4 * K1_PER_STEP, 4 * K2_PER_STEP) or k1_mma != k1 or \
            (one_k1, one_k2) != (K1_PER_STEP, K2_PER_STEP):
        raise AssertionError(f"launches K1 {k1} ({k1_mma} tensor-core), K2 "
                             f"{k2} in 4 steps, {one_k1}, {one_k2} in one: "
                             f"expected {K1_PER_STEP} tensor-core and "
                             f"{K2_PER_STEP} per step")
    if not all(math.isfinite(x) for x in losses[:3]) or \
            not 0.0 <= n_kept <= batch:
        raise AssertionError(f"bad step outputs: losses {losses}, "
                             f"n_kept {n_kept}")
    if ema_err != 0.0:
        raise AssertionError(f"the teacher is not the EMA of the student "
                             f"(max abs error {ema_err})")
    if loss_diff > TRAIN_LOSS_TOL or kept_diff > TRAIN_KEPT_TOL or \
            not pseudo_ok:
        raise AssertionError("kernel and plain EMA steps disagree")
    return row


def _bn_stats(model):
    bn = model.decode_head.batch_norm
    return {"decode_head.batch_norm.running_mean": bn.running_mean,
            "decode_head.batch_norm.running_var": bn.running_var}


def phase_train_mode(smi: str):
    import math

    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch import bench, losses
    from semisupervisedobjectdetection_torch.core.config import mit_b5
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.common import (
        forward_masks,
        grads_of,
    )
    from semisupervisedobjectdetection_torch.train.ema import ema_semi_step

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mit_b5(dtype="float32")
    rates = (cfg.drop_path_rate, cfg.classifier_dropout)
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy(rng.uniform(size=(2, IMG, IMG, 3))
                         .astype(np.float32)).cuda()
    gt, tm = (torch.from_numpy((rng.uniform(size=(2, IMG, IMG)) > p)
                               .astype(np.float32)).cuda()
              for p in (0.7, 0.5))
    grads, stats, launches = {}, {}, {}
    for impl in ("kernel", "plain"):
        model = init_weights(SegFormer(cfg.replace(attn_impl=impl)),
                             torch.Generator().manual_seed(SEED)).cuda()
        _reset_counts()
        pred, _, stats[impl] = forward_masks(
            model, x, train_mode=True,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        loss = 0.8 * losses.dice_loss(pred, gt) + \
            0.2 * losses.dice_loss(pred, tm)
        grads[impl] = grads_of(loss, dict(model.named_parameters()))
        torch.cuda.synchronize()
        launches[impl] = _counts()[:2]
        initial = {n: b.clone() for n, b in _bn_stats(model).items()}
        del model, pred, loss
    scales = {n: g.abs().max().item() for n, g in grads["plain"].items()}
    floor = GRAD_SCALE_FLOOR * max(scales.values())
    rel = {n: (gk - grads["plain"][n]).abs().max().item()
           / max(scales[n], floor) for n, gk in grads["kernel"].items()}
    worst = [(n, r, scales[n]) for n, r in
             sorted(rel.items(), key=lambda kv: -kv[1])[:5]]
    finite = all(bool(torch.isfinite(g).all().item())
                 for g in grads["kernel"].values())
    bn_err = max((a - stats["plain"][n]).abs().max().item()
                 / max(1.0, stats["plain"][n].abs().max().item())
                 for n, a in stats["kernel"].items())
    bn_moved = all(not torch.equal(stats["kernel"][n], t)
                   for n, t in initial.items())
    del grads, stats
    torch.cuda.empty_cache()

    # two flagship train-mode EMA steps from one state and one seed
    flag = bench.flagship_config()
    batch = ACCUM * MICRO
    compare, step_launches, student_bn_moved, step_ms = {}, {}, {}, {}
    for impl in ("kernel", "plain"):
        w = bench.make_workload(flag.replace(attn_impl=impl), batch, IMG,
                                ACCUM, dev, seed=SEED)
        g = torch.Generator(device=dev).manual_seed(SEED)
        initial = {n: b.clone() for n, b in _bn_stats(w.student.model)
                   .items()}
        compare[impl], step_ms[impl] = [], []
        _reset_counts()
        for _ in range(2):
            t0 = time.perf_counter()
            o = ema_semi_step(w.teacher, w.student, w.unlabeled, w.images,
                              w.masks, bench.SUPERVISE_WEIGHT,
                              bench.EMA_DECAY, accum=ACCUM, train_mode=True,
                              generator=g)
            compare[impl].append(_step_losses(o) + [float(o.n_kept)])
            step_ms[impl].append((time.perf_counter() - t0) * 1e3)
        step_launches[impl] = _counts()
        student_bn_moved[impl] = all(
            not torch.equal(b, initial[n])
            for n, b in _bn_stats(w.student.model).items())
        del w, o
        torch.cuda.empty_cache()
    loss_diff = max(abs(a - b) for sk, sp in zip(compare["kernel"],
                                                 compare["plain"])
                    for a, b in zip(sk[:3], sp[:3]))
    kept_diff = max(abs(sk[4] - sp[4]) for sk, sp in zip(compare["kernel"],
                                                         compare["plain"]))
    pseudo_ok = all(
        (math.isnan(sk[3]) and math.isnan(sp[3]))
        or abs(sk[3] - sp[3]) <= TRAIN_LOSS_TOL
        or sk[4] != sp[4]
        for sk, sp in zip(compare["kernel"], compare["plain"]))
    k1, k2, k1_mma = step_launches["kernel"]
    row = {"phase": "train_mode", "variant": "b5", "img": IMG,
           "drop_path_rate": rates[0], "classifier_dropout": rates[1],
           "f32_batch": 2, "tensors": len(rel), "max_rel_diff": worst[0][1],
           "worst_name_rel_scale": worst, "tol_rel": GRAD_F32_TOL,
           "scale_floor": floor, "bn_max_rel_diff": bn_err,
           "bn_tol": TRAIN_MODE_BN_TOL, "bn_moved": bn_moved,
           "f32_launches_k1_k2": launches["kernel"],
           "f32_launches_plain_path": launches["plain"],
           "flagship_steps": compare, "loss_max_abs_diff": loss_diff,
           "loss_tol": TRAIN_LOSS_TOL, "kept_max_diff": kept_diff,
           "kept_tol": TRAIN_KEPT_TOL,
           "launches_k1": k1, "launches_k2": k2, "launches_k1_mma": k1_mma,
           "launches_plain_path": step_launches["plain"][:2],
           "student_bn_moved": student_bn_moved,
           "step_ms_kernel_plain": step_ms, "card": smi}
    emit(row)
    per = sum(cfg.depths)
    if launches["kernel"] != (2 * per, per) or launches["plain"] != (0, 0):
        raise AssertionError(f"train-mode launches {launches}: expected K1 "
                             f"{2 * per} and K2 {per}")
    if not finite or worst[0][1] > GRAD_F32_TOL:
        raise AssertionError("B5 float32 train-mode gradients through the "
                             "kernels disagree with the plain path")
    if bn_err > TRAIN_MODE_BN_TOL or not bn_moved:
        raise AssertionError(f"train-mode BatchNorm statistics: error "
                             f"{bn_err}, moved {bn_moved}")
    if (k1, k2, k1_mma) != (2 * K1_PER_STEP, 2 * K2_PER_STEP,
                            2 * K1_PER_STEP) or \
            step_launches["plain"][:2] != (0, 0):
        raise AssertionError(f"train-mode EMA launches {step_launches}: "
                             f"expected {K1_PER_STEP} tensor-core K1 and "
                             f"{K2_PER_STEP} K2 per step")
    if not all(math.isfinite(v) for r in compare["kernel"] for v in r[:3]) \
            or not all(student_bn_moved.values()):
        raise AssertionError("bad train-mode EMA steps")
    if loss_diff > TRAIN_LOSS_TOL or kept_diff > TRAIN_KEPT_TOL or \
            not pseudo_ok:
        raise AssertionError("kernel and plain train-mode EMA steps "
                             "disagree")
    return row


def phase_augment(smi: str):
    import torch

    from semisupervisedobjectdetection_torch.data.augment import (
        augment_batch,
        draw_choices,
        eval_batch,
    )

    g = torch.Generator().manual_seed(SEED)
    b, crop = TEACHER_BATCH, 500
    imgs = torch.randint(0, 256, (b, IMG, IMG, 3), dtype=torch.uint8,
                         generator=g)
    masks = (torch.rand(b, IMG, IMG, generator=g) > 0.7).to(torch.uint8) \
        * 255
    choices = draw_choices(b, IMG, IMG, crop, 0.75, g)
    gi, gm = imgs.cuda(), masks.cuda()
    cases = {
        "augment": lambda i, m: augment_batch(i, m, crop=crop, out_h=IMG,
                                              out_w=IMG, choices=choices),
        "eval": lambda i, m: eval_batch(i, m, out_h=IMG, out_w=IMG),
        "eval_shrink": lambda i, m: eval_batch(i, m, out_h=IMG // 2,
                                               out_w=IMG // 2),
    }
    rows = {}
    for name, fn in cases.items():
        t0 = time.perf_counter()
        ci, cm = fn(imgs, masks)
        cpu_s = time.perf_counter() - t0
        di, dm = fn(gi, gm)
        rows[name] = {"img_max_abs_err": (di.cpu() - ci).abs().max().item(),
                      "masks_equal": bool(torch.equal(dm.cpu(), cm)),
                      "ms": cuda_ms(lambda: fn(gi, gm), iters=10),
                      "cpu_ms": cpu_s * 1e3,
                      "shape": list(di.shape)}
    row = {"phase": "augment", "batch": b, "canvas": IMG, "crop": crop,
           "out": IMG, "tol": AUGMENT_TOL, "cases": rows,
           "branches": torch.bincount(choices.branch, minlength=4).tolist(),
           "card": smi}
    emit(row)
    bad = [n for n, r in rows.items()
           if r["img_max_abs_err"] > AUGMENT_TOL or not r["masks_equal"]]
    if bad:
        raise AssertionError(f"augmentation on the card differs from the "
                             f"CPU: {bad}")
    return row


def phase_cli(smi: str, bench_step_ms: float, train_mode_step_ms: float):
    import math
    import tempfile

    import torch

    from semisupervisedobjectdetection_torch.checkpoint.io import load_last
    from semisupervisedobjectdetection_torch.cli import teacher_student
    from semisupervisedobjectdetection_torch.core.config import (
        TrainConfig,
        mit_b5,
    )
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
    )
    from semisupervisedobjectdetection_torch.train.state import TrainState

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    old_tmp, tempfile.tempdir = tempfile.tempdir, root  # the tiles too
    ck = os.path.join(root, "ck")
    argv = ["--ema-mode", "--synthetic", "--synthetic-n", str(CLI_TILES),
            "--variant", "b5", "--img-size", str(IMG), "--batch-size",
            str(TEACHER_BATCH), "--grad-accum", str(ACCUM), "--perf",
            "--resume", "--checkpoint-dir", ck, "--seed", str(SEED)]
    try:
        _reset_counts()
        t0 = time.perf_counter()
        first = teacher_student.main(argv + [
            "--epochs", "2", "--metrics-csv", os.path.join(root, "m.csv")])
        run_s = time.perf_counter() - t0
        launches = _counts()
        rows = _csv_rows(os.path.join(root, "m.csv"))
        names = sorted(os.listdir(ck))
        disk = shutil.disk_usage(root)
        # load_last gives back what was saved
        saved = torch.load(os.path.join(ck, "ts_student_last.pt"),
                           map_location="cpu", weights_only=True)
        template = TrainState.create(
            SegFormer(mit_b5(dtype="bfloat16", gelu_approx=True)).cuda(),
            TrainConfig())
        got = load_last(ck, "ts_student", template)
        want = {**{"model." + k: v for k, v in saved["model"].items()},
                **{"mu." + k: v for k, v in saved["mu"].items()},
                **{"nu." + k: v for k, v in saved["nu"].items()},
                "count": saved["count"], "epoch": saved["epoch"]}
        have = {**{"model." + k: v for k, v in
                   template.model.state_dict().items()},
                **{"mu." + k: v for k, v in template.mu.items()},
                **{"nu." + k: v for k, v in template.nu.items()},
                "count": template.count, "epoch": template.epoch}
        round_trip = set(want) == set(have) and all(
            torch.equal(have[k].cpu(), v) for k, v in want.items())
        bn = {n: saved["model"]["decode_head.batch_norm." + n]
              for n in ("running_mean", "running_var")}
        bn_moved = bool(bn["running_mean"].abs().max() > 0) and \
            bool((bn["running_var"] - 1.0).abs().max() > 0)
        next_epoch = got[1]
        del template, saved, want, have, got
        torch.cuda.empty_cache()
        _reset_counts()
        # the resumed epoch stages its batches inline (--prefetch 0): its
        # step time beside the first run's shows what the prefetch thread
        # costs the host-bound step
        second = teacher_student.main(argv + [
            "--epochs", "3", "--prefetch", "0",
            "--metrics-csv", os.path.join(root, "m2.csv")])
        launches_second = _counts()
        rows2 = _csv_rows(os.path.join(root, "m2.csv"))
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(root, ignore_errors=True)
    per_step = [(r["launches_train"][0] / max(r["train_steps"], 1),
                 r["launches_train"][1] / max(r["train_steps"], 1))
                for r in first + second]
    epochs = _epochs(first + second)
    for e, depth in zip(epochs, [1] * len(first) + [0] * len(second)):
        e["prefetch"] = depth
    row = {"phase": "cli", "argv": argv, "run_s": run_s,
           "epochs": epochs, "bench_step_ms": bench_step_ms,
           "train_mode_step_ms": train_mode_step_ms,
           "csv_rows": rows, "csv_rows_resumed": rows2,
           "checkpoints": names, "disk_free_bytes": disk.free,
           "launches_k1_k2_k1mma": launches,
           "launches_resumed_run": launches_second,
           "launches_per_train_step": per_step,
           "launches_expected_per_step": [K1_PER_STEP, K2_PER_STEP],
           "student_bn_moved": bn_moved, "load_last_exact": round_trip,
           "card": smi}
    emit(row)
    if len(rows) != 2 or not all(
            math.isfinite(float(r["train_loss"]))
            and math.isfinite(float(r["eval_loss"]))
            and 0.0 <= float(r["miou"]) <= 1.0 for r in rows):
        raise AssertionError(f"CLI CSV rows {rows}")
    if any(p != (K1_PER_STEP, K2_PER_STEP) for p in per_step) or \
            any(r["launches_eval_k1"] != 2 * sum(B5_DEPTHS)
                for r in first + second) or \
            [r["train_steps"] for r in first + second] != \
            [CLI_STEPS_PER_EPOCH] * 3 or launches[2] != launches[0]:
        raise AssertionError(f"CLI launches per train step {per_step}, "
                             f"eval {[r['launches_eval_k1'] for r in first]}")
    for prefix in ("ts_teacher", "ts_student"):
        if f"{prefix}_last.pt" not in names or not any(
                n.startswith(prefix + "_epoch_") for n in names):
            raise AssertionError(f"missing {prefix} checkpoints: {names}")
    if not bn_moved or not round_trip or next_epoch != 2:
        raise AssertionError(f"BatchNorm moved {bn_moved}, load_last exact "
                             f"{round_trip}, next epoch {next_epoch}")
    if [r["epoch"] for r in second] != [2] or \
            [r["step"] for r in rows2] != ["2"]:
        raise AssertionError("the resumed CLI run did not start at epoch 2")
    return row


def phase_supervised(smi: str):
    import math

    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch import bench
    from semisupervisedobjectdetection_torch.core.config import TrainConfig
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.state import TrainState
    from semisupervisedobjectdetection_torch.train.supervised import (
        train_step,
    )

    dev = torch.device("cuda")
    cfg = bench.flagship_config()
    batch = ACCUM * MICRO
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy(rng.uniform(size=(batch, IMG, IMG, 3))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.uniform(size=(batch, IMG, IMG)) > 0.7)
                         .astype(np.float32)).to(dev)
    runs = {}
    for mode in ("eval_mode", "train_mode"):
        for impl in ("kernel", "plain"):
            model = init_weights(SegFormer(cfg.replace(attn_impl=impl)),
                                 torch.Generator().manual_seed(SEED)).to(dev)
            state = TrainState.create(model, TrainConfig())
            g = torch.Generator(device=dev).manual_seed(SEED)
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_counts()
            losses, ms = [], []
            for _ in range(2):
                t0 = time.perf_counter()
                _, loss, pred = train_step(
                    state, x, y, train_mode=mode == "train_mode",
                    accum=ACCUM, generator=g)
                losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
            runs[(mode, impl)] = {
                "losses": losses, "step_ms": ms,
                "launches_k1_k2_k1mma": _counts(),
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "pred_shape": list(pred.shape),
                "pred_finite": bool(torch.isfinite(pred).all().item())}
            del model, state, pred
            torch.cuda.empty_cache()
    diffs = {mode: max(abs(a - b) for a, b in zip(
        runs[(mode, "kernel")]["losses"], runs[(mode, "plain")]["losses"]))
        for mode in ("eval_mode", "train_mode")}
    row = {"phase": "supervised", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "gelu": "tanh", "micro_batch": MICRO,
           "accum": ACCUM,
           "runs": {f"{m}/{i}": r for (m, i), r in runs.items()},
           "loss_max_abs_diff": diffs, "loss_tol": TRAIN_LOSS_TOL,
           "launches_expected_per_step": [SUP_K1_PER_STEP, SUP_K2_PER_STEP],
           "card": smi}
    emit(row)
    for (mode, impl), r in runs.items():
        want = (2 * SUP_K1_PER_STEP, 2 * SUP_K2_PER_STEP,
                2 * SUP_K1_PER_STEP) if impl == "kernel" else (0, 0, 0)
        if r["launches_k1_k2_k1mma"] != want:
            raise AssertionError(f"supervised {mode} {impl}: launches "
                                 f"{r['launches_k1_k2_k1mma']}, expected "
                                 f"{want} in 2 steps")
        if not all(math.isfinite(v) for v in r["losses"]) or \
                not r["pred_finite"] or r["pred_shape"] != [batch, IMG, IMG]:
            raise AssertionError(f"bad supervised step outputs: {r}")
    if max(diffs.values()) > TRAIN_LOSS_TOL:
        raise AssertionError(f"kernel and plain supervised steps disagree: "
                             f"{diffs}")
    return row


@contextlib.contextmanager
def _record_nk():
    """The Nk of every K1 and K2 call made inside, read in
    `SRAttention`'s forward and backward (the wrappers count the
    launches)."""
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        SRAttention,
    )

    fwd, bwd = SRAttention.forward, SRAttention.backward
    log = {"k1": [], "k2": []}

    def rec_fwd(ctx, q, k, v, num_heads):
        log["k1"].append(k.shape[1])
        ctx.recorded_nk = k.shape[1]
        return fwd(ctx, q, k, v, num_heads)

    def rec_bwd(ctx, g):
        log["k2"].append(ctx.recorded_nk)
        return bwd(ctx, g)

    SRAttention.forward = staticmethod(rec_fwd)
    SRAttention.backward = staticmethod(rec_bwd)
    try:
        yield log
    finally:
        SRAttention.forward = staticmethod(fwd)
        SRAttention.backward = staticmethod(bwd)


def phase_transfer_grad(tokens=TRANSFER_TOKENS, want_nk=TRANSFER_NK,
                        name="transfer_grad"):
    """The float32 transfer gradients through the kernels against the plain
    path with `tokens` prompt tokens per stage, every K1 and K2 launch at
    `want_nk` keys (transfer_grad: 10 tokens, Nk 266; transfer_grad_nk356:
    100 tokens, Nk 356, which the bf16 kernels refuse)."""
    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch import losses
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import (
        TrainConfig,
        mit_b5,
    )
    from semisupervisedobjectdetection_torch.train.common import (
        forward_masks,
        grads_of,
    )

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = mit_b5(dtype="float32")
    tc = TrainConfig(reference_quirks=False)
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy(rng.uniform(size=(2, IMG, IMG, 3))
                         .astype(np.float32)).to(dev)
    gt = torch.from_numpy((rng.uniform(size=(2, IMG, IMG)) > 0.7)
                          .astype(np.float32)).to(dev)
    grads, launches, nks, masks = {}, {}, {}, {}
    for impl in ("kernel", "plain"):
        m = SegFormerModel(config=cfg.replace(attn_impl=impl),
                           train_config=tc, seed=SEED)
        m.frozen_encoder(layers=list(TRANSFER_FROZEN))
        m.add_prompt_token(tokens)
        state = m.state
        _reset_counts()
        with _record_nk() as log:
            pred, _, _ = forward_masks(
                state.model, x, train_mode=True,
                generator=torch.Generator(device=dev).manual_seed(SEED))
            grads[impl] = grads_of(losses.dice_loss(pred, gt),
                                   state.trainable_params)
            torch.cuda.synchronize()
        launches[impl] = _counts()[:2]
        nks[impl] = log
        masks[impl] = {
            "frozen": sorted(n for n, p in state.params.items()
                             if not p.requires_grad),
            "moments": sorted(state.mu),
            "blocks": sorted(n for n in state.params
                             if n.startswith(FROZEN_PREFIXES))}
        del m, state, pred
        torch.cuda.empty_cache()
    scales = {n: g.abs().max().item() for n, g in grads["plain"].items()}
    floor = GRAD_SCALE_FLOOR * max(scales.values())
    rel = {n: (gk - grads["plain"][n]).abs().max().item()
           / max(scales[n], floor) for n, gk in grads["kernel"].items()}
    worst = [(n, r, scales[n]) for n, r in
             sorted(rel.items(), key=lambda kv: -kv[1])[:5]]
    finite = all(bool(torch.isfinite(g).all().item())
                 for g in grads["kernel"].values())
    must_move = [f"segformer.encoder.prompt_tokens.{i}" for i in range(4)] \
        + [f"segformer.encoder.patch_embeddings.{i}.proj.weight"
           for i in TRANSFER_FROZEN]
    moving = {n: float(grads["kernel"][n].abs().max()) if n in grads["kernel"]
              else 0.0 for n in must_move}
    km = masks["kernel"]
    per = sum(B5_DEPTHS)
    row = {"phase": name, "variant": "b5", "img": IMG,
           "dtype": "float32", "batch": 2, "frozen": list(TRANSFER_FROZEN),
           "prompt_tokens": list(tokens), "quirks": False,
           "tensors": len(rel), "max_rel_diff": worst[0][1],
           "worst_name_rel_scale": worst, "tol_rel": GRAD_F32_TOL,
           "scale_floor": floor,
           "frozen_tensors": len(km["frozen"]),
           "frozen_blocks_tensors": len(km["blocks"]),
           "trained_tensors": len(km["moments"]),
           "grad_max_abs_of": moving,
           "launches_k1_k2": launches["kernel"],
           "launches_plain_path": launches["plain"],
           "nk_k1": sorted(set(nks["kernel"]["k1"])),
           "nk_k2": sorted(set(nks["kernel"]["k2"])),
           "nk_calls_k1_k2": [len(nks["kernel"]["k1"]),
                              len(nks["kernel"]["k2"])]}
    emit(row)
    if km["frozen"] != km["blocks"] or set(km["moments"]) & set(km["blocks"]) \
            or set(grads["kernel"]) & set(km["blocks"]) or not km["blocks"]:
        raise AssertionError("the frozen layers have gradients or moments, "
                             "or other tensors are frozen")
    if launches["kernel"] != (2 * per, per) or launches["plain"] != (0, 0):
        raise AssertionError(f"{name} launches {launches}: expected K1 "
                             f"{2 * per} and K2 {per}")
    if row["nk_k1"] != [want_nk] or row["nk_k2"] != [want_nk] or \
            row["nk_calls_k1_k2"] != [2 * per, per] or \
            nks["plain"] != {"k1": [], "k2": []}:
        raise AssertionError(f"Nk of the launches {row['nk_k1']}, "
                             f"{row['nk_k2']}: expected {want_nk}")
    if not all(v > 0 for v in moving.values()):
        raise AssertionError(f"no gradient reaches {moving}")
    if not finite or worst[0][1] > GRAD_F32_TOL:
        raise AssertionError(f"{name}: B5 float32 transfer gradients "
                             "through the kernels disagree with the plain "
                             "path")
    return row


def phase_transfer_step(smi: str):
    import math

    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch import bench
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import TrainConfig

    dev = torch.device("cuda")
    cfg = bench.flagship_config()
    batch = ACCUM * MICRO
    rng = np.random.default_rng(SEED + 4)
    x = torch.from_numpy(rng.uniform(size=(batch, IMG, IMG, 3))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.uniform(size=(batch, IMG, IMG)) > 0.7)
                         .astype(np.float32)).to(dev)
    runs = {}
    for impl in ("kernel", "plain"):
        m = SegFormerModel(config=cfg.replace(attn_impl=impl),
                           train_config=TrainConfig(reference_quirks=False),
                           seed=SEED, grad_accum=ACCUM)
        m.frozen_encoder(layers=list(TRANSFER_FROZEN))
        m.add_prompt_token(TRANSFER_TOKENS)
        m.generator.manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        losses, ms = [], []
        with _record_nk() as log:
            for _ in range(2):
                t0 = time.perf_counter()
                loss, pred = m.train_one_epoch(x, y, lazy=True)
                losses.append(float(loss))
                ms.append((time.perf_counter() - t0) * 1e3)
        runs[impl] = {
            "losses": losses, "step_ms": ms,
            "launches_k1_k2_k1mma": _counts(),
            "nk_k1": sorted(set(log["k1"])), "nk_k2": sorted(set(log["k2"])),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "pred_shape": list(pred.shape),
            "pred_finite": bool(torch.isfinite(pred).all().item())}
        del m, pred
        torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(runs["kernel"]["losses"],
                                          runs["plain"]["losses"]))
    row = {"phase": "transfer_step", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "gelu": "tanh", "micro_batch": MICRO,
           "accum": ACCUM, "frozen": list(TRANSFER_FROZEN),
           "prompt_tokens": list(TRANSFER_TOKENS), "quirks": False,
           "runs": runs, "loss_max_abs_diff": diff,
           "loss_tol": TRAIN_LOSS_TOL,
           "launches_expected_per_step": [SUP_K1_PER_STEP, SUP_K2_PER_STEP],
           "card": smi}
    emit(row)
    k = runs["kernel"]
    want = (2 * SUP_K1_PER_STEP, 2 * SUP_K2_PER_STEP, 2 * SUP_K1_PER_STEP)
    if k["launches_k1_k2_k1mma"] != want or \
            runs["plain"]["launches_k1_k2_k1mma"] != (0, 0, 0):
        raise AssertionError(f"transfer step launches "
                             f"{k['launches_k1_k2_k1mma']}, plain "
                             f"{runs['plain']['launches_k1_k2_k1mma']}: "
                             f"expected {want} in 2 steps and none")
    if k["nk_k1"] != [TRANSFER_NK] or k["nk_k2"] != [TRANSFER_NK]:
        raise AssertionError(f"transfer step Nk {k['nk_k1']}, {k['nk_k2']}: "
                             f"expected {TRANSFER_NK}")
    for r in runs.values():
        if not all(math.isfinite(v) for v in r["losses"]) or \
                not r["pred_finite"] or r["pred_shape"] != [batch, IMG, IMG]:
            raise AssertionError(f"bad transfer step outputs: {r}")
    if diff > TRAIN_LOSS_TOL:
        raise AssertionError(f"kernel and plain transfer steps disagree: "
                             f"{diff}")
    return row


def _cli_point():
    return ["--synthetic", "--synthetic-n", str(CLI_TILES), "--variant",
            "b5", "--img-size", str(IMG), "--batch-size", str(TEACHER_BATCH),
            "--grad-accum", str(ACCUM), "--perf", "--seed", str(SEED)]


def _epochs(reports):
    """The per-epoch numbers of `epoch_report`s, with the step time."""
    out = []
    for r in reports:
        e = {k: r[k] for k in ("epoch", "epoch_s", "train_steps", "train_s",
                               "train_img_per_s", "prefetch_wait_s",
                               "eval_s", "checkpoint_s", "peak_bytes",
                               "launches_train", "launches_eval_k1")}
        steps = max(e["train_steps"], 1)
        e["step_ms"] = e["train_s"] / steps * 1e3
        e["step_ms_excl_wait"] = (e["train_s"] - e["prefetch_wait_s"]) \
            / steps * 1e3
        out.append(e)
    return out


def _check_cli_launches(name, reports):
    per_step = [(r["launches_train"][0] / max(r["train_steps"], 1),
                 r["launches_train"][1] / max(r["train_steps"], 1))
                for r in reports]
    if any(p != (SUP_K1_PER_STEP, SUP_K2_PER_STEP) for p in per_step) or \
            any(r["launches_eval_k1"] != sum(B5_DEPTHS) for r in reports) \
            or any(r["train_steps"] != CLI_STEPS_PER_EPOCH
                   for r in reports):
        raise AssertionError(f"{name}: launches per train step {per_step}, "
                             f"eval {[r['launches_eval_k1'] for r in reports]}"
                             f", steps {[r['train_steps'] for r in reports]}")
    return per_step


def _csv_rows(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def phase_sup_cli(smi: str):
    import math
    import tempfile

    from semisupervisedobjectdetection_torch.cli import supervised

    root = tempfile.mkdtemp(prefix="chip_smoke_sup_")
    old_tmp, tempfile.tempdir = tempfile.tempdir, root  # the tiles too
    ck = os.path.join(root, "ck")
    argv = _cli_point() + ["--resume", "--checkpoint-dir", ck]
    try:
        _reset_counts()
        t0 = time.perf_counter()
        first = supervised.main(argv + [
            "--epochs", "2", "--metrics-csv", os.path.join(root, "m.csv")])
        run_s = time.perf_counter() - t0
        launches = _counts()
        rows = _csv_rows(os.path.join(root, "m.csv"))
        best = first[-1]["best_path"]
        _reset_counts()
        second = supervised.main(argv + [
            "--epochs", "3", "--metrics-csv", os.path.join(root, "m2.csv")])
        launches_second = _counts()
        rows2 = _csv_rows(os.path.join(root, "m2.csv"))
        names = sorted(os.listdir(ck))
        dump = os.path.join(root, "dump")
        _reset_counts()
        t0 = time.perf_counter()
        predicted = supervised.main(_cli_point() + [
            "--predict", "--pretrain-weight", best, "--dump-masks", dump])
        predict_s = time.perf_counter() - t0
        launches_predict = _counts()
        pngs = sorted(os.listdir(dump))
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    finally:
        tempfile.tempdir = old_tmp
    row = {"phase": "sup_cli", "argv": argv, "run_s": run_s,
           "epochs": _epochs(first + second), "csv_rows": rows,
           "csv_rows_resumed": rows2, "checkpoints": names,
           "launches_k1_k2_k1mma": launches,
           "launches_resumed_run": launches_second,
           "predict": predicted, "predict_s": predict_s,
           "launches_predict": launches_predict, "mask_pngs": len(pngs),
           "launches_expected_per_step": [SUP_K1_PER_STEP, SUP_K2_PER_STEP],
           "card": smi, "root": root, "best": best}
    emit({k: v for k, v in row.items() if k not in ("root",)})
    try:
        if len(rows) != 2 or not all(
                math.isfinite(float(r["train_loss"]))
                and math.isfinite(float(r["eval_loss"]))
                and 0.0 <= float(r["miou"]) <= 1.0 for r in rows):
            raise AssertionError(f"supervised CLI CSV rows {rows}")
        row["launches_per_train_step"] = _check_cli_launches(
            "sup_cli", first + second)
        if launches[2] != launches[0]:
            raise AssertionError("a training K1 launch was not tensor-core")
        if "segformer_last.pt" not in names or not best or \
                os.path.basename(best) not in names:
            raise AssertionError(f"missing checkpoints: {names}")
        if [r["epoch"] for r in second] != [2] or \
                [r["step"] for r in rows2] != ["2"]:
            raise AssertionError("the resumed supervised CLI run did not "
                                 "start at epoch 2")
        tiles = CLI_EVAL_BATCH
        if predicted["dumped"] != tiles or len(pngs) != 2 * tiles or \
                launches_predict[:2] != (sum(B5_DEPTHS), 0) or \
                not 0.0 <= predicted["eval_loss"] <= 1.0:
            raise AssertionError(f"--predict: {predicted}, {len(pngs)} "
                                 f"PNGs, launches {launches_predict}")
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    return row


def phase_transfer_cli(smi: str, sup: dict):
    import math
    import tempfile

    import torch

    from semisupervisedobjectdetection_torch.cli import transfer
    from semisupervisedobjectdetection_torch.core.config import mit_b5
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )

    root, best = sup["root"], sup["best"]
    old_tmp, tempfile.tempdir = tempfile.tempdir, root
    ck = os.path.join(root, "ck_transfer")
    point = _cli_point() + ["--frozen", ",".join(
        map(str, TRANSFER_FROZEN)), "--no-quirks"]
    argv = point + ["--prompt-tokens", ",".join(map(str, TRANSFER_TOKENS)),
                    "--pretrain-weight", best, "--resume",
                    "--checkpoint-dir", ck, "--epochs", "2"]
    try:
        _reset_counts()
        t0 = time.perf_counter()
        reports = transfer.main(argv + [
            "--metrics-csv", os.path.join(root, "t.csv")])
        run_s = time.perf_counter() - t0
        launches = _counts()
        rows = _csv_rows(os.path.join(root, "t.csv"))
        warm = torch.load(best, map_location="cpu", weights_only=True)
        after = torch.load(os.path.join(ck, "segformer_last.pt"),
                           map_location="cpu", weights_only=True)
        seeded = init_weights(
            SegFormer(mit_b5(dtype="bfloat16", gelu_approx=True,
                             prompt_tokens=TRANSFER_TOKENS)),
            torch.Generator().manual_seed(SEED)).state_dict()
        frozen = [n for n in warm["model"] if n.startswith(FROZEN_PREFIXES)]
        frozen_equal = bool(frozen) and all(
            torch.equal(after["model"][n], warm["model"][n]) for n in frozen)
        frozen_moments = [n for n in after["mu"]
                          if n.startswith(FROZEN_PREFIXES)]
        prompts = [f"segformer.encoder.prompt_tokens.{i}" for i in range(4)]
        prompt_moves = {n: (after["model"][n] - seeded[n]).abs().max().item()
                        for n in prompts}
        trained_moved = not torch.equal(
            after["model"]["segformer.encoder.block.2.0.mlp.dense1.weight"],
            warm["model"]["segformer.encoder.block.2.0.mlp.dense1.weight"])
        del warm, after, seeded
        # a prefix past the kernels' 288 keys: refused before anything is
        # built on the card
        gc.collect()
        mem0 = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.perf_counter()
        try:
            transfer.main(point + ["--prompt-tokens", ",".join(
                map(str, TRANSFER_REFUSED_TOKENS))])
            refusal = None
        except SystemExit as e:
            refusal = str(e)
        refusal_s = time.perf_counter() - t0
        refusal_mem = torch.cuda.memory_allocated() - mem0
        refusal_launches = _counts()
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "transfer_cli", "argv": argv, "run_s": run_s,
           "epochs": _epochs(reports), "csv_rows": rows,
           "launches_k1_k2_k1mma": launches,
           "frozen_tensors": len(frozen), "frozen_bit_equal": frozen_equal,
           "frozen_with_moments": len(frozen_moments),
           "prompt_max_abs_move": prompt_moves,
           "stage2_moved": trained_moved,
           "refused_tokens": list(TRANSFER_REFUSED_TOKENS),
           "refusal": refusal, "refusal_s": refusal_s,
           "refusal_memory_bytes": refusal_mem,
           "refusal_launches": refusal_launches, "card": smi}
    emit(row)
    if len(rows) != 2 or not all(math.isfinite(float(r["train_loss"]))
                                 and math.isfinite(float(r["eval_loss"]))
                                 for r in rows):
        raise AssertionError(f"transfer CLI CSV rows {rows}")
    row["launches_per_train_step"] = _check_cli_launches("transfer_cli",
                                                         reports)
    if not frozen_equal or frozen_moments or not trained_moved:
        raise AssertionError("the frozen layers moved or have moments, or "
                             "the trained ones did not move")
    if not all(v > 0 for v in prompt_moves.values()):
        raise AssertionError(f"prompt tokens did not train: {prompt_moves}")
    if refusal is None or "288" not in refusal or refusal_mem > 0 or \
            refusal_launches != (0, 0, 0):
        raise AssertionError(f"Nk > 288 not refused before a model: "
                             f"{refusal!r}, {refusal_mem} bytes")
    return row


def _ts_models(cfg, dev):
    """A teacher (lr 5e-7) and a student (lr 3e-5) of one seeded MiT-B5 on
    `dev`, the classifier bias at TS_CLS_BIAS."""
    import copy

    import torch

    from semisupervisedobjectdetection_torch.core.config import TrainConfig
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.state import TrainState

    model = init_weights(SegFormer(cfg), torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        model.decode_head.classifier.bias.fill_(TS_CLS_BIAS)
    teacher = TrainState.create(copy.deepcopy(model).to(dev), TrainConfig(),
                                lr=TEACHER_LR)
    student = TrainState.create(model.to(dev), TrainConfig(), lr=STUDENT_LR)
    return teacher, student


def _ts_snapshot(state):
    return ([p.detach().clone() for p in state.params.values()]
            + [m.clone() for m in state.mu.values()]
            + [v.clone() for v in state.nu.values()]
            + [state.count.clone()])


def phase_ts_step(smi: str):
    """The gradient teacher-student steps at the flagship point (eval-mode
    forwards, the --no-quirks path whose phase A updates the teacher):
    pseudo_label_step with the gate on and then off, two
    pseudo_label_infer_steps and two labeled_steps, through the kernels and
    through the plain path, from one seeded teacher/student pair each."""
    import math

    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch import bench
    from semisupervisedobjectdetection_torch.train import teacher_student \
        as ts

    dev = torch.device("cuda")
    cfg = bench.flagship_config()
    batch = ACCUM * MICRO
    rng = np.random.default_rng(SEED + 5)
    u = torch.from_numpy(rng.uniform(size=(batch, IMG, IMG, 3))
                         .astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.uniform(size=(batch, IMG, IMG, 3))
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.uniform(size=(batch, IMG, IMG)) > 0.7)
                         .astype(np.float32)).to(dev)
    on = torch.ones((), dtype=torch.bool, device=dev)
    off = torch.zeros((), dtype=torch.bool, device=dev)
    runs = {}
    real_grads_of = ts.grads_of
    for impl in ("kernel", "plain"):
        teacher, student = _ts_models(cfg.replace(attn_impl=impl), dev)
        first_teacher_param = next(iter(teacher.params.values()))
        calls, by_model = [], {"teacher": [0, 0], "student": [0, 0]}

        def spy(loss, params):
            # the K1 (recompute) and K2 launches of each model's backward
            k0 = _counts()
            grads = real_grads_of(loss, params)
            who = "teacher" if next(iter(params.values())) is \
                first_teacher_param else "student"
            for i in range(2):
                by_model[who][i] += _counts()[i] - k0[i]
            return grads

        def timed(name, fn):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            _reset_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            k1, k2, k1_mma = _counts()
            pseudo = name.startswith("pseudo")
            losses = [float(v) for v in (out[1:2] if pseudo else out[2:])]
            calls.append({"call": name, "ms": ms,
                          "launches_k1_k2_k1mma": [k1, k2, k1_mma],
                          "peak_bytes": torch.cuda.max_memory_allocated(dev),
                          "losses": losses,
                          "n_kept": float(out.n_kept) if pseudo else None,
                          "teacher_count": int(teacher.count),
                          "student_count": int(student.count)})
            return out

        timed("pseudo_label_step(enable=True)", lambda: ts.pseudo_label_step(
            teacher, u, on, accum=ACCUM))
        before = _ts_snapshot(teacher)
        timed("pseudo_label_step(enable=False)",
              lambda: ts.pseudo_label_step(teacher, u, off, accum=ACCUM))
        gate_equal = all(torch.equal(a, b) for a, b in
                         zip(before, _ts_snapshot(teacher)))
        del before
        for _ in range(2):
            timed("pseudo_label_infer_step",
                  lambda: ts.pseudo_label_infer_step(teacher, u))
        ts.grads_of = spy
        try:
            for _ in range(2):
                timed("labeled_step", lambda: ts.labeled_step(
                    teacher, student, x, y, 0.8, accum=ACCUM))
        finally:
            ts.grads_of = real_grads_of
        runs[impl] = {"calls": calls, "gate_off_bit_equal": gate_equal,
                      "labeled_backward_launches_by_model": by_model}
        del teacher, student
        torch.cuda.empty_cache()

    pairs = list(zip(runs["kernel"]["calls"], runs["plain"]["calls"]))
    kept_diff = max(abs(a["n_kept"] - b["n_kept"]) for a, b in pairs
                    if a["n_kept"] is not None)
    # a pseudo loss is compared where both paths kept the same samples
    loss_diff = max(abs(p - q) for a, b in pairs
                    if a["n_kept"] == b["n_kept"]
                    for p, q in zip(a["losses"], b["losses"]))
    k = runs["kernel"]
    row = {"phase": "ts_step", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "gelu": "tanh", "micro_batch": MICRO,
           "accum": ACCUM, "train_mode": False,
           "lr_teacher_student": [TEACHER_LR, STUDENT_LR],
           "classifier_bias": TS_CLS_BIAS, "runs": runs,
           "loss_max_abs_diff": loss_diff, "loss_tol": TRAIN_LOSS_TOL,
           "kept_max_diff": kept_diff, "kept_tol": TRAIN_KEPT_TOL,
           "launches_expected": {"pseudo_label_step": list(PSEUDO_K),
                                 "pseudo_label_infer_step": list(INFER_K),
                                 "labeled_step": list(LABELED_K)},
           "card": smi}
    emit(row)
    want = {"pseudo_label_step(enable=True)": PSEUDO_K,
            "pseudo_label_step(enable=False)": PSEUDO_K,
            "pseudo_label_infer_step": INFER_K, "labeled_step": LABELED_K}
    for c in k["calls"]:
        k1, k2, k1_mma = c["launches_k1_k2_k1mma"]
        if (k1, k2) != want[c["call"]] or k1_mma != k1:
            raise AssertionError(f"ts_step {c['call']}: launches "
                                 f"{c['launches_k1_k2_k1mma']}, expected "
                                 f"{want[c['call']]} (tensor-core K1)")
    if any(c["launches_k1_k2_k1mma"] != [0, 0, 0]
           for c in runs["plain"]["calls"]):
        raise AssertionError("the plain ts path launched a kernel")
    by_model = k["labeled_backward_launches_by_model"]
    if [by_model[m][1] for m in ("teacher", "student")] != \
            [2 * PSEUDO_K[1]] * 2:             # over the two labeled_steps
        raise AssertionError(f"labeled_step K2 by model {by_model}: "
                             f"expected {PSEUDO_K[1]} each per step")
    for r in runs.values():
        counts = [(c["teacher_count"], c["student_count"])
                  for c in r["calls"]]
        if not r["gate_off_bit_equal"] or counts != [
                (1, 0), (1, 0), (1, 0), (1, 0), (2, 1), (3, 2)]:
            raise AssertionError(f"ts_step gate: bit-equal "
                                 f"{r['gate_off_bit_equal']}, Adam counts "
                                 f"{counts}")
        if not all(math.isfinite(v) for c in r["calls"]
                   for v in c["losses"]):
            raise AssertionError(f"ts_step losses not finite: {r['calls']}")
    if loss_diff > TRAIN_LOSS_TOL or kept_diff > TRAIN_KEPT_TOL:
        raise AssertionError(f"kernel and plain ts steps disagree: losses "
                             f"{loss_diff}, kept counts {kept_diff}")
    row["ms_per_call_kernel"] = {c["call"]: c["ms"] for c in k["calls"]}
    return row


def _state_tensors(state):
    return {**{"model." + n: t for n, t in
               state.model.state_dict().items()},
            **{"mu." + n: t for n, t in state.mu.items()},
            **{"nu." + n: t for n, t in state.nu.items()},
            "count": state.count, "epoch": state.epoch}


def phase_ts_cli(smi: str):
    """`cli/teacher_student.py::main` without --ema-mode at the flagship
    point: 2 epochs --no-quirks --resume warm-started from seeded weights
    with the classifier bias at TS_CLS_BIAS (epoch 0 updates the teacher in
    phase A, epoch 1 does not), then 1 epoch in the default quirks mode
    (train mode, phase A never updates) in a fresh directory."""
    import math
    import tempfile

    import torch

    from semisupervisedobjectdetection_torch.checkpoint.io import load_last
    from semisupervisedobjectdetection_torch.cli import teacher_student
    from semisupervisedobjectdetection_torch.core.config import (
        TrainConfig,
        mit_b5,
    )
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.state import TrainState

    root = tempfile.mkdtemp(prefix="chip_smoke_ts_")
    old_tmp, tempfile.tempdir = tempfile.tempdir, root  # the tiles too
    cfg = mit_b5(dtype="bfloat16", gelu_approx=True)
    ck, ck_q = os.path.join(root, "ck"), os.path.join(root, "ck_quirks")
    warm = os.path.join(root, "warm.pt")
    argv = _cli_point() + ["--no-quirks", "--resume", "--pretrain-weight",
                           warm, "--checkpoint-dir", ck, "--epochs", "2"]
    try:
        model = init_weights(SegFormer(cfg),
                             torch.Generator().manual_seed(SEED))
        with torch.no_grad():
            model.decode_head.classifier.bias.fill_(TS_CLS_BIAS)
        torch.save({"model": model.state_dict()}, warm)
        del model
        _reset_counts()
        t0 = time.perf_counter()
        first = teacher_student.main(argv + [
            "--metrics-csv", os.path.join(root, "m.csv")])
        run_s = time.perf_counter() - t0
        launches = _counts()
        rows = _csv_rows(os.path.join(root, "m.csv"))
        names = sorted(os.listdir(ck))
        exact = {}
        for prefix in ("ts_teacher", "ts_student"):
            saved = torch.load(os.path.join(ck, prefix + "_last.pt"),
                               map_location="cpu", weights_only=True)
            template = TrainState.create(SegFormer(cfg).cuda(),
                                         TrainConfig())
            got = load_last(ck, prefix, template)
            want = {**{"model." + n: t for n, t in saved["model"].items()},
                    **{"mu." + n: t for n, t in saved["mu"].items()},
                    **{"nu." + n: t for n, t in saved["nu"].items()},
                    "count": saved["count"], "epoch": saved["epoch"]}
            have = _state_tensors(template)
            exact[prefix] = {
                "exact": set(want) == set(have) and all(
                    torch.equal(have[n].cpu(), t) for n, t in want.items()),
                "next_epoch": got[1], "count": int(saved["count"])}
            del saved, template, got, want, have
            torch.cuda.empty_cache()
        _reset_counts()
        t0 = time.perf_counter()
        quirks = teacher_student.main(_cli_point() + [
            "--checkpoint-dir", ck_q, "--epochs", "1",
            "--metrics-csv", os.path.join(root, "q.csv")])
        quirks_s = time.perf_counter() - t0
        launches_quirks = _counts()
        rows_q = _csv_rows(os.path.join(root, "q.csv"))
        best_q = [n for n in os.listdir(ck_q)
                  if n.startswith("ts_student_epoch_")]
        bn_moved = False
        if best_q:
            sd = torch.load(os.path.join(ck_q, best_q[0]),
                            map_location="cpu", weights_only=True)["model"]
            bn_moved = bool(sd["decode_head.batch_norm.running_mean"]
                            .abs().max() > 0)
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(root, ignore_errors=True)
    reports = first + quirks
    phases = [{"epoch": r["epoch"], "quirks": i == 2,
               "phase_a": r["phase_a"], "phase_b": r["phase_b"],
               "eval_k1": r["launches_eval_k1"]}
              for i, r in enumerate(reports)]
    row = {"phase": "ts_cli", "argv": argv, "run_s": run_s,
           "quirks_run_s": quirks_s, "epochs": _epochs(reports),
           "phases": phases, "csv_rows": rows, "csv_rows_quirks": rows_q,
           "checkpoints": names, "launches_k1_k2_k1mma": launches,
           "launches_quirks_run": launches_quirks, "load_last": exact,
           "quirks_student_bn_moved": bn_moved, "card": smi}
    emit(row)
    steps = CLI_STEPS_PER_EPOCH
    want = [  # (update, phase A launches, teacher count after A)
        (True, [steps * PSEUDO_K[0], steps * PSEUDO_K[1]], steps),
        (False, [steps * INFER_K[0], 0], 2 * steps),
        (False, [steps * INFER_K[0], 0], 0)]
    got = [(p["phase_a"]["update"], p["phase_a"]["launches"],
            p["phase_a"]["teacher_adam_count"]) for p in phases]
    if got != want or any(
            p["phase_b"]["launches"] != [steps * LABELED_K[0],
                                         steps * LABELED_K[1]]
            or p["phase_b"]["steps"] != steps
            or p["eval_k1"] != 2 * sum(B5_DEPTHS) for p in phases):
        raise AssertionError(f"ts_cli phases {phases}: expected phase A "
                             f"{want}")
    if launches[2] != launches[0] or launches_quirks[2] != \
            launches_quirks[0]:
        raise AssertionError("a ts_cli K1 launch was not tensor-core")
    if len(rows) != 2 or len(rows_q) != 1 or not all(
            math.isfinite(float(r["train_loss"]))
            and math.isfinite(float(r["eval_loss"]))
            and math.isfinite(float(r["teacher_train"]))
            for r in rows + rows_q):
        raise AssertionError(f"ts_cli CSV rows {rows}, {rows_q}")
    if any(not e["exact"] or e["next_epoch"] != 2
           for e in exact.values()) or \
            exact["ts_teacher"]["count"] != 3 * steps or not bn_moved:
        raise AssertionError(f"ts_cli load_last {exact}, quirks BatchNorm "
                             f"moved {bn_moved}")
    return row


def phase_ae_step(smi: str):
    """Two autoencoder steps (`train/autoencoder.py::ae_train_step`,
    num_labels 3, train mode: drop-path 0.1, classifier dropout 0.1) at the
    flagship point through the kernels and through the plain path from one
    seeded state and generator seed each, then `ae_eval_step`."""
    import math

    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch import bench
    from semisupervisedobjectdetection_torch.core.config import TrainConfig
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train.autoencoder import (
        ae_eval_step,
        ae_train_step,
    )
    from semisupervisedobjectdetection_torch.train.state import TrainState

    dev = torch.device("cuda")
    cfg = bench.flagship_config().replace(num_labels=AE_LABELS)
    batch = ACCUM * MICRO
    x = torch.from_numpy(np.random.default_rng(SEED + 6).uniform(
        size=(batch, IMG, IMG, 3)).astype(np.float32)).to(dev)
    # the reference's MSE sums each sample's squared errors and divides by
    # B*3: times B*3 / (H*W*3) it is the mean squared error per element, a
    # mean over 32 x 512 x 512 x 3 values in [0, 1] like the dice losses
    # TRAIN_LOSS_TOL holds
    per_element = batch / (IMG * IMG)
    runs = {}
    for impl in ("kernel", "plain"):
        model = init_weights(SegFormer(cfg.replace(attn_impl=impl)),
                             torch.Generator().manual_seed(SEED)).to(dev)
        state = TrainState.create(model, TrainConfig())
        g = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        losses, ms = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            _, loss, recon = ae_train_step(state, x, g, accum=ACCUM)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        train_launches = _counts()
        peak = torch.cuda.max_memory_allocated(dev)
        _reset_counts()
        t0 = time.perf_counter()
        ev_loss, ev_recon = ae_eval_step(state, x)
        ev_loss = float(ev_loss)
        eval_ms = (time.perf_counter() - t0) * 1e3
        runs[impl] = {
            "losses": losses, "step_ms": ms,
            "launches_k1_k2_k1mma": train_launches, "peak_bytes": peak,
            "eval_loss": ev_loss, "eval_ms": eval_ms,
            "eval_launches_k1_k2_k1mma": _counts(),
            "recon_shape": list(recon.shape),
            "recon_finite": bool(torch.isfinite(recon).all().item()
                                 and torch.isfinite(ev_recon).all().item()),
            "count": int(state.count)}
        del model, state, recon, ev_recon
        torch.cuda.empty_cache()
    k, p = runs["kernel"], runs["plain"]
    diff = max(abs(a - b) for a, b in zip(k["losses"] + [k["eval_loss"]],
                                          p["losses"] + [p["eval_loss"]]))
    row = {"phase": "ae_step", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "gelu": "tanh", "num_labels": AE_LABELS,
           "micro_batch": MICRO, "accum": ACCUM, "train_mode": True,
           "runs": runs, "loss_max_abs_diff": diff,
           "loss_max_abs_diff_per_element": diff * per_element,
           "loss_tol_per_element": TRAIN_LOSS_TOL,
           "launches_expected_per_step": [SUP_K1_PER_STEP, SUP_K2_PER_STEP],
           "card": smi}
    emit(row)
    want = (2 * SUP_K1_PER_STEP, 2 * SUP_K2_PER_STEP, 2 * SUP_K1_PER_STEP)
    if k["launches_k1_k2_k1mma"] != want or \
            k["eval_launches_k1_k2_k1mma"] != (sum(B5_DEPTHS), 0,
                                               sum(B5_DEPTHS)) or \
            p["launches_k1_k2_k1mma"] != (0, 0, 0) or \
            p["eval_launches_k1_k2_k1mma"] != (0, 0, 0):
        raise AssertionError(f"ae_step launches {k['launches_k1_k2_k1mma']}"
                             f", eval {k['eval_launches_k1_k2_k1mma']}: "
                             f"expected {want} in 2 steps, "
                             f"{sum(B5_DEPTHS)} in the eval, none plain")
    for r in runs.values():
        if not all(math.isfinite(v) for v in r["losses"]) or \
                not r["recon_finite"] or r["count"] != 2 or \
                r["recon_shape"] != [batch, IMG, IMG, AE_LABELS]:
            raise AssertionError(f"bad ae_step outputs: {r}")
    if diff * per_element > TRAIN_LOSS_TOL:
        raise AssertionError(f"kernel and plain autoencoder steps disagree:"
                             f" {diff} ({diff * per_element} per element)")
    return row


def phase_ae_cli(smi: str):
    """`cli/autoencoder.py::main` at the flagship point, 2 epochs with
    --resume, then `cli/transfer.py::main` warm-started from its best
    checkpoint for 1 epoch (frozen stages 0-1, 10 prompt tokens, quirks
    off): at the transfer model's first use its encoder and decoder equal
    the checkpoint's and its 1-label classifier is the checkpoint's channel
    0."""
    import math
    import tempfile

    import torch

    from semisupervisedobjectdetection_torch.cli import (
        autoencoder,
        transfer,
    )

    root = tempfile.mkdtemp(prefix="chip_smoke_ae_")
    old_tmp, tempfile.tempdir = tempfile.tempdir, root  # the tiles too
    ck = os.path.join(root, "ae")
    argv = _cli_point() + ["--resume", "--checkpoint-dir", ck, "--epochs",
                           "2"]
    real_loop = transfer.train_loop
    at_load = {}
    try:
        _reset_counts()
        t0 = time.perf_counter()
        reports = autoencoder.main(argv + [
            "--metrics-csv", os.path.join(root, "ae.csv")])
        run_s = time.perf_counter() - t0
        launches = _counts()
        rows = _csv_rows(os.path.join(root, "ae.csv"))
        best = reports[-1]["best_path"]
        names = sorted(os.listdir(ck))
        saved = torch.load(best, map_location="cpu",
                           weights_only=True)["model"]

        def check_then_train(model, *args, **kw):
            have = model.state.model.state_dict()
            cls = ("decode_head.classifier.weight",
                   "decode_head.classifier.bias")
            carried = [n for n in saved if n not in cls]
            at_load.update(
                carried=len(carried),
                missing=[n for n in carried if n not in have],
                carried_equal=all(torch.equal(have[n].cpu(), saved[n])
                                  for n in carried if n in have),
                classifier_channel0=all(
                    torch.equal(have[n].cpu(), saved[n][:1]) for n in cls),
                saved_classifier_rows=int(saved[cls[0]].shape[0]))
            return real_loop(model, *args, **kw)

        transfer.train_loop = check_then_train
        t_argv = _cli_point() + [
            "--frozen", ",".join(map(str, TRANSFER_FROZEN)), "--no-quirks",
            "--prompt-tokens", ",".join(map(str, TRANSFER_TOKENS)),
            "--pretrain-weight", best, "--checkpoint-dir",
            os.path.join(root, "tr"), "--epochs", "1"]
        _reset_counts()
        t0 = time.perf_counter()
        t_reports = transfer.main(t_argv)
        transfer_s = time.perf_counter() - t0
        launches_transfer = _counts()
        del saved
    finally:
        transfer.train_loop = real_loop
        tempfile.tempdir = old_tmp
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "ae_cli", "argv": argv, "run_s": run_s,
           "epochs": _epochs(reports), "csv_rows": rows,
           "checkpoints": names, "launches_k1_k2_k1mma": launches,
           "transfer_argv": t_argv, "transfer_s": transfer_s,
           "transfer_epochs": _epochs(t_reports),
           "launches_transfer": launches_transfer,
           "transfer_at_load": at_load, "card": smi}
    emit(row)
    steps = 2 * CLI_STEPS_PER_EPOCH        # labeled, then unlabeled tiles
    per_step = [(r["launches_train"][0] / max(r["train_steps"], 1),
                 r["launches_train"][1] / max(r["train_steps"], 1))
                for r in reports]
    if any(pp != (SUP_K1_PER_STEP, SUP_K2_PER_STEP) for pp in per_step) or \
            any(r["train_steps"] != steps or
                r["launches_eval_k1"] != sum(B5_DEPTHS) for r in reports) \
            or launches[2] != launches[0]:
        raise AssertionError(f"ae_cli launches per step {per_step}, steps "
                             f"{[r['train_steps'] for r in reports]}")
    if len(rows) != 2 or not all(math.isfinite(float(r["train_loss"]))
                                 and math.isfinite(float(r["eval_loss"]))
                                 for r in rows):
        raise AssertionError(f"ae_cli CSV rows {rows}")
    if "segformer_autoencoder_last.pt" not in names or not best or \
            os.path.basename(best) not in names:
        raise AssertionError(f"ae_cli checkpoints {names}")
    row["transfer_launches_per_step"] = _check_cli_launches(
        "ae_cli transfer", t_reports)
    if at_load.get("missing") or not at_load.get("carried_equal") or \
            not at_load.get("classifier_channel0") or \
            at_load.get("saved_classifier_rows") != AE_LABELS:
        raise AssertionError(f"transfer warm start from the autoencoder: "
                             f"{at_load}")
    return row


def phase_serve_ckpt(smi: str, sup: dict):
    """`cli/serve.py::main --pretrain-weight` on sup_cli's best checkpoint:
    the served weights are the checkpoint's, and each served mask equals
    `SegFormerModel.load(...).predict` of the batch the server ran (the
    tile, then zeros up to max_batch)."""
    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.cli import serve
    from semisupervisedobjectdetection_torch.core.config import mit_b5

    best = sup["best"]
    n = 4
    tiles = np.random.default_rng(SEED + 10).integers(
        0, 256, (n, IMG, IMG, 3), dtype=np.uint8)
    got = {}

    def serve_then_stop(srv):
        base = f"http://127.0.0.1:{srv._httpd.server_address[1]}"
        try:
            _reset_counts()
            t0 = time.perf_counter()
            got["masks"] = [np.load(io.BytesIO(_post(
                base + "/predict?format=npy", t.tobytes(), raw=True)[2]))
                for t in tiles]
            got["wall_s"] = time.perf_counter() - t0
            got["launches"] = _counts()
            saved = torch.load(best, map_location="cpu",
                               weights_only=True)["model"]
            have = srv.model._net.state_dict()
            got["weights_equal"] = set(saved) == set(have) and all(
                torch.equal(have[k].cpu(), saved[k]) for k in saved)
            del saved
        finally:
            srv.stop()

    real = serve._serve_until_signal
    serve._serve_until_signal = serve_then_stop
    try:
        t0 = time.perf_counter()
        serve.main(["--variant", "b5", "--img-size", str(IMG), "--perf",
                    "--max-batch", str(BATCH), "--port", "0",
                    "--pretrain-weight", best])
        run_s = time.perf_counter() - t0
    finally:
        serve._serve_until_signal = real
    ref = SegFormerModel(config=mit_b5(dtype="bfloat16", gelu_approx=True),
                         seed=SEED)
    ref.load(best)
    want = []
    for t in tiles:
        padded = np.zeros((BATCH, IMG, IMG, 3), np.float32)
        padded[0] = t.astype(np.float32) / 255.0
        want.append(ref.predict(padded)[0])
    seeded = SegFormerModel(config=mit_b5(dtype="bfloat16",
                                          gelu_approx=True), seed=SEED)
    seeded_mask = seeded.predict(padded)[0]
    del ref, seeded
    torch.cuda.empty_cache()
    err = max(float(np.abs(a - b).max()) for a, b in zip(got["masks"], want))
    row = {"phase": "serve_ckpt", "checkpoint": os.path.basename(best),
           "requests": n, "run_s": run_s, "serve_wall_s": got["wall_s"],
           "launches_k1_k2_k1mma": got["launches"],
           "launches_expected": [sum(B5_DEPTHS) * n, 0,
                                 sum(B5_DEPTHS) * n],
           "weights_equal_checkpoint": got["weights_equal"],
           "max_abs_err_vs_load_predict": err,
           "max_abs_diff_vs_seeded_weights": float(
               np.abs(got["masks"][-1] - seeded_mask).max()),
           "card": smi}
    emit(row)
    if not got["weights_equal"]:
        raise AssertionError("the server's weights are not the checkpoint's")
    if err != 0.0 or any(m.shape != (IMG, IMG) for m in got["masks"]):
        raise AssertionError(f"served masks differ from SegFormerModel.load"
                             f"(...).predict by {err}")
    if got["launches"] != (sum(B5_DEPTHS) * n, 0, sum(B5_DEPTHS) * n):
        raise AssertionError(f"serve_ckpt launches {got['launches']}")
    return row


def _fewshot_inputs(dev, seed):
    """Four batches of FEW_BATCH images in [0, 1] and two of masks, on
    `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    imgs = [torch.from_numpy(rng.uniform(size=(FEW_BATCH, IMG, IMG, 3))
                             .astype(np.float32)).to(dev) for _ in range(4)]
    masks = [torch.from_numpy((rng.uniform(size=(FEW_BATCH, IMG, IMG))
                               > 0.6).astype(np.float32)).to(dev)
             for _ in range(2)]
    return imgs, masks


def phase_fewshot_grad():
    """B5 float32 with a CLS token per stage, batch 2: the gradients of the
    autoencoder's pair loss and of the seg pair loss (cls_loss_weight 1.0),
    through the float32 kernels and through the plain path."""
    import numpy as np
    import torch

    from semisupervisedobjectdetection_torch.core.config import mit_b5
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train import fewshot as fw
    from semisupervisedobjectdetection_torch.train.common import grads_of

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = mit_b5(dtype="float32", cls_tokens=FEW_CLS)
    (x1, x2, _, _), (m1, m2) = _fewshot_inputs(dev, SEED + 8)
    cls_names = [f"segformer.encoder.cls_token.{i}" for i in range(4)]
    rows = []
    for name, labels in (("ae_pair", AE_LABELS), ("seg_pair_cls1", 1)):
        grads, launches, loss_values = {}, {}, {}
        for impl in ("kernel", "plain"):
            model = init_weights(
                SegFormer(cfg.replace(num_labels=labels, attn_impl=impl)),
                torch.Generator().manual_seed(SEED)).to(dev)
            _reset_counts()
            if name == "ae_pair":
                loss = fw.pair_ae_loss(model, x1, x2)[0]
            else:
                loss = fw.pair_seg_loss(model, x1, m1, x2, m2, 1.0)[0]
            grads[impl] = grads_of(loss, dict(model.named_parameters()))
            loss_values[impl] = float(loss)
            torch.cuda.synchronize()
            launches[impl] = _counts()
            del model, loss
        scales = {n: g.abs().max().item() for n, g in grads["plain"].items()}
        floor = GRAD_SCALE_FLOOR * max(scales.values())
        rel = {n: (gk - grads["plain"][n]).abs().max().item()
               / max(scales[n], floor) for n, gk in grads["kernel"].items()}
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
        cls_grad = {n: grads["kernel"][n].abs().max().item()
                    for n in cls_names}
        finite = all(bool(torch.isfinite(g).all().item())
                     for g in grads["kernel"].values())
        row = {"phase": "fewshot_grad", "loss": name, "variant": "b5",
               "img": IMG, "dtype": "float32", "batch": FEW_BATCH,
               "cls_tokens": list(FEW_CLS), "num_labels": labels,
               "loss_kernel_plain": loss_values, "tensors": len(rel),
               "max_rel_diff": worst[0][1],
               "worst_name_rel": [(n, r, scales[n]) for n, r in worst],
               "cls_rel_diff": {n: rel[n] for n in cls_names},
               "cls_grad_max_abs": cls_grad, "tol_rel": GRAD_F32_TOL,
               "scale_floor": floor,
               "median_rel_diff": float(np.median(list(rel.values()))),
               "launches_k1_k2_k1mma": launches["kernel"],
               "launches_plain_path": launches["plain"]}
        emit(row)
        rows.append(row)
        del grads
        torch.cuda.empty_cache()
        want = FEWSHOT_SEG_K + (0,)     # float32: no bf16 K1 launch
        if launches["kernel"] != want or launches["plain"] != (0, 0, 0):
            raise AssertionError(f"fewshot_grad {name} launches {launches}:"
                                 f" expected {want}, none plain")
        if not finite or worst[0][1] > GRAD_F32_TOL:
            raise AssertionError(f"fewshot_grad {name}: gradients through "
                                 f"the kernels disagree with the plain path")
        if not all(v > 0.0 for v in cls_grad.values()):
            raise AssertionError(f"fewshot_grad {name}: a CLS token has no "
                                 f"gradient: {cls_grad}")
    return rows


def phase_fewshot_step(smi: str):
    """Two `fewshot_ae_step`s and two `fewshot_seg_step`s (cls_loss_weight
    0, then 1.0) at the flagship point with CLS tokens, through the
    kernels and through the plain path, each from one seeded state."""
    import math

    import torch

    from semisupervisedobjectdetection_torch import bench
    from semisupervisedobjectdetection_torch.core.config import TrainConfig
    from semisupervisedobjectdetection_torch.models.segformer import (
        SegFormer,
        init_weights,
    )
    from semisupervisedobjectdetection_torch.train import fewshot as fw
    from semisupervisedobjectdetection_torch.train.state import TrainState

    dev = torch.device("cuda")
    cfg = bench.flagship_config().replace(cls_tokens=FEW_CLS)
    imgs, masks = _fewshot_inputs(dev, SEED + 9)
    cls_names = [f"segformer.encoder.cls_token.{i}" for i in range(4)]
    # the reference's MSE over B*3: times B*3 / (H*W*3), the squared error
    # per element
    per_element = FEW_BATCH / (IMG * IMG)
    runs = {}
    for impl in ("kernel", "plain"):
        for mode, labels in (("ae", AE_LABELS), ("seg", 1)):
            model = init_weights(
                SegFormer(cfg.replace(num_labels=labels, attn_impl=impl)),
                torch.Generator().manual_seed(SEED)).to(dev)
            state = TrainState.create(model, TrainConfig())
            start = {n: state.params[n].detach().clone() for n in cls_names}
            torch.cuda.reset_peak_memory_stats(dev)
            calls = []
            for i in range(2):
                _reset_counts()
                t0 = time.perf_counter()
                if mode == "ae":
                    out = fw.fewshot_ae_step(state, *imgs)
                    recons = out.recon_losses.tolist()
                    loss = float(out.loss)
                    call = {"loss": loss,
                            "recon_per_element": [r * per_element
                                                  for r in recons],
                            "inter": out.inter_losses.tolist(),
                            # 100 x (mean inter + mean intra)
                            "cls_part": (loss - sum(recons) / 4) / 100.0}
                else:
                    w = float(i)          # 0, then 1.0
                    out = fw.fewshot_seg_step(state, imgs[0], masks[0],
                                              imgs[1], masks[1], w)
                    call = {"cls_loss_weight": w, "loss": float(out.loss),
                            "loss_1": float(out.loss_1),
                            "loss_2": float(out.loss_2),
                            "pred_1_finite": bool(torch.isfinite(
                                out.pred_1).all().item())}
                call["ms"] = (time.perf_counter() - t0) * 1e3
                call["launches_k1_k2_k1mma"] = _counts()
                calls.append(call)
            runs[f"{mode}/{impl}"] = {
                "calls": calls,
                "peak_bytes": torch.cuda.max_memory_allocated(dev),
                "count": int(state.count),
                "cls_moved": all(not torch.equal(state.params[n], start[n])
                                 for n in cls_names)}
            del model, state, out
            torch.cuda.empty_cache()

    def diffs(mode, keys):
        k, p = runs[f"{mode}/kernel"], runs[f"{mode}/plain"]
        out = 0.0
        for ck, cp in zip(k["calls"], p["calls"]):
            for key in keys:
                a, b = ck[key], cp[key]
                a, b = (a, b) if isinstance(a, list) else ([a], [b])
                out = max(out, max(abs(x - y) for x, y in zip(a, b)))
        return out

    ae_diff = diffs("ae", ("recon_per_element", "inter", "cls_part"))
    seg_diff = diffs("seg", ("loss", "loss_1", "loss_2"))
    row = {"phase": "fewshot_step", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "gelu": "tanh", "batch": FEW_BATCH,
           "cls_tokens": list(FEW_CLS), "runs": runs,
           "ae_max_abs_diff": ae_diff, "seg_max_abs_diff": seg_diff,
           "loss_tol": TRAIN_LOSS_TOL,
           "launches_expected_ae_seg": [list(FEWSHOT_AE_K),
                                        list(FEWSHOT_SEG_K)],
           "card": smi}
    emit(row)
    for mode, want in (("ae", FEWSHOT_AE_K), ("seg", FEWSHOT_SEG_K)):
        for impl in ("kernel", "plain"):
            r = runs[f"{mode}/{impl}"]
            expect = want + (want[0],) if impl == "kernel" else (0, 0, 0)
            got = [c["launches_k1_k2_k1mma"] for c in r["calls"]]
            if any(g != expect for g in got):
                raise AssertionError(f"fewshot_step {mode}/{impl} launches "
                                     f"{got}: expected {expect} per step")
            if r["count"] != 2 or not r["cls_moved"] or not all(
                    math.isfinite(c["loss"]) for c in r["calls"]) or (
                    mode == "seg" and not all(c["pred_1_finite"]
                                              for c in r["calls"])):
                raise AssertionError(f"bad fewshot_step {mode}/{impl}: {r}")
    if ae_diff > TRAIN_LOSS_TOL or seg_diff > TRAIN_LOSS_TOL:
        raise AssertionError(f"kernel and plain few-shot steps disagree: ae "
                             f"{ae_diff}, seg {seg_diff}")
    return row


def phase_fewshot_cli(smi: str):
    """`cli/fewshot.py::main` at MiT-B5 512x512 bf16 (--perf) on synthetic
    domains, 4 iterations an epoch: `--mode ae` 2 epochs with --resume and
    a resumed third; `--mode seg` 1 epoch, then `--predict` from its best
    checkpoint."""
    import math
    import tempfile

    from semisupervisedobjectdetection_torch.cli import fewshot

    root = tempfile.mkdtemp(prefix="chip_smoke_fewshot_")
    old_tmp, tempfile.tempdir = tempfile.tempdir, root  # the tiles too
    point = ["--synthetic", "--synthetic-n", str(FEWSHOT_CLI_TILES),
             "--variant", "b5", "--img-size", str(IMG), "--perf", "--seed",
             str(SEED), "--iterations", str(FEWSHOT_CLI_ITERS)]
    ck, ck_seg = os.path.join(root, "ae"), os.path.join(root, "seg")
    ae_argv = point + ["--mode", "ae", "--resume", "--checkpoint-dir", ck]
    seg_argv = point + ["--mode", "seg", "--checkpoint-dir", ck_seg,
                        "--epochs", "1"]
    try:
        _reset_counts()
        t0 = time.perf_counter()
        ae = fewshot.main(ae_argv + [
            "--epochs", "2", "--metrics-csv", os.path.join(root, "ae.csv")])
        ae_s = time.perf_counter() - t0
        ae_launches = _counts()
        ae_rows = _csv_rows(os.path.join(root, "ae.csv"))
        resumed = fewshot.main(ae_argv + [
            "--epochs", "3", "--metrics-csv", os.path.join(root, "ae2.csv")])
        ae_rows2 = _csv_rows(os.path.join(root, "ae2.csv"))
        ae_names = sorted(os.listdir(ck))
        _reset_counts()
        t0 = time.perf_counter()
        seg = fewshot.main(seg_argv + [
            "--metrics-csv", os.path.join(root, "seg.csv")])
        seg_s = time.perf_counter() - t0
        seg_launches = _counts()
        seg_rows = _csv_rows(os.path.join(root, "seg.csv"))
        seg_names = sorted(os.listdir(ck_seg))
        seg_best = seg[-1]["best_path"]
        _reset_counts()
        t0 = time.perf_counter()
        predicted = fewshot.main(point + ["--mode", "seg", "--predict",
                                          "--pretrain-weight", seg_best])
        predict_s = time.perf_counter() - t0
        predict_launches = _counts()
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(root, ignore_errors=True)
    row = {"phase": "fewshot_cli", "ae_argv": ae_argv, "seg_argv": seg_argv,
           "ae_s": ae_s, "ae_epochs": _epochs(ae + resumed),
           "ae_csv_rows": ae_rows, "ae_csv_rows_resumed": ae_rows2,
           "ae_checkpoints": ae_names, "ae_launches_k1_k2_k1mma": ae_launches,
           "seg_s": seg_s, "seg_epochs": _epochs(seg),
           "seg_csv_rows": seg_rows, "seg_checkpoints": seg_names,
           "seg_launches_k1_k2_k1mma": seg_launches, "predict": predicted,
           "predict_s": predict_s, "predict_launches": predict_launches,
           "card": smi}
    emit(row)
    per = sum(B5_DEPTHS)
    for name, reports, want in (("ae", ae + resumed, FEWSHOT_AE_K),
                                ("seg", seg, FEWSHOT_SEG_K)):
        per_step = [tuple(n / max(r["train_steps"], 1)
                          for n in r["launches_train"]) for r in reports]
        if any(p != want for p in per_step) or any(
                r["train_steps"] != FEWSHOT_CLI_ITERS
                or r["launches_eval_k1"] != per for r in reports):
            steps = [r["train_steps"] for r in reports]
            evals = [r["launches_eval_k1"] for r in reports]
            raise AssertionError(f"fewshot_cli {name}: launches per step "
                                 f"{per_step} (expected {want}), steps "
                                 f"{steps}, eval {evals}")
    if ae_launches[2] != ae_launches[0] or seg_launches[2] != seg_launches[0]:
        raise AssertionError("a few-shot training K1 launch was not "
                             "tensor-core")
    rows = ae_rows + ae_rows2 + seg_rows
    if [r["step"] for r in rows] != ["0", "1", "2", "0"] or not all(
            math.isfinite(float(r["train_loss"]))
            and math.isfinite(float(r["eval_loss"])) for r in rows):
        raise AssertionError(f"fewshot_cli CSV rows {rows}")
    if [r["epoch"] for r in resumed] != [2]:
        raise AssertionError("the resumed few-shot run did not start at "
                             "epoch 2")
    if "fewshot_ae_last.pt" not in ae_names or not any(
            n.startswith("fewshot_ae_epoch_") for n in ae_names) or \
            seg_names != [os.path.basename(seg_best)] or \
            not seg_names[0].startswith("fewshot_seg_epoch_0_"):
        raise AssertionError(f"fewshot_cli checkpoints {ae_names}, "
                             f"{seg_names}")
    if predict_launches[:2] != (per, 0) or \
            not 0.0 <= predicted["eval_loss"] <= 1.0:
        raise AssertionError(f"fewshot --predict {predicted}, launches "
                             f"{predict_launches}")
    return row


def _stage_sum(rows, b, key, only_bytes=False, shapes=STAGE_SHAPES,
               dtype="bfloat16"):
    """Sum of `key` over one pass of the B5 stages in `dtype` at batch b
    (depth launches per stage shape, the stages' `shapes`); with
    `only_bytes`, over the stages whose bound is the bytes."""
    per = {(r["B"], r["Nq"], r["Nk"], r["C"], r["heads"]): r for r in rows
           if r["dtype"] == dtype}
    return sum(d * per[(b,) + s][key] for d, s in zip(B5_DEPTHS, shapes)
               if not only_bytes or per[(b,) + s]["bound_by"] == "bytes")


def _passes_sum(rows, passes, shapes=STAGE_SHAPES, dtype="bfloat16"):
    """ms, plain_ms, bound_ms, library_ms summed over `passes` ((batch,
    count) of B5 stage passes at the stages' `shapes`), and what bounds
    the sum."""

    def total(key, only_bytes=False):
        return sum(n * _stage_sum(rows, b, key, only_bytes, shapes, dtype)
                   for b, n in passes)

    bound = total("bound_ms")
    return {"ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": bound,
            "bound_by": "bytes" if total("bound_ms", True) >= bound / 2
            else "operations",
            "library_ms": total("library_ms")}


def _kernel_entry(rows, passes, dtype="bfloat16", shapes=STAGE_SHAPES,
                  **fields):
    """A `kernels` entry summed over `passes` of the B5 stages' `shapes`."""
    return {**fields, "max_abs_err": max(r["max_abs_err"] for r in rows),
            **_passes_sum(rows, passes, shapes, dtype), "ok": True}


def summary(k1_rows, k2_rows, train, serve, train_mode, cli, sup,
            transfer_grad, transfer_grad_nk356, transfer_step, sup_cli,
            transfer_cli, ts_step, ts_cli, ae_step, ae_cli, serve_ckpt,
            fewshot_grad, fewshot_step, fewshot_cli, grad):
    """The `kernels` line: each kernel's times, bound and plain/library
    times summed over what its main path runs, with its launches there.
    K1's bf16 kernel (`sr_attention_fwd`, wgmma, every bf16 path) and K2's
    (`sr_attention_bwd`) over one flagship EMA step (bf16, the B5 stage
    shapes at the batches the step runs; launches in the train phase's 4
    timed steps). K1's float32 kernel (`sr_attention_fwd_f32`, 3xTF32)
    over one B5 float32 forward at batch 2 with a CLS token per stage, as
    fewshot_grad runs it, and K2's float32 kernels (`sr_attention_bwd_f32`:
    row pass, key pass and split sum) over one few-shot pair loss's float32
    backward at the same shapes (2 x 52 launches); both also per
    transfer_grad pass (52 launches at Nk 266) and per transfer_grad_nk356
    pass (Nk 356), with launches in the float32 gradient phases (grad,
    train_mode's float32 half, transfer_grad, transfer_grad_nk356,
    fewshot_grad). K2's bf16 entry
    gives the host microseconds of one call and its launches per call (1,
    or 2 with the split sum, as the profiler saw them run); the designs the
    kernels replaced no longer build from this checkout, so their times are
    not in this line (`scripts/k1_design_ab.py` times them against a build
    of the earlier source). `per_serve_forward` sums K1's bf16 kernel over
    one serve batch-8 forward.
    `launches_by_path` counts every path's launches: the EMA phases, the
    supervised step, the bf16 transfer step, serving, and the supervised and
    transfer CLIs. `per_transfer_step` sums the wgmma K1 and K2 over one
    flagship transfer step (the Nk-266 shapes at batch 16: 2 microbatches,
    each a forward and a recompute, and a backward), `per_labeled_step`
    over one flagship `labeled_step` (both models: 2 microbatches of 16
    each, a forward and a recompute, and a backward, per model). The
    gradient teacher-student phases (ts_step, ts_cli) and the autoencoder
    phases (ae_step, ae_cli, the latter with its transfer epoch) join
    `launches_by_path`, and so do the few-shot phases (fewshot_step,
    fewshot_cli) and serve_ckpt; `per_fewshot_ae_step` and
    `per_fewshot_seg_step` sum each kernel over one few-shot step at batch
    2 (the CLS shapes: 4 or 2 categories, each a forward and a recompute,
    and a backward)."""

    def kernel_calls(i):
        return sum(c["launches_k1_k2_k1mma"][i]
                   for c in ts_step["runs"]["kernel"]["calls"])

    def ae(i):
        k = ae_step["runs"]["kernel"]
        return k["launches_k1_k2_k1mma"][i] + \
            k["eval_launches_k1_k2_k1mma"][i]

    ts_step_path = ("ts_step (kernel path: 2 pseudo_label_step, 2 "
                    "pseudo_label_infer_step, 2 labeled_step)")
    n_ev, n_st = CLI_EVAL_BATCH, CLI_STEPS_PER_EPOCH
    ts_cli_path = (f"ts_cli (3 epochs: phase A {n_st} pseudo_label_step or "
                   f"{n_st} pseudo_label_infer_step, phase B {n_st} "
                   f"labeled_step, an eval batch of {n_ev} x 2 models)")
    cli_path = (f"cli (2 epochs: {2 * n_st} train steps, 2 eval batches of "
                f"{n_ev} x 2 models)")
    sup_cli_path = (f"sup_cli (2 epochs: {2 * n_st} train steps, 2 eval "
                    f"batches of {n_ev})")
    transfer_cli_path = (f"transfer_cli (2 epochs, Nk 266: {2 * n_st} train "
                         f"steps, 2 eval batches of {n_ev})")
    ae_step_path = "ae_step (2 kernel-path train steps, 1 eval of 32)"
    ae_cli_path = (f"ae_cli (2 epochs: {4 * n_st} train steps, 2 eval "
                   f"batches of {n_ev}; then 1 transfer epoch, Nk 266)")
    few_step_path = ("fewshot_step (kernel path: 2 fewshot_ae_step, 2 "
                     "fewshot_seg_step, batch 2, Nk 257)")
    few_cli_path = ("fewshot_cli (ae 3 epochs and seg 1 epoch of 4 steps, "
                    "an eval batch of 4 each, --predict)")
    few_grad_path = ("fewshot_grad (B5 float32, Nk 257: the AE and seg "
                     "pair losses)")

    def few_step(i):
        return sum(c["launches_k1_k2_k1mma"][i]
                   for m in ("ae", "seg")
                   for c in fewshot_step["runs"][f"{m}/kernel"]["calls"])

    def few_cli(i):
        return fewshot_cli["ae_launches_k1_k2_k1mma"][i] + \
            fewshot_cli["seg_launches_k1_k2_k1mma"][i] + \
            fewshot_cli["predict_launches"][i]

    def few_grad(i):
        return sum(r["launches_k1_k2_k1mma"][i] for r in fewshot_grad)
    src = "semisupervisedobjectdetection_torch/csrc/"
    tpu = "semisupervisedobjectdetection_tpu/ops/sr_attention.py"
    step = ((TEACHER_BATCH, ACCUM), (MICRO, 2 * ACCUM))
    wg_rows = [r for r in k1_rows if r["dtype"] == "bfloat16"]
    f32_rows = [r for r in k1_rows if r["dtype"] == "float32"]
    k1 = _kernel_entry(
        wg_rows, step,
        name="sr_attention_fwd", route="cuda", design="wgmma",
        source=src + "sr_attention_fwd.cu", replaces=tpu + ":36",
        launches=train["launches_k1_mma"],
        per="one flagship EMA step: 2 x (teacher forward at batch 32 + "
            "student forward and recompute at batch 16), B5 512x512 bf16, "
            f"{K1_PER_STEP} launches",
        launches_per="4 timed EMA steps",
        host_us_per_call=max(r["host_us_per_call"] for r in wg_rows),
        launches_by_path={
            "train (4 timed EMA steps)": train["launches_k1_mma"],
            "train_mode (2 flagship train-mode EMA steps)":
                train_mode["launches_k1_mma"],
            cli_path: cli["launches_k1_k2_k1mma"][2],
            "supervised (2 kernel-path steps in eval and 2 in train mode)":
                sum(sup["runs"][f"{m}/kernel"]["launches_k1_k2_k1mma"][2]
                    for m in ("eval_mode", "train_mode")),
            "transfer_step (2 kernel-path bf16 steps, Nk 266)":
                transfer_step["runs"]["kernel"]["launches_k1_k2_k1mma"][2],
            f"serve ({serve['batches']} batches)": serve["launches_mma"],
            "serve_ckpt (4 batches from sup_cli's checkpoint)":
                serve_ckpt["launches_k1_k2_k1mma"][2],
            sup_cli_path: sup_cli["launches_k1_k2_k1mma"][2],
            f"sup_cli --predict (1 eval batch of {n_ev})":
                sup_cli["launches_predict"][2],
            transfer_cli_path: transfer_cli["launches_k1_k2_k1mma"][2],
            ts_step_path: kernel_calls(2),
            ts_cli_path: ts_cli["launches_k1_k2_k1mma"][2]
            + ts_cli["launches_quirks_run"][2],
            ae_step_path: ae(2),
            ae_cli_path: ae_cli["launches_k1_k2_k1mma"][2]
            + ae_cli["launches_transfer"][2],
            few_step_path: few_step(2),
            few_cli_path: few_cli(2)},
        per_serve_forward={
            **_passes_sum(wg_rows, ((BATCH, 1),)),
            "per": f"one serve forward: B5 512x512 bf16 at batch {BATCH}, "
                   f"{sum(B5_DEPTHS)} launches"},
        per_transfer_step=_passes_sum(wg_rows, ((MICRO, 2 * ACCUM),),
                                      TRANSFER_SHAPES),
        per_labeled_step=_passes_sum(wg_rows, ((MICRO, 4 * ACCUM),)),
        per_fewshot_ae_step=_passes_sum(wg_rows, ((FEW_BATCH, 8),),
                                        FEWSHOT_SHAPES),
        per_fewshot_seg_step=_passes_sum(wg_rows, ((FEW_BATCH, 4),),
                                         FEWSHOT_SHAPES))
    f32_paths = {
        "grad (B5 float32, batch 2)": grad["launches_k1_k2"],
        "train_mode (B5 float32 train-mode gradient, batch 2)":
            train_mode["f32_launches_k1_k2"],
        "transfer_grad (B5 float32, Nk 266)":
            transfer_grad["launches_k1_k2"],
        "transfer_grad_nk356 (B5 float32, Nk 356)":
            transfer_grad_nk356["launches_k1_k2"],
        few_grad_path: (few_grad(0), few_grad(1))}

    def f32_entry(rows, passes, kernel, **fields):
        """A float32 entry: summed over the few-shot `passes`, and per
        transfer_grad and transfer_grad_nk356 pass (one pass at batch 2)."""
        i = 0 if kernel == "fwd" else 1
        return _kernel_entry(
            rows, passes, dtype="float32", shapes=FEWSHOT_SHAPES,
            route="cuda", design="3xtf32",
            source=src + f"sr_attention_{kernel}.cu",
            launches=sum(v[i] for v in f32_paths.values()),
            launches_per="grad, train_mode's float32 gradient, "
                         "transfer_grad, transfer_grad_nk356 and fewshot_grad",
            launches_by_path={k: v[i] for k, v in f32_paths.items()},
            per_transfer_grad_pass=_passes_sum(
                rows, ((FEW_BATCH, 1),), TRANSFER_SHAPES, "float32"),
            per_transfer_grad_nk356_pass=_passes_sum(
                rows, ((FEW_BATCH, 1),), NK356_SHAPES, "float32"),
            bound_rate=PEAK_RATE_NAME["float32"], **fields)

    k1_f32 = f32_entry(
        f32_rows, ((FEW_BATCH, 1),), "fwd", name="sr_attention_fwd_f32",
        replaces=tpu + ":36",
        per=f"one B5 512x512 float32 forward at batch {FEW_BATCH} with a "
            f"CLS token per stage (Nk 257), as fewshot_grad runs it, "
            f"{sum(B5_DEPTHS)} launches")
    k2_bf16 = [r for r in k2_rows if r["dtype"] == "bfloat16"]
    k2_f32 = [r for r in k2_rows if r["dtype"] == "float32"]
    k2 = _kernel_entry(
        k2_bf16, ((MICRO, ACCUM),),
        name="sr_attention_bwd", route="cuda", design="wgmma",
        source=src + "sr_attention_bwd.cu", replaces=tpu + ":115",
        launches=train["launches_k2"],
        max_rel_err=max(r["rel_err"] for r in k2_bf16),
        host_us_per_call=max(r["host_us_per_call"] for r in k2_bf16),
        launches_per_call=sorted({r["launches_per_call"] for r in k2_bf16}),
        per="one flagship EMA step: 2 x the student backward at batch 16, "
            f"B5 512x512 bf16, {K2_PER_STEP} launches",
        launches_per="4 timed EMA steps",
        launches_by_path={
            "train (4 timed EMA steps)": train["launches_k2"],
            "train_mode (2 flagship train-mode EMA steps)":
                train_mode["launches_k2"],
            cli_path: cli["launches_k1_k2_k1mma"][1],
            "supervised (2 kernel-path steps in eval and 2 in train mode)":
                sum(sup["runs"][f"{m}/kernel"]["launches_k1_k2_k1mma"][1]
                    for m in ("eval_mode", "train_mode")),
            "transfer_step (2 kernel-path bf16 steps, Nk 266)":
                transfer_step["runs"]["kernel"]["launches_k1_k2_k1mma"][1],
            sup_cli_path: sup_cli["launches_k1_k2_k1mma"][1],
            transfer_cli_path: transfer_cli["launches_k1_k2_k1mma"][1],
            ts_step_path: kernel_calls(1),
            ts_cli_path: ts_cli["launches_k1_k2_k1mma"][1]
            + ts_cli["launches_quirks_run"][1],
            ae_step_path: ae(1),
            ae_cli_path: ae_cli["launches_k1_k2_k1mma"][1]
            + ae_cli["launches_transfer"][1],
            few_step_path: few_step(1),
            few_cli_path: few_cli(1)},
        per_transfer_step=_passes_sum(k2_bf16, ((MICRO, ACCUM),),
                                      TRANSFER_SHAPES),
        per_labeled_step=_passes_sum(k2_bf16, ((MICRO, 2 * ACCUM),)),
        per_fewshot_ae_step=_passes_sum(k2_bf16, ((FEW_BATCH, 4),),
                                        FEWSHOT_SHAPES),
        per_fewshot_seg_step=_passes_sum(k2_bf16, ((FEW_BATCH, 2),),
                                         FEWSHOT_SHAPES),
        grid_fewshot=[
            r["grid"] for s in FEWSHOT_SHAPES for r in k2_bf16
            if r["B"] == FEW_BATCH
            and (r["Nq"], r["Nk"], r["C"], r["heads"]) == s])
    k2_f32_entry = f32_entry(
        k2_f32, ((FEW_BATCH, 2),), "bwd", name="sr_attention_bwd_f32",
        replaces=tpu + ":115",
        max_rel_err=max(r["rel_err"] for r in k2_f32),
        host_us_per_call=max(r["host_us_per_call"] for r in k2_f32),
        launches_per_call=sorted({r["launches_per_call"] for r in k2_f32}),
        per=f"one few-shot pair loss's backward in B5 512x512 float32 at "
            f"batch {FEW_BATCH} with a CLS token per stage (Nk 257), as "
            f"fewshot_grad runs it, {2 * sum(B5_DEPTHS)} launches")
    return [k1, k1_f32, k2, k2_f32_entry]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import semisupervisedobjectdetection_torch  # noqa: F401 (fails alone)

    phase = "device"
    seconds = {}
    try:
        t0 = time.perf_counter()
        phase_device()
        smi = nvidia_smi_line()
        results = {}
        for phase, fn in (("build", phase_build), ("kernel", phase_kernel),
                          ("kernel_bwd", phase_kernel_bwd),
                          ("model", phase_model_f32),
                          ("serve", lambda: phase_serve(smi)),
                          ("grad", phase_grad),
                          ("train", lambda: phase_train(smi)),
                          ("train_mode", lambda: phase_train_mode(smi)),
                          ("augment", lambda: phase_augment(smi)),
                          ("cli", lambda: phase_cli(
                              smi, results["train"]["step_ms"],
                              results["train_mode"]["step_ms_kernel_plain"]
                              ["kernel"][-1])),
                          ("supervised", lambda: phase_supervised(smi)),
                          ("transfer_grad", phase_transfer_grad),
                          ("transfer_grad_nk356", lambda: phase_transfer_grad(
                              NK356_TOKENS, NK356, "transfer_grad_nk356")),
                          ("transfer_step", lambda: phase_transfer_step(smi)),
                          ("sup_cli", lambda: phase_sup_cli(smi)),
                          ("serve_ckpt", lambda: phase_serve_ckpt(
                              smi, results["sup_cli"])),
                          ("transfer_cli", lambda: phase_transfer_cli(
                              smi, results["sup_cli"])),
                          ("ts_step", lambda: phase_ts_step(smi)),
                          ("ts_cli", lambda: phase_ts_cli(smi)),
                          ("ae_step", lambda: phase_ae_step(smi)),
                          ("ae_cli", lambda: phase_ae_cli(smi)),
                          ("fewshot_grad", phase_fewshot_grad),
                          ("fewshot_step", lambda: phase_fewshot_step(smi)),
                          ("fewshot_cli", lambda: phase_fewshot_cli(smi))):
            t = time.perf_counter()
            results[phase] = fn()
            seconds[phase] = round(time.perf_counter() - t, 2)
            emit({"phase": phase, "seconds": seconds[phase]})
        kernels = {"kernels": summary(results["kernel"],
                                      results["kernel_bwd"],
                                      results["train"], results["serve"],
                                      results["train_mode"],
                                      results["cli"], results["supervised"],
                                      results["transfer_grad"],
                                      results["transfer_grad_nk356"],
                                      results["transfer_step"],
                                      results["sup_cli"],
                                      results["transfer_cli"],
                                      results["ts_step"],
                                      results["ts_cli"],
                                      results["ae_step"],
                                      results["ae_cli"],
                                      results["serve_ckpt"],
                                      results["fewshot_grad"],
                                      results["fewshot_step"],
                                      results["fewshot_cli"],
                                      results["grad"])}
        emit({"phase": "total", "seconds": round(time.perf_counter() - t0,
                                                 2), "per_phase": seconds})
    except Exception as e:
        emit({"phase": phase, "ok": False,
              "error": f"{type(e).__name__}: {e}"})
        raise
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
