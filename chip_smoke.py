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
                (`cuobjdump --dump-sass`). The tensor-core kernels must
                show tensor-core instructions and no stack frame or spills.
3. kernel     - `sr_attention_fwd` (K1) against its plain PyTorch version:
                the tensor-core kernel (bfloat16, the default, the training
                step's) at the four MiT-B5 512x512 stage shapes at batch 8,
                16 (student) and 32 (teacher), the scalar kernel at batch 8
                in bfloat16 (serving's) and float32, each also at two
                shapes with a prompt/CLS prefix, and the tensor-core kernel
                at the transfer step's four shapes (10 prompt tokens per
                stage, Nk 266) at batch 16: max abs
                error against a stated tolerance, and CUDA-event times of
                the kernel (for the tensor-core rows also of the scalar
                kernel on the same inputs, the design it replaced in
                training), the plain version and
                `F.scaled_dot_product_attention` (a yardstick only; the port
                never calls it), beside the bound from shapes (each byte in
                and out once at 3.35 TB/s; flops at 989 TFLOP/s bf16,
                67 TFLOP/s f32).
4. kernel_bwd - `sr_attention_bwd` (K2) against its plain version at the
                four stage shapes and the two prefix shapes at batch 16, in
                bfloat16 and float32, and at the rest of the transfer step's
                shapes (Nk 266) in bfloat16: max error against a stated
                tolerance, bit-equality of two launches, and the times of
                the kernel, the plain version and the autograd backward of
                `F.scaled_dot_product_attention`, beside the bound.
5. model      - MiT-B5 at 512x512 in float32, TF32 off: the kernel path and
                the plain path agree on a batch of two images.
6. serve      - the port's InferenceServer (MiT-B5, 512x512, bfloat16,
                max_batch 8, seeded random weights) answers 16 concurrent raw
                requests and 2 PNG requests over HTTP; every request succeeds
                with a finite mask of the right shape, K1 ran exactly 52
                times per batch served (3+6+40+3 layers; its scalar kernel,
                which `SegFormerModel` pins), and the served masks agree
                with the plain path on the same inputs.
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
                flagship point: MiT-B5 512x512 bf16, 64 synthetic tiles,
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
14. transfer_step - the transfer CLI's step in bfloat16 through
                `SegFormerModel.train_one_epoch` at the flagship point (the
                configuration of transfer_grad, 32 images per step in 2
                microbatches of 16): two steps through the kernels and
                through the plain path agree on the losses, with K1
                (tensor-core) launched 208 and K2 104 times per step, every
                launch at Nk = 266, the plain path none.
15. sup_cli     - `cli/supervised.py::main` at the flagship point: 64
                synthetic tiles, batch 32 in 2 microbatches, 2 epochs with
                --resume, then a resumed third epoch, then `--predict
                --dump-masks` from the best checkpoint: finite CSV rows, best
                and `_last` checkpoints, the resume at epoch 2, 21 pairs of
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SEED = 0
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
# B5 in bfloat16: every layer rounds to bf16, so one-ulp differences in
# attention outputs travel through 52 residual layers; the probabilities
# are compared with this bound and the 0.5-thresholded masks must agree
# on all but this share of pixels.
SERVE_PROB_TOL = 5e-2
SERVE_MASK_DISAGREE = 1e-3
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
# The CLI phase: bench.py's flagship point through the CLI.
CLI_TILES = 64
CLI_EVAL_BATCH = max(CLI_TILES // 3, 4)        # 21 eval tiles, one batch
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
TRANSFER_REFUSED_TOKENS = (40, 40, 40, 40)     # Nk = 296 > 288
FROZEN_PREFIXES = tuple(f"segformer.encoder.block.{i}."
                        for i in TRANSFER_FROZEN)


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
    """Mean device time of `fn()` in ms, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _bound(n_bytes, flops, dtype_name):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(b, nq, nk, c, dtype_name):
    """(bound ms, "bytes" or "operations") of SR-attention at a shape:
    q, k, v read once and the output written once; 4*B*Nq*Nk*C flops at
    the dtype's peak (tensor-core bf16, or float32 outside the tensor
    cores)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    return _bound((2 * b * nq * c + 2 * b * nk * c) * elem,
                  4 * b * nq * nk * c, dtype_name)


def attention_bwd_bound(b, nq, nk, c, dtype_name):
    """(bound ms, "bytes" or "operations") of the SR-attention backward: q,
    g and dq (B*Nq*C each) and k, v, dk and dv (B*Nk*C each) moved once;
    10*B*Nq*Nk*C flops (five products) at the dtype's peak."""
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
    """Launches of K1 (all), K2, and K1's tensor-core kernel."""
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
    # the CLIs refuse, before building a model, what the kernels refuse
    limits = (lib.sr_attention_fwd_max_nk(), bwd.sr_attention_bwd_max_nk())
    if limits != (MAX_NK, MAX_NK):
        raise AssertionError(f"kernels take Nk <= {limits}; the wrapper's "
                             f"MAX_NK is {MAX_NK}")
    rows = []
    for source in (_SOURCE, _BWD_SOURCE):
        info = _build.BUILD_INFO[source]
        # ptxas reports static shared memory only; the kernels' is dynamic
        # (the backward's row pass)
        if source == _SOURCE:
            smem = {f"nk{nk}_d64_{name}":
                    lib.sr_attention_fwd_smem_bytes(nk, 64, elem, mma)
                    for nk in (256, 266) for name, elem, mma in (
                        ("bf16_mma", 2, 1), ("bf16_scalar", 2, 0),
                        ("f32", 4, 0))}
        else:
            smem = {f"nk{nk}_d64_{name}":
                    bwd.sr_attention_bwd_smem_bytes(nk, 64, elem)
                    for nk in (256, 266) for name, elem in (("bf16_mma", 2),
                                                            ("f32", 4))}
        emit({"phase": "build", "source": source,
              "seconds": round(seconds, 3),
              "nvcc_seconds": round(info["seconds"], 3),
              "sources_hashed": [p.name for p in _build.source_files(
                  _build.CSRC / source)],
              "dynamic_smem_bytes": smem})
        ptxas = _ptxas_kernels(info["log"])
        sass = _sass_tensor_ops(info["path"])
        names = _demangle(sorted(sass))
        for sym in sorted(sass):
            row = {"phase": "build", "source": source, "kernel": names[sym],
                   "design": "mma" if "_mma_kernel" in sym else "scalar",
                   "tensor_core_instructions": sass[sym],
                   **ptxas.get(sym, {})}
            emit(row)
            rows.append(row)
    mma = [r for r in rows if r["design"] == "mma"]
    if len(mma) < 2 or any(sum(r["tensor_core_instructions"].values()) == 0
                           for r in mma):
        raise AssertionError(f"bfloat16 kernels without tensor-core "
                             f"instructions: {mma}")
    # their tiles live in registers: a stack frame or spills would put
    # them in local memory
    local = [r for r in mma if r.get("stack_bytes", 1)
             or r.get("spill_store_bytes", 1)]
    if local:
        raise AssertionError(f"tensor-core kernels with local memory: "
                             f"{local}")
    return rows


def _k1_cases():
    """(batch, shape, dtype, design) of the K1 checks: the tensor-core
    kernel at the stage shapes at the serving, student and teacher batches;
    the scalar kernel at the serving batch in bf16 and f32; all three at the
    prefix shapes at the serving batch; the tensor-core kernel at the
    transfer step's shapes at the student batch."""
    cases = [(b, s, "bfloat16", "mma") for b in (BATCH, MICRO, TEACHER_BATCH)
             for s in STAGE_SHAPES]
    cases += [(BATCH, s, d, "scalar") for d in ("bfloat16", "float32")
              for s in STAGE_SHAPES]
    cases += [(BATCH, s, d, design) for s in PREFIX_SHAPES
              for d, design in (("bfloat16", "mma"), ("bfloat16", "scalar"),
                                ("float32", "scalar"))]
    cases += [(MICRO, s, "bfloat16", "mma") for s in TRANSFER_SHAPES]
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
        mma = design == "mma"
        q, k, v = (torch.randn(b, n, c, device="cuda", generator=gen)
                   .to(dtype) for n in (nq, nk, nk))
        out = sr_attention(q, k, v, h, mma)
        torch.cuda.synchronize()
        ref = sr_attention_reference(q, k, v, h)
        err = (out.float() - ref.float()).abs().max().item()
        ne_plain = (out != ref).float().mean().item()
        ok = bool(torch.isfinite(out).all().item()) \
            and err <= KERNEL_TOL[dtype_name]
        # the exact function in float64 (no bf16 rounding of p): an
        # independent check of both versions
        f64 = _attention_f64(q, k, v, h)
        err64 = (out.double() - f64).abs().max().item()
        del f64
        qs, ks, vs = (_heads(t, h) for t in (q, k, v))
        bound, by = attention_bound(b, nq, nk, c, dtype_name)
        if mma:
            # the scalar kernel on the same inputs: the design the
            # tensor-core one replaced in the training step
            scalar = {"scalar_ms": cuda_ms(
                lambda: sr_attention(q, k, v, h, False))}
        else:
            scalar = {}
        row = {"phase": "kernel", "name": "sr_attention_fwd",
               "B": b, "Nq": nq, "Nk": nk, "C": c, "heads": h,
               "dtype": dtype_name, "design": design, "max_abs_err": err,
               "share_ne_plain": ne_plain,
               "tol": KERNEL_TOL[dtype_name], "ok": ok,
               "max_abs_err_vs_f64": err64,
               "ms": cuda_ms(lambda: sr_attention(q, k, v, h, mma)),
               **scalar,
               "plain_ms": cuda_ms(
                   lambda: sr_attention_reference(q, k, v, h), iters=5),
               "library_ms": cuda_ms(
                   lambda: F.scaled_dot_product_attention(qs, ks, vs)),
               "bound_ms": bound, "bound_by": by}
        emit(row)
        rows.append(row)
        del q, k, v, out, ref, qs, ks, vs
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"K1 disagrees with its plain version: {bad}")
    return rows


def phase_kernel_bwd():
    import torch
    import torch.nn.functional as F

    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention_backward_reference,
        sr_attention_bwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    # every stage and prefix shape in both types; the transfer step's shapes
    # (bf16 only: its float32 gradients are transfer_grad's) not among them
    cases = [(s, d) for s in STAGE_SHAPES + PREFIX_SHAPES
             for d in ("bfloat16", "float32")]
    cases += [(s, "bfloat16") for s in TRANSFER_SHAPES
              if s not in PREFIX_SHAPES]
    for shape, dtype_name in cases:
        nq, nk, c, h = shape
        dtype = getattr(torch, dtype_name)
        q, k, v, g = (torch.randn(MICRO, n, c, device="cuda",
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
        del got, again, ref
        # the yardstick: the autograd backward of SDPA on the same
        # q, k, v, g (flash/efficient kernels; the port never calls it)
        qs, ks, vs = (_heads(t, h).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        gs = _heads(g, h)
        bound, by = attention_bwd_bound(MICRO, nq, nk, c, dtype_name)
        row = {"phase": "kernel_bwd", "name": "sr_attention_bwd",
               "B": MICRO, "Nq": nq, "Nk": nk, "C": c, "heads": h,
               "dtype": dtype_name,
               "design": "mma" if dtype_name == "bfloat16" else "scalar",
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
               "bound_ms": bound, "bound_by": by}
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

    plain = SegFormerModel(config=cfg.replace(attn_impl="plain"), seed=SEED)
    x = imgs[:n_raw].astype(np.float32) / 255.0
    ref = np.concatenate([plain.predict(x[i:i + BATCH])
                          for i in range(0, n_raw, BATCH)])
    err = float(np.abs(probs - ref).max())
    disagree = float(((probs >= 0.5) != (ref >= 0.5)).mean())
    row = {"phase": "serve", "variant": "b5", "img": IMG,
           "dtype": "bfloat16", "max_batch": BATCH, "requests": n_raw + 2,
           "statuses": sorted(set(statuses)), "batches": batches,
           "launches": launches, "launches_expected": per_forward * batches,
           "launches_mma": mma_launches,
           "wall_s": wall, "img_per_s": (n_raw + 2) / wall,
           "latency_ms": after.get("latency_ms"),
           "mean_batch_fill": after["mean_batch_fill"],
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "healthz": health, "max_abs_err_vs_plain": err,
           "tol": SERVE_PROB_TOL, "mask_disagree_share": disagree,
           "mask_disagree_tol": SERVE_MASK_DISAGREE, "card": smi}
    emit(row)
    del model, plain
    torch.cuda.empty_cache()
    if set(statuses) != {200}:
        raise AssertionError(f"non-200 responses: {statuses}")
    if probs.shape != (n_raw, IMG, IMG) or not np.isfinite(probs).all():
        raise AssertionError(f"bad served masks: {probs.shape}")
    if any(p.shape != (IMG, IMG) for p in pngs):
        raise AssertionError("bad PNG masks")
    if batches < 1 or launches != per_forward * batches or mma_launches:
        raise AssertionError(f"{launches} kernel launches ({mma_launches} "
                             f"tensor-core) for {batches} batches; expected "
                             f"{per_forward} scalar per batch")
    if health.get("platform") != "cuda":
        raise AssertionError(f"/healthz reports {health}")
    if err > SERVE_PROB_TOL or disagree > SERVE_MASK_DISAGREE:
        raise AssertionError("served masks disagree with the plain path")
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

    def rec_fwd(ctx, q, k, v, num_heads, mma=True):
        log["k1"].append(k.shape[1])
        ctx.recorded_nk = k.shape[1]
        return fwd(ctx, q, k, v, num_heads, mma)

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


def phase_transfer_grad():
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
        m.add_prompt_token(TRANSFER_TOKENS)
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
    row = {"phase": "transfer_grad", "variant": "b5", "img": IMG,
           "dtype": "float32", "batch": 2, "frozen": list(TRANSFER_FROZEN),
           "prompt_tokens": list(TRANSFER_TOKENS), "quirks": False,
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
        raise AssertionError(f"transfer launches {launches}: expected K1 "
                             f"{2 * per} and K2 {per}")
    if row["nk_k1"] != [TRANSFER_NK] or row["nk_k2"] != [TRANSFER_NK] or \
            row["nk_calls_k1_k2"] != [2 * per, per] or \
            nks["plain"] != {"k1": [], "k2": []}:
        raise AssertionError(f"Nk of the launches {row['nk_k1']}, "
                             f"{row['nk_k2']}: expected {TRANSFER_NK}")
    if not all(v > 0 for v in moving.values()):
        raise AssertionError(f"no gradient reaches {moving}")
    if not finite or worst[0][1] > GRAD_F32_TOL:
        raise AssertionError("B5 float32 transfer gradients through the "
                             "kernels disagree with the plain path")
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


def _stage_sum(rows, b, key, only_bytes=False, shapes=STAGE_SHAPES):
    """Sum of `key` over one pass of the B5 stages in bf16 at batch b
    (depth launches per stage shape, the stages' `shapes`); with
    `only_bytes`, over the stages whose bound is the bytes."""
    per = {(r["B"], r["Nq"], r["Nk"], r["C"], r["heads"]): r for r in rows
           if r["dtype"] == "bfloat16"}
    return sum(d * per[(b,) + s][key] for d, s in zip(B5_DEPTHS, shapes)
               if not only_bytes or per[(b,) + s]["bound_by"] == "bytes")


def _passes_sum(rows, passes, shapes=STAGE_SHAPES):
    """ms, plain_ms, bound_ms, library_ms summed over `passes` ((batch,
    count) of B5 stage passes at the stages' `shapes`), and what bounds
    the sum."""

    def total(key, only_bytes=False):
        return sum(n * _stage_sum(rows, b, key, only_bytes, shapes)
                   for b, n in passes)

    bound = total("bound_ms")
    return {"ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": bound,
            "bound_by": "bytes" if total("bound_ms", True) >= bound / 2
            else "operations",
            "library_ms": total("library_ms")}


def _kernel_entry(rows, passes, **fields):
    """A `kernels` entry summed over `passes` of the B5 stage shapes."""
    return {**fields, "max_abs_err": max(r["max_abs_err"] for r in rows),
            **_passes_sum(rows, passes), "ok": True}


def summary(k1_rows, k2_rows, train, serve, train_mode, cli, sup,
            transfer_grad, transfer_step, sup_cli, transfer_cli):
    """The `kernels` line: each kernel's times, bound and plain/library
    times summed over what its main path runs, with its launches there: K1's
    tensor-core kernel (`sr_attention_fwd`) and K2 over one flagship EMA
    step (bf16, the B5 stage shapes at the batches the step runs; launches
    in the train phase's 4 timed steps), K1's scalar kernel
    (`sr_attention_fwd_scalar`) over one serve batch-8 forward (launches in
    the serve phase). `earlier_ms` is the scalar kernel's time over the same
    step, timed in this run. `launches_by_path` counts every path's
    launches: the EMA phases, the supervised step, the float32 transfer
    gradients (the scalar K1 and K2 in float32), the bf16 transfer step,
    and the supervised and transfer CLIs. `per_transfer_step` sums the
    tensor-core K1 and K2 over one flagship transfer step (the Nk-266 shapes
    at batch 16: 2 microbatches, each a forward and a recompute, and a
    backward)."""
    src = "semisupervisedobjectdetection_torch/csrc/"
    tpu = "semisupervisedobjectdetection_tpu/ops/sr_attention.py"
    step = ((TEACHER_BATCH, ACCUM), (MICRO, 2 * ACCUM))
    mma_rows = [r for r in k1_rows if r["design"] == "mma"]
    k1 = _kernel_entry(
        mma_rows, step,
        name="sr_attention_fwd", route="cuda", design="mma",
        source=src + "sr_attention_fwd.cu", replaces=tpu + ":36",
        launches=train["launches_k1_mma"],
        per="one flagship EMA step: 2 x (teacher forward at batch 32 + "
            "student forward and recompute at batch 16), B5 512x512 bf16, "
            f"{K1_PER_STEP} launches",
        launches_per="4 timed EMA steps",
        earlier_ms=sum(n * _stage_sum(mma_rows, b, "scalar_ms")
                       for b, n in step),
        earlier_design="scalar, on the same inputs in this run",
        launches_by_path={
            "train (4 timed EMA steps)": train["launches_k1_mma"],
            "train_mode (2 flagship train-mode EMA steps)":
                train_mode["launches_k1_mma"],
            "cli (2 epochs: 4 train steps, 2 eval batches of 21 x 2 "
            "models)": cli["launches_k1_k2_k1mma"][2],
            "supervised (2 kernel-path steps in eval and 2 in train mode)":
                sum(sup["runs"][f"{m}/kernel"]["launches_k1_k2_k1mma"][2]
                    for m in ("eval_mode", "train_mode")),
            "transfer_step (2 kernel-path bf16 steps, Nk 266)":
                transfer_step["runs"]["kernel"]["launches_k1_k2_k1mma"][2],
            "sup_cli (2 epochs: 4 train steps, 2 eval batches of 21)":
                sup_cli["launches_k1_k2_k1mma"][2],
            "sup_cli --predict (1 eval batch of 21)":
                sup_cli["launches_predict"][0],
            "transfer_cli (2 epochs, Nk 266: 4 train steps, 2 eval "
            "batches of 21)": transfer_cli["launches_k1_k2_k1mma"][2]},
        per_transfer_step=_passes_sum(mma_rows, ((MICRO, 2 * ACCUM),),
                                      TRANSFER_SHAPES))
    k1_scalar = _kernel_entry(
        [r for r in k1_rows if r["design"] == "scalar"], ((BATCH, 1),),
        name="sr_attention_fwd_scalar", route="cuda", design="scalar",
        source=src + "sr_attention_fwd.cu", replaces=tpu + ":36",
        launches=serve["launches"],
        per=f"one serve forward: B5 512x512 bf16 at batch {BATCH}, "
            f"{sum(B5_DEPTHS)} launches",
        launches_per=f"the serve phase ({serve['batches']} batches)",
        launches_by_path={
            "serve": serve["launches"],
            "transfer_grad (B5 float32, Nk 266: forward and recompute)":
                transfer_grad["launches_k1_k2"][0]})
    k2 = _kernel_entry(
        k2_rows, ((MICRO, ACCUM),),
        name="sr_attention_bwd", route="cuda", design="mma",
        source=src + "sr_attention_bwd.cu", replaces=tpu + ":115",
        launches=train["launches_k2"],
        max_rel_err=max(r["rel_err"] for r in k2_rows),
        per="one flagship EMA step: 2 x the student backward at batch 16, "
            f"B5 512x512 bf16, {K2_PER_STEP} launches",
        launches_per="4 timed EMA steps",
        launches_by_path={
            "train (4 timed EMA steps)": train["launches_k2"],
            "train_mode (2 flagship train-mode EMA steps)":
                train_mode["launches_k2"],
            "cli (2 epochs: 4 train steps)": cli["launches_k1_k2_k1mma"][1],
            "supervised (2 kernel-path steps in eval and 2 in train mode)":
                sum(sup["runs"][f"{m}/kernel"]["launches_k1_k2_k1mma"][1]
                    for m in ("eval_mode", "train_mode")),
            "transfer_grad (B5 float32, Nk 266)":
                transfer_grad["launches_k1_k2"][1],
            "transfer_step (2 kernel-path bf16 steps, Nk 266)":
                transfer_step["runs"]["kernel"]["launches_k1_k2_k1mma"][1],
            "sup_cli (2 epochs: 4 train steps)":
                sup_cli["launches_k1_k2_k1mma"][1],
            "transfer_cli (2 epochs, Nk 266: 4 train steps)":
                transfer_cli["launches_k1_k2_k1mma"][1]},
        per_transfer_step=_passes_sum(k2_rows, ((MICRO, ACCUM),),
                                      TRANSFER_SHAPES))
    return [k1, k1_scalar, k2]


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
                          ("transfer_step", lambda: phase_transfer_step(smi)),
                          ("sup_cli", lambda: phase_sup_cli(smi)),
                          ("transfer_cli", lambda: phase_transfer_cli(
                              smi, results["sup_cli"]))):
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
                                      results["transfer_step"],
                                      results["sup_cli"],
                                      results["transfer_cli"])}
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
