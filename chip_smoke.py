#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as JSON lines with its seconds; any failure exits
non-zero before the final line:

1. device     - the card's name, count and power limit (no CUDA: exit 2).
2. build      - compile both kernels from `csrc/` at once, one nvcc each
                (the `-Xptxas -v` register/shared-memory summary is printed).
3. kernel     - `sr_attention_fwd` (K1) against its plain PyTorch version at
                the four MiT-B5 512x512 stage shapes at batch 8 (serving),
                16 (student) and 32 (teacher) in bfloat16, at batch 8 in
                float32, and at two shapes with a prompt/CLS prefix: max abs
                error against a stated tolerance, and CUDA-event times of
                the kernel, the plain version and
                `F.scaled_dot_product_attention` (a yardstick only; the port
                never calls it), beside the bound from shapes (each byte in
                and out once at 3.35 TB/s; flops at 989 TFLOP/s bf16,
                67 TFLOP/s f32).
4. kernel_bwd - `sr_attention_bwd` (K2) against its plain version at the
                four stage shapes and the two prefix shapes at batch 16, in
                bfloat16 and float32: max error against a stated tolerance,
                bit-equality of two launches, and the times of the kernel,
                the plain version and the autograd backward of
                `F.scaled_dot_product_attention`, beside the bound.
5. model      - MiT-B5 at 512x512 in float32, TF32 off: the kernel path and
                the plain path agree on a batch of two images.
6. serve      - the port's InferenceServer (MiT-B5, 512x512, bfloat16,
                max_batch 8, seeded random weights) answers 16 concurrent raw
                requests and 2 PNG requests over HTTP; every request succeeds
                with a finite mask of the right shape, K1 ran exactly 52
                times per batch served (3+6+40+3 layers), and the served
                masks agree with the plain path on the same inputs.
7. grad       - MiT-B5 512x512 float32, TF32 off, batch 2: the EMA step's
                student loss backward through the kernels and through the
                plain path give the same gradient for every parameter
                tensor, with K2 launched exactly 52 times.
8. train      - the EMA mean-teacher step at the flagship point (MiT-B5
                512x512 bf16, 32 labeled + 32 unlabeled images per step in
                2 microbatches) through the port bench's functions: 2
                warm-up and 4 timed steps with finite losses, K1 launched
                312 and K2 104 times per step, the teacher moved by exactly
                the EMA of the student, and two steps from one state through
                the kernels and through the plain path agreeing on the
                losses and kept counts.

Then the `kernels` summary line, the `nvidia-smi` name/power-limit line and,
last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import os
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
    sr_attention_bwd.launches = 0


def _counts():
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention,
        sr_attention_bwd,
    )

    return sr_attention.launches, sr_attention_bwd.launches


def phase_device():
    import torch

    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "nvidia_smi": nvidia_smi_line()})


def phase_build():
    from semisupervisedobjectdetection_torch.ops import _build
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        _BWD_SOURCE,
        _SOURCE,
        _bwd_lib,
        _lib,
    )

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        lib, bwd = [f.result() for f in [pool.submit(_lib),
                                         pool.submit(_bwd_lib)]]
    seconds = time.perf_counter() - t0
    for source in (_SOURCE, _BWD_SOURCE):
        info = _build.BUILD_INFO[source]
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln]
        # ptxas reports static shared memory only; the row kernels' is
        # dynamic
        smem_fn = lib.sr_attention_fwd_smem_bytes if source == _SOURCE \
            else bwd.sr_attention_bwd_smem_bytes
        smem = {f"nk{nk}_d64_{name}": smem_fn(nk, 64, elem)
                for nk in (256, 266) for name, elem in (("bf16", 2),
                                                        ("f32", 4))}
        emit({"phase": "build", "source": source,
              "seconds": round(seconds, 3),
              "nvcc_seconds": round(info["seconds"], 3), "ptxas": ptxas,
              "dynamic_smem_bytes": smem})


def _k1_cases():
    """(batch, shape, dtype) of the K1 checks: the stage shapes at the
    serving, student and teacher batches in bf16, at the serving batch in
    f32, and the prefix shapes at the serving batch."""
    cases = [(b, s, "bfloat16") for b in (BATCH, MICRO, TEACHER_BATCH)
             for s in STAGE_SHAPES]
    cases += [(BATCH, s, "float32") for s in STAGE_SHAPES]
    cases += [(BATCH, s, d) for s in PREFIX_SHAPES
              for d in ("bfloat16", "float32")]
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
    for b, shape, dtype_name in _k1_cases():
        nq, nk, c, h = shape
        dtype = getattr(torch, dtype_name)
        q, k, v = (torch.randn(b, n, c, device="cuda", generator=gen)
                   .to(dtype) for n in (nq, nk, nk))
        out = sr_attention(q, k, v, h)
        torch.cuda.synchronize()
        ref = sr_attention_reference(q, k, v, h)
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all().item()) \
            and err <= KERNEL_TOL[dtype_name]
        # the exact function in float64 (no bf16 rounding of p): an
        # independent check of both versions
        f64 = _attention_f64(q, k, v, h)
        err64 = (out.double() - f64).abs().max().item()
        del f64
        qs, ks, vs = (_heads(t, h) for t in (q, k, v))
        bound, by = attention_bound(b, nq, nk, c, dtype_name)
        row = {"phase": "kernel", "name": "sr_attention_fwd",
               "B": b, "Nq": nq, "Nk": nk, "C": c, "heads": h,
               "dtype": dtype_name, "max_abs_err": err,
               "tol": KERNEL_TOL[dtype_name], "ok": ok,
               "max_abs_err_vs_f64": err64,
               "ms": cuda_ms(lambda: sr_attention(q, k, v, h)),
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
    for shape in STAGE_SHAPES + PREFIX_SHAPES:
        nq, nk, c, h = shape
        for dtype_name in ("bfloat16", "float32"):
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
                   "dtype": dtype_name, "max_abs_err": max(errs),
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
        launches = _counts()[0]
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
    if batches < 1 or launches != per_forward * batches:
        raise AssertionError(f"{launches} kernel launches for {batches} "
                             f"batches; expected {per_forward} per batch")
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
        launches[impl] = _counts()
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
    k1, k2 = _counts()
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
    one_k1, one_k2 = _counts()
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
           "launches_k1": k1, "launches_k2": k2,
           "launches_per_step": [k1 / 4, k2 / 4],
           "launches_expected_per_step": [K1_PER_STEP, K2_PER_STEP],
           "losses_total_sup_selfsup_pseudo": losses, "n_kept": n_kept,
           "ema_max_abs_err": ema_err, "ema_step_launches": [one_k1, one_k2],
           "kernel_vs_plain_steps": compare,
           "loss_max_abs_diff": loss_diff, "loss_tol": TRAIN_LOSS_TOL,
           "kept_max_diff": kept_diff, "kept_tol": TRAIN_KEPT_TOL,
           "card": smi}
    emit(row)
    if (k1, k2) != (4 * K1_PER_STEP, 4 * K2_PER_STEP) or \
            (one_k1, one_k2) != (K1_PER_STEP, K2_PER_STEP):
        raise AssertionError(f"launches K1 {k1}, K2 {k2} in 4 steps, "
                             f"{one_k1}, {one_k2} in one: expected "
                             f"{K1_PER_STEP} and {K2_PER_STEP} per step")
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


def _stage_sum(rows, b, key, only_bytes=False):
    """Sum of `key` over one pass of the B5 stages in bf16 at batch b
    (depth launches per stage shape); with `only_bytes`, over the stages
    whose bound is the bytes."""
    per = {(r["B"], r["Nq"], r["Nk"], r["C"], r["heads"]): r for r in rows
           if r["dtype"] == "bfloat16"}
    return sum(d * per[(b,) + s][key] for d, s in zip(B5_DEPTHS, STAGE_SHAPES)
               if not only_bytes or per[(b,) + s]["bound_by"] == "bytes")


def _kernel_entry(rows, passes, **fields):
    """A `kernels` entry summed over `passes` ((batch, count) of B5 stage
    passes): ms, plain_ms, bound_ms, library_ms and what bounds the sum."""

    def total(key, only_bytes=False):
        return sum(n * _stage_sum(rows, b, key, only_bytes)
                   for b, n in passes)

    bound = total("bound_ms")
    return {**fields, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": bound,
            "bound_by": "bytes" if total("bound_ms", True) >= bound / 2
            else "operations",
            "library_ms": total("library_ms"), "ok": True}


def summary(k1_rows, k2_rows, train, serve):
    """The `kernels` line: each kernel's times, bound and plain/library
    times summed over one flagship EMA step (bf16, the B5 stage shapes at
    the batches the step runs), its launches in the train phase's 4 timed
    steps, and K1's serve numbers per batch-8 forward beside them."""
    src = "semisupervisedobjectdetection_torch/csrc/"
    tpu = "semisupervisedobjectdetection_tpu/ops/sr_attention.py"
    k1 = _kernel_entry(
        k1_rows, ((TEACHER_BATCH, ACCUM), (MICRO, 2 * ACCUM)),
        name="sr_attention_fwd", route="cuda",
        source=src + "sr_attention_fwd.cu", replaces=tpu + ":36",
        launches=train["launches_k1"],
        per="one flagship EMA step: 2 x (teacher forward at batch 32 + "
            "student forward and recompute at batch 16), B5 512x512 bf16, "
            f"{K1_PER_STEP} launches",
        launches_per="4 timed EMA steps")
    serve_entry = _kernel_entry(k1_rows, ((BATCH, 1),))
    k1.update({f"serve_{key}_per_forward": serve_entry[key]
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")})
    k1["serve_launches"] = serve["launches"]
    k2 = _kernel_entry(
        k2_rows, ((MICRO, ACCUM),),
        name="sr_attention_bwd", route="cuda",
        source=src + "sr_attention_bwd.cu", replaces=tpu + ":115",
        launches=train["launches_k2"],
        max_rel_err=max(r["rel_err"] for r in k2_rows),
        per="one flagship EMA step: 2 x the student backward at batch 16, "
            f"B5 512x512 bf16, {K2_PER_STEP} launches",
        launches_per="4 timed EMA steps")
    return [k1, k2]


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
                          ("train", lambda: phase_train(smi))):
            t = time.perf_counter()
            results[phase] = fn()
            seconds[phase] = round(time.perf_counter() - t, 2)
            emit({"phase": phase, "seconds": seconds[phase]})
        kernels = {"kernels": summary(results["kernel"],
                                      results["kernel_bwd"],
                                      results["train"], results["serve"])}
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
