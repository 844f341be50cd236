#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure exits non-zero before
the final line:

1. device  - the card's name, count and power limit (no CUDA: exit 2).
2. build   - compile every kernel of the serving path from `csrc/` (the
             `-Xptxas -v` register/shared-memory summary is printed).
3. kernel  - `sr_attention_fwd` against its plain PyTorch version at the
             four MiT-B5 512x512 stage shapes at batch 8 and two shapes
             with a prompt/CLS prefix, in bfloat16 and float32: max abs
             error against a stated tolerance, and CUDA-event times of the
             kernel, the plain version and `F.scaled_dot_product_attention`
             (a yardstick only; the port never calls it), beside the bound
             from shapes (each byte in and out once at 3.35 TB/s; flops at
             989 TFLOP/s bf16, 67 TFLOP/s f32).
4. model   - MiT-B5 at 512x512 in float32, TF32 off: the kernel path and
             the plain path agree on a batch of two images.
5. serve   - the port's InferenceServer (MiT-B5, 512x512, bfloat16,
             max_batch 8, seeded random weights) answers 16 concurrent raw
             requests and 2 PNG requests over HTTP; every request succeeds
             with a finite mask of the right shape, the kernel ran exactly
             52 times per batch served (3+6+40+3 layers), and the served
             masks agree with the plain path on the same inputs.

Then the `kernels` summary line, the `nvidia-smi` name/power-limit line and,
last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
SEED = 0
BATCH = 8
IMG = 512
B5_DEPTHS = (3, 6, 40, 3)
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
# B5 in float32 through 52 layers: kernel vs plain mask probabilities.
MODEL_F32_TOL = 1e-4
# B5 in bfloat16: every layer rounds to bf16, so one-ulp differences in
# attention outputs travel through 52 residual layers; the probabilities
# are compared with this bound and the 0.5-thresholded masks must agree
# on all but this share of pixels.
SERVE_PROB_TOL = 5e-2
SERVE_MASK_DISAGREE = 1e-3


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


def attention_bound(b, nq, nk, c, dtype_name):
    """(bound ms, "bytes" or "operations") of SR-attention at a shape:
    q, k, v read once and the output written once; 4*B*Nq*Nk*C flops at
    the dtype's peak (tensor-core bf16, or float32 outside the tensor
    cores)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    peak = 989e12 if dtype_name == "bfloat16" else 67e12
    t_bytes = (2 * b * nq * c + 2 * b * nk * c) * elem / PEAK_BYTES_PER_S
    t_ops = 4 * b * nq * nk * c / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _attention_f64(q, k, v, h):
    import torch

    b, nq, c = q.shape
    d = c // h
    qh, kh, vh = (t.double().reshape(b, -1, h, d) for t in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) / d ** 0.5,
                      dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, nq, c)


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
        _SOURCE,
        _lib,
    )

    t0 = time.perf_counter()
    lib = _lib()
    info = _build.BUILD_INFO[_SOURCE]
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    # ptxas reports static shared memory only; the kernel's is dynamic
    smem = {f"nk{nk}_d64_{name}": lib.sr_attention_fwd_smem_bytes(nk, 64,
                                                                  elem)
            for nk in (256, 266) for name, elem in (("bf16", 2),
                                                    ("f32", 4))}
    emit({"phase": "build", "source": _SOURCE,
          "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": round(info["seconds"], 3), "ptxas": ptxas,
          "dynamic_smem_bytes": smem})


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
    for shape in STAGE_SHAPES + PREFIX_SHAPES:
        nq, nk, c, h = shape
        for dtype_name in ("bfloat16", "float32"):
            dtype = getattr(torch, dtype_name)
            q, k, v = (torch.randn(BATCH, n, c, device="cuda", generator=gen)
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
            qs, ks, vs = (t.view(BATCH, -1, h, c // h).transpose(1, 2)
                          for t in (q, k, v))
            bound, by = attention_bound(BATCH, nq, nk, c, dtype_name)
            row = {"phase": "kernel", "name": "sr_attention_fwd",
                   "B": BATCH, "Nq": nq, "Nk": nk, "C": c, "heads": h,
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
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{bad}")
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
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention,
    )

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
        sr_attention.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_raw + 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = sr_attention.launches
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


def summary(rows, serve):
    """The `kernels` line: the kernel's times, bound and plain/library
    times summed over one batch-8 MiT-B5 512x512 bf16 forward (its 52
    launches at the four stage shapes)."""
    per = {(r["Nq"], r["Nk"], r["C"], r["heads"]): r for r in rows
           if r["dtype"] == "bfloat16"}
    stage = [per[s] for s in STAGE_SHAPES]

    def total(key):
        return sum(d * r[key] for d, r in zip(B5_DEPTHS, stage))

    by_bytes = sum(d * r["bound_ms"] for d, r in zip(B5_DEPTHS, stage)
                   if r["bound_by"] == "bytes")
    return {"name": "sr_attention_fwd", "route": "cuda",
            "source": "semisupervisedobjectdetection_torch/csrc/"
                      "sr_attention_fwd.cu",
            "replaces": "semisupervisedobjectdetection_tpu/ops/"
                        "sr_attention.py:36",
            "launches": serve["launches"],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_err": max(r["max_abs_err"] for r in rows),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": "bytes" if by_bytes >= total("bound_ms") / 2
            else "operations",
            "library_ms": total("library_ms"),
            "per": "one batch-8 MiT-B5 512x512 bf16 forward "
                   "(3+6+40+3 launches)",
            "ok": True}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import semisupervisedobjectdetection_torch  # noqa: F401 (fails alone)

    phase = "device"
    try:
        phase_device()
        smi = nvidia_smi_line()
        phase = "build"
        phase_build()
        phase = "kernel"
        rows = phase_kernel()
        phase = "model"
        phase_model_f32()
        phase = "serve"
        serve = phase_serve(smi)
        kernels = {"kernels": [summary(rows, serve)]}
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
