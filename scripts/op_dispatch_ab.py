"""Time the host cost of a K1 and a K2 call (the SR-attention forward and
backward) through one checkout's package, and the serve predict and the EMA
step around them, on one CUDA card: run it once per checkout, in the order
parent, change, change, parent, to compare two ways of calling the kernels
on one card.

    mkdir -p build/ab/parent
    git archive <commit> semisupervisedobjectdetection_torch \\
        | tar -x -C build/ab/parent
    python3 scripts/op_dispatch_ab.py --root build/ab/parent --name parent \\
        [--out chiprun_out/op_dispatch_ab.jsonl]
    python3 scripts/op_dispatch_ab.py --root . --name change \\
        [--artifact-profile]

`--root` is the directory holding the `semisupervisedobjectdetection_torch`
package to time; its kernels are built from its own `csrc/` into its own
`build/kernels/`. Prints one JSON line per measurement, each with the
checkout's name:

- `calls`: host microseconds per call (a loop of calls, the device queue
  left to run behind it, as chip_smoke's `host_us`), the median over 5
  loops, at each MiT-B5 512x512 stage shape in bfloat16: K1 under
  `torch.inference_mode()` at batch 8 (the serve predict's call), K1 with
  inputs that want a gradient at batch 16 (a training forward's), the
  forward and its backward through autograd at batch 16 (a training
  layer's K1 and K2), and K2 called directly at batch 16;
- `predict`: host milliseconds of `SegFormerModel.predict` on 8 seeded
  512x512 images at MiT-B5 bf16 (each call ended by the copy to the host),
  every call's and their median;
- `ema_step`: milliseconds of bench.py's EMA step at its flagship point
  (MiT-B5 512x512 bf16, 2 microbatches of 16), each step ended by reading
  its loss, every step's and their median;
- with `--artifact-profile`: the same predict through a serving artifact
  of the same model (`export_serving`, the cuda program) beside `predict`:
  host ms per call of each, then `torch.profiler`'s host-side table over 3
  calls of each (events per call, the ops with the most host time), and
  the artifact graph's nodes by target.

Then the card's name and power limit. Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

SEED, IMG, BATCH, MICRO = 0, 512, 8, 16
DEVICE = "cuda"
# MiT-B5 at 512x512: (Nq, Nk, C, heads) of each stage's SR-attention.
STAGE_SHAPES = ((16384, 256, 64, 1), (4096, 256, 128, 2),
                (1024, 256, 320, 5), (256, 256, 512, 8))


def _emit(row: dict, out) -> None:
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def _host_us(torch, fn, n: int = 50, loops: int = 5) -> float:
    """Median over `loops` of the host microseconds per call of `n` calls
    of `fn` issued back to back (the device synchronised before and after
    each loop, outside its time)."""
    fn()
    times = []
    for _ in range(loops):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def time_calls(torch, sra) -> list:
    rows = []
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    for nq, nk, c, h in STAGE_SHAPES:
        def make(b, n):
            return torch.randn(b, n, c, device=DEVICE, generator=gen,
                               dtype=torch.bfloat16)

        q, k, v = make(BATCH, nq), make(BATCH, nk), make(BATCH, nk)
        with torch.inference_mode():
            infer = _host_us(torch, lambda: sra.sr_attention(q, k, v, h))
        q, k, v, g = make(MICRO, nq), make(MICRO, nk), make(MICRO, nk), \
            make(MICRO, nq)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fwd_grad = _host_us(torch, lambda: sra.sr_attention(*leaves, h))

        def pair():
            sra.sr_attention(*leaves, h).backward(g)

        pair_us = _host_us(torch, pair, n=20)
        k2 = _host_us(torch, lambda: sra.sr_attention_bwd(q, k, v, g, h))
        rows.append({"Nq": nq, "Nk": nk, "C": c, "heads": h,
                     "k1_inference_us": infer, "k1_grad_us": fwd_grad,
                     "k1_k2_pair_us": pair_us, "k2_us": k2})
        del q, k, v, g, leaves
    return rows


def time_predict(torch, model, x, calls: int = 10) -> list:
    for _ in range(2):
        model.predict(x)
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(x)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def time_ema(torch, bench, steps: int = 3) -> list:
    w = bench.make_workload(bench.flagship_config(), 2 * MICRO, IMG, 2,
                            torch.device("cuda"))
    float(w.step().student_loss_total)
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(w.step().student_loss_total)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def host_profile(torch, fn, calls: int = 3, top: int = 12) -> dict:
    """torch.profiler's host-side events over `calls` calls of `fn`: events
    per call and the `top` ops by self host time (us per call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    ranked = sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"events_per_call": sum(e.count for e in avgs) / calls,
            "self_host_us_per_call": sum(e.self_cpu_time_total
                                         for e in avgs) / calls,
            "top": [{"name": e.key, "calls": e.count / calls,
                     "self_us": e.self_cpu_time_total / calls}
                    for e in ranked[:top]]}


def artifact_profile(torch, model, x) -> dict:
    import tempfile

    from semisupervisedobjectdetection_torch.checkpoint.serving_export \
        import load_serving

    path = os.path.join(tempfile.mkdtemp(prefix="op_dispatch_ab_"),
                        "b5.ssod")
    try:
        model.export_serving(path, batch_size=BATCH, img_size=IMG,
                             platforms=(DEVICE,))
        pred = load_serving(path, DEVICE)
    finally:
        if os.path.exists(path):
            os.remove(path)
    nodes = Counter(str(n.target) for n in pred._module.graph.nodes
                    if n.op == "call_function")
    return {"artifact_host_ms": time_predict(torch, pred, x),
            "predict_host_ms": time_predict(torch, model, x),
            "artifact_profile": host_profile(torch, lambda: pred.predict(x)),
            "predict_profile": host_profile(torch, lambda: model.predict(x)),
            "artifact_graph_nodes": sum(nodes.values()),
            "artifact_graph_top": nodes.most_common(15)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", required=True,
                   help="directory holding the package to time")
    p.add_argument("--name", required=True, help="the checkout's name")
    p.add_argument("--artifact-profile", action="store_true")
    p.add_argument("--out", default=None, help="also append the lines here")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("op_dispatch_ab: no CUDA card", file=sys.stderr)
        return 2
    from semisupervisedobjectdetection_torch import bench
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import mit_b5
    from semisupervisedobjectdetection_torch.ops import sr_attention as sra

    pkg = os.path.dirname(os.path.abspath(sra.__file__))
    if not pkg.startswith(root + os.sep):
        print(f"op_dispatch_ab: imported {pkg}, not under {root}",
              file=sys.stderr)
        return 1
    out = open(args.out, "a") if args.out else None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = {"name": args.name, "root": args.root,
            "operators": hasattr(torch.ops.ssod, "sr_attention_fwd")}
    rows = time_calls(torch, sra)
    _emit({**base, "what": "calls", "rows": rows,
           **{f"median_{k}": statistics.median(r[k] for r in rows)
              for k in ("k1_inference_us", "k1_grad_us", "k1_k2_pair_us",
                        "k2_us")}}, out)
    model = SegFormerModel(config=mit_b5(dtype="bfloat16", gelu_approx=True),
                           seed=SEED)
    x = np.random.default_rng(SEED + 30).uniform(
        size=(BATCH, IMG, IMG, 3)).astype(np.float32)
    times = time_predict(torch, model, x)
    _emit({**base, "what": "predict", "host_ms": times,
           "median_ms": statistics.median(times)}, out)
    if args.artifact_profile:
        _emit({**base, "what": "artifact_profile",
               **artifact_profile(torch, model, x)}, out)
    del model
    torch.cuda.empty_cache()
    times = time_ema(torch, bench)
    _emit({**base, "what": "ema_step", "ms": times,
           "median_ms": statistics.median(times)}, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _emit({**base, "what": "card", "card": smi}, out)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
