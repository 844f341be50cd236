"""Time two builds of K1, the bf16 SR-attention forward
(`semisupervisedobjectdetection_torch/csrc/sr_attention_fwd.cu`), on the
same inputs with the same two clocks, on one CUDA card.

    git show <commit>:semisupervisedobjectdetection_torch/csrc/sr_attention_fwd.cu \
        > build/k1_ab/sr_attention_fwd.cu
    python3 scripts/k1_design_ab.py --other build/k1_ab/sr_attention_fwd.cu \
        [--other-name mma.sync] [--out chiprun_out/k1_ab.jsonl]

`--other` is a forward source with the package's C interface
(`sr_attention_fwd(q, k, v, out, b, nq, nk, c, heads, dtype, block_q, mma,
stream)`), such as an earlier commit's; it is built with the package's nvcc
flags, its local headers found beside it or in the package's `csrc/`. Both
builds are called through the package's own `sr_attention` wrapper with
`mma=True`, so the host path of a call is the same for both.

At each MiT-B5 512x512 stage shape at the batches of one flagship EMA step
(teacher 32, student 16) and of one serve forward (8), in the order other,
this, this, other, each design is timed by two clocks:

- `device_ms`: chip_smoke's `cuda_ms`, whose timed calls are queued behind
  a sleep kernel, so that CUDA events see the device run them back to back;
- `host_paced_ms`: the same events without the sleep (chip_smoke's clock
  before the sleep was added), which read the host's pace of issuing the
  calls where a call's host cost exceeds its kernel.

`F.scaled_dot_product_attention` (a yardstick only) and, at the serve
batch, the package's scalar kernel (`mma=False`) are timed by both clocks
too; `host_us` is the host microseconds of one call. Each design's output
is held to the plain version at chip_smoke's `KERNEL_TOL`. Prints one JSON
line per shape, then one with the sums per EMA step (312 launches) and per
serve forward (52 launches) beside chip_smoke's bound, then the card's name
and power limit. Exits 2 without a card, 1 if an output disagrees.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import (  # noqa: E402
    ACCUM,
    B5_DEPTHS,
    BATCH,
    KERNEL_TOL,
    MICRO,
    SEED,
    STAGE_SHAPES,
    TEACHER_BATCH,
    _heads,
    attention_bound,
    cuda_ms,
    host_us,
)

# (batch, passes over the B5 stages) of one flagship EMA step and of one
# serve forward.
EMA_STEP = ((TEACHER_BATCH, ACCUM), (MICRO, 2 * ACCUM))
SERVE_FORWARD = ((BATCH, 1),)


def host_paced_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms between CUDA events around `iters` calls of `fn()` issued
    with nothing queued before them: where a call's host cost exceeds its
    kernel, the events read the host's pace."""
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


def build_other(src: Path) -> ctypes.CDLL:
    """`src` built with the package's nvcc flags beside itself, loaded."""
    from semisupervisedobjectdetection_torch.ops import _build

    out = src.with_suffix(".so")
    cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(src.parent),
           "-I", str(_build.CSRC), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.sr_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.sr_attention_fwd.restype = ctypes.c_int
    lib.sr_attention_fwd_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.sr_attention_fwd_smem_bytes.restype = ctypes.c_size_t
    lib.sr_attention_fwd_max_nk.argtypes = []
    lib.sr_attention_fwd_max_nk.restype = ctypes.c_int
    lib.sr_attention_fwd_error_string.argtypes = [ctypes.c_int]
    lib.sr_attention_fwd_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def using(lib):
    """`sr_attention` launches from `lib` inside the block (None: the
    package's own build)."""
    from semisupervisedobjectdetection_torch.ops import sr_attention as sra

    own = sra._lib
    if lib is not None:
        sra._lib = lambda: lib
    sra._fwd_limits.cache_clear()
    try:
        yield
    finally:
        sra._lib = own
        sra._fwd_limits.cache_clear()


def _sum(rows, passes, design, key):
    per = {(r["B"],) + tuple(r["shape"]): r for r in rows}
    return sum(n * d * per[(b,) + s][design][key] for b, n in passes
               for d, s in zip(B5_DEPTHS, STAGE_SHAPES))


def _bound_sum(passes):
    return sum(n * d * attention_bound(b, *s[:3], "bfloat16")[0]
               for b, n in passes for d, s in zip(B5_DEPTHS, STAGE_SHAPES))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True, type=Path)
    p.add_argument("--other-name", default="other")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k1_design_ab: no CUDA device", file=sys.stderr)
        return 2
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        _lib,
        sr_attention,
        sr_attention_reference,
    )

    other = build_other(args.other.resolve())
    _lib()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = [(b, s) for b in (TEACHER_BATCH, MICRO, BATCH)
             for s in STAGE_SHAPES]
    rows, bad = [], []
    for b, (nq, nk, c, h) in cases:
        q, k, v = (torch.randn(b, n, c, device="cuda", generator=gen)
                   .to(torch.bfloat16) for n in (nq, nk, nk))
        ref = sr_attention_reference(q, k, v, h)
        qs, ks, vs = (_heads(t, h) for t in (q, k, v))
        row = {"B": b, "shape": [nq, nk, c, h]}

        def timed(lib, mma, n):
            with using(lib):
                out = sr_attention(q, k, v, h, mma)
                err = (out.float() - ref.float()).abs().max().item()
                return {"max_abs_err": err,
                        "device_ms": [cuda_ms(
                            lambda: sr_attention(q, k, v, h, mma))
                            for _ in range(n)],
                        "host_paced_ms": [host_paced_ms(
                            lambda: sr_attention(q, k, v, h, mma))
                            for _ in range(n)],
                        "host_us": host_us(
                            lambda: sr_attention(q, k, v, h, mma))}

        first = timed(other, True, 1)
        mine = timed(None, True, 2)
        last = timed(other, True, 1)
        row[args.other_name] = {
            "max_abs_err": max(first["max_abs_err"], last["max_abs_err"]),
            "device_ms": first["device_ms"] + last["device_ms"],
            "host_paced_ms": first["host_paced_ms"] + last["host_paced_ms"],
            "host_us": [first["host_us"], last["host_us"]]}
        row["this"] = mine
        if b == BATCH:
            row["scalar"] = timed(None, False, 1)

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs)

        row["sdpa"] = {"device_ms": [cuda_ms(sdpa)],
                       "host_paced_ms": [host_paced_ms(sdpa)]}
        for name, r in row.items():
            if isinstance(r, dict):
                for key in ("device_ms", "host_paced_ms"):
                    r[key + "_mean"] = sum(r[key]) / len(r[key])
                if r.get("max_abs_err", 0.0) > KERNEL_TOL["bfloat16"]:
                    bad.append((b, nq, name, r["max_abs_err"]))
        row["bound_ms"] = attention_bound(b, nq, nk, c, "bfloat16")[0]
        chip_smoke.emit(row)
        rows.append(row)
        del q, k, v, ref, qs, ks, vs
    designs = (args.other_name, "this", "sdpa")
    sums = {}
    for label, passes, names in (
            ("per_ema_step", EMA_STEP, designs),
            ("per_serve_forward", SERVE_FORWARD, designs + ("scalar",))):
        sums[label] = {"bound_ms": _bound_sum(passes), **{
            name: {key: _sum(rows, passes, name, key + "_mean")
                   for key in ("device_ms", "host_paced_ms")}
            for name in names}}
    sums["card"] = chip_smoke.nvidia_smi_line()
    chip_smoke.emit({"k1_ab": sums})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n"
                                    for r in rows + [{"k1_ab": sums}]))
    print(sums["card"], flush=True)
    if bad:
        print(f"k1_design_ab: outputs off the plain version: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
