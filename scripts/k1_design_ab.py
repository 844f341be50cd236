"""Time two builds of K1, the bf16 SR-attention forward
(`semisupervisedobjectdetection_torch/csrc/sr_attention_fwd.cu`), and of K2,
its backward (`csrc/sr_attention_bwd.cu`), on the same inputs with the same
two clocks, on one CUDA card.

    for f in sr_attention_fwd.cu sr_attention_bwd.cu sr_attention_wgmma.cuh; do
        git show <commit>:semisupervisedobjectdetection_torch/csrc/$f \
            > build/k1_ab/$f; done
    # (3c385da and earlier: sr_attention_mma.cuh, not sr_attention_wgmma.cuh)
    python3 scripts/k1_design_ab.py --other build/k1_ab/sr_attention_fwd.cu \
        [--bwd build/k1_ab/sr_attention_bwd.cu] [--other-name mma.sync] \
        [--out chiprun_out/k1_ab.jsonl]

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

With `--bwd`, a backward source is built the same way and timed against
the package's `sr_attention_bwd` at the MiT-B5 stage shapes at the student
batch (16), other, this, this, other, with the autograd backward of SDPA
beside them. A source with the package's C interface (it exports
`sr_attention_bwd_wgmma`, as K2 has since its wgmma design) is called
through the package's own wrapper, like `--other`; a source of the
`mma.sync` design before it (commit 3c385da and earlier: bf16 through
`sr_attention_bwd(q, k, v, g, dq, dk, dv, stats, part, b, nq, nk, c, heads,
dtype, block_q, splits, stream)`, the key pass over `parent_key_splits`
splits of the query rows) as its own wrapper called it. Each design's
(dq, dk, dv) is held to the plain version at chip_smoke's
`KERNEL_BWD_TOL`; the sums are per flagship EMA step (104 launches).
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
    KERNEL_BWD_TOL,
    KERNEL_TOL,
    MICRO,
    SEED,
    STAGE_SHAPES,
    TEACHER_BATCH,
    _heads,
    _rel_err,
    attention_bound,
    attention_bwd_bound,
    cuda_ms,
    host_us,
)

# (batch, passes over the B5 stages) of one flagship EMA step and of one
# serve forward; of K2 in one flagship EMA step (the student's backward of
# each microbatch).
EMA_STEP = ((TEACHER_BATCH, ACCUM), (MICRO, 2 * ACCUM))
SERVE_FORWARD = ((BATCH, 1),)
BWD_EMA_STEP = ((MICRO, ACCUM),)
# The earlier bf16 K2's key pass: 64-key blocks, 64-row tiles, ~264 blocks.
PARENT_KEYS, PARENT_TILE, PARENT_BLOCKS = 64, 64, 264


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


def _nvcc(src: Path) -> ctypes.CDLL:
    """`src` built with the package's nvcc flags beside itself, loaded."""
    from semisupervisedobjectdetection_torch.ops import _build

    out = src.with_suffix(".so")
    cmd = [_build.nvcc_path(), *_build.FLAGS, "-I", str(src.parent),
           "-I", str(_build.CSRC), "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


def build_other_bwd(src: Path) -> ctypes.CDLL:
    """The backward `src`, built and loaded with its C signatures: the
    package's, or those of the `mma.sync` design."""
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        declare_bwd,
    )

    lib = _nvcc(src)
    if hasattr(lib, "sr_attention_bwd_wgmma"):
        return declare_bwd(lib)
    lib.sr_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.sr_attention_bwd.restype = ctypes.c_int
    return lib


def parent_key_splits(b: int, nq: int, nk: int, heads: int) -> int:
    """The earlier bf16 K2's query-row splits of its key pass."""
    blocks = -(-nk // PARENT_KEYS) * b * heads
    want = -(-PARENT_BLOCKS // blocks)
    rows = -(-(-(-nq // want)) // PARENT_TILE) * PARENT_TILE
    return -(-nq // rows)


def parent_bwd(lib, q, k, v, g, heads: int):
    """(dq, dk, dv) by the `mma.sync` bf16 K2 `lib`, called as its wrapper
    called it (row statistics and split partials in float32 workspaces)."""
    import torch

    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        BLOCK_Q,
        _launch,
    )

    b, nq, c = q.shape
    nk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    stats = torch.empty(b * heads * nq * 4, dtype=torch.float32,
                        device=q.device)
    splits = parent_key_splits(b, nq, nk, heads)
    part = torch.empty(splits * 2 * k.numel() if splits > 1 else 0,
                       dtype=torch.float32, device=q.device)
    err = _launch(lib.sr_attention_bwd, q.device, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), stats.data_ptr(),
                  part.data_ptr() if splits > 1 else None, b, nq, nk, c,
                  heads, 1, BLOCK_Q, splits)
    if err:
        raise RuntimeError(f"earlier sr_attention_bwd failed: {err}")
    return dq, dk, dv


def build_other(src: Path) -> ctypes.CDLL:
    """The forward `src`, built and loaded with its C signatures."""
    lib = _nvcc(src)
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
def using(lib, bwd: bool = False):
    """`sr_attention` (with `bwd`, `sr_attention_bwd`) launches from `lib`
    inside the block (None: the package's own build)."""
    from semisupervisedobjectdetection_torch.ops import sr_attention as sra

    name, limits = (("_bwd_lib", sra._bwd_limits) if bwd
                    else ("_lib", sra._fwd_limits))
    own = getattr(sra, name)
    if lib is not None:
        setattr(sra, name, lambda: lib)
    limits.cache_clear()
    try:
        yield
    finally:
        setattr(sra, name, own)
        limits.cache_clear()


def _sum(rows, passes, design, key):
    per = {(r["B"],) + tuple(r["shape"]): r for r in rows}
    return sum(n * d * per[(b,) + s][design][key] for b, n in passes
               for d, s in zip(B5_DEPTHS, STAGE_SHAPES))


def _bound_sum(passes, bound=attention_bound):
    return sum(n * d * bound(b, *s[:3], "bfloat16")[0]
               for b, n in passes for d, s in zip(B5_DEPTHS, STAGE_SHAPES))


def _bwd_rows(other, name: str):
    """K2 at the stage shapes at the student batch: the build `other` and
    the package's, other, this, this, other, and SDPA's autograd backward;
    one row each."""
    import torch
    import torch.nn.functional as F

    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention_backward_reference,
        sr_attention_bwd,
    )

    current = hasattr(other, "sr_attention_bwd_wgmma")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, bad = [], []
    for nq, nk, c, h in STAGE_SHAPES:
        b = MICRO
        q, k, v, g = (torch.randn(b, n, c, device="cuda", generator=gen)
                      .to(torch.bfloat16) for n in (nq, nk, nk, nq))
        ref = sr_attention_backward_reference(q, k, v, g, h)
        row = {"B": b, "shape": [nq, nk, c, h]}

        def timed(fn, n):
            err = _rel_err(fn(), ref)
            return {"rel_err": err,
                    "device_ms": [cuda_ms(fn, iters=10) for _ in range(n)],
                    "host_paced_ms": [host_paced_ms(fn, iters=10)
                                      for _ in range(n)],
                    "host_us": host_us(fn, iters=20)}

        def theirs():
            if current:
                return sr_attention_bwd(q, k, v, g, h)
            return parent_bwd(other, q, k, v, g, h)

        def ours():
            return sr_attention_bwd(q, k, v, g, h)

        with using(other if current else None, bwd=True):
            first = timed(theirs, 1)
        mine = timed(ours, 2)
        with using(other if current else None, bwd=True):
            last = timed(theirs, 1)
        row[name] = {
            "rel_err": max(first["rel_err"], last["rel_err"]),
            "device_ms": first["device_ms"] + last["device_ms"],
            "host_paced_ms": first["host_paced_ms"] + last["host_paced_ms"],
            "host_us": [first["host_us"], last["host_us"]]}
        row["this"] = mine
        qs, ks, vs = (_heads(t, h).detach().requires_grad_()
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qs, ks, vs)
        gs = _heads(g, h)

        def sdpa():
            return torch.autograd.grad(out, (qs, ks, vs), gs,
                                       retain_graph=True)

        row["sdpa"] = {"device_ms": [cuda_ms(sdpa, iters=10)],
                       "host_paced_ms": [host_paced_ms(sdpa, iters=10)]}
        for key, r in row.items():
            if isinstance(r, dict):
                for clock in ("device_ms", "host_paced_ms"):
                    r[clock + "_mean"] = sum(r[clock]) / len(r[clock])
                if r.get("rel_err", 0.0) > KERNEL_BWD_TOL["bfloat16"]:
                    bad.append((b, nq, key, r["rel_err"]))
        row["bound_ms"] = attention_bwd_bound(b, nq, nk, c, "bfloat16")[0]
        chip_smoke.emit(row)
        rows.append(row)
        del q, k, v, g, ref, qs, ks, vs, out, gs
    return rows, bad


def _fwd_rows(other, name: str):
    """K1 at the stage shapes at the EMA step's and the serve forward's
    batches: the earlier build `other` and the package's, other, this,
    this, other; at the serve batch the scalar kernel; SDPA beside them."""
    import torch
    import torch.nn.functional as F

    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        _lib,
        sr_attention,
        sr_attention_reference,
    )

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
        row[name] = {
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
        for design, r in row.items():
            if isinstance(r, dict):
                for key in ("device_ms", "host_paced_ms"):
                    r[key + "_mean"] = sum(r[key]) / len(r[key])
                if r.get("max_abs_err", 0.0) > KERNEL_TOL["bfloat16"]:
                    bad.append((b, nq, design, r["max_abs_err"]))
        row["bound_ms"] = attention_bound(b, nq, nk, c, "bfloat16")[0]
        chip_smoke.emit(row)
        rows.append(row)
        del q, k, v, ref, qs, ks, vs
    return rows, bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", type=Path, default=None)
    p.add_argument("--bwd", type=Path, default=None)
    p.add_argument("--other-name", default="other")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_design_ab: no CUDA device", file=sys.stderr)
        return 2
    rows, bad, sums = [], [], {}
    designs = (args.other_name, "this", "sdpa")
    if args.other is not None:
        rows, bad = _fwd_rows(build_other(args.other.resolve()),
                              args.other_name)
        for label, passes, names in (
                ("per_ema_step", EMA_STEP, designs),
                ("per_serve_forward", SERVE_FORWARD,
                 designs + ("scalar",))):
            sums[label] = {"bound_ms": _bound_sum(passes), **{
                name: {key: _sum(rows, passes, name, key + "_mean")
                       for key in ("device_ms", "host_paced_ms")}
                for name in names}}
    if args.bwd is not None:
        bwd_rows, bwd_bad = _bwd_rows(build_other_bwd(args.bwd.resolve()),
                                      args.other_name)
        rows += bwd_rows
        bad += bwd_bad
        sums["bwd_per_ema_step"] = {
            "bound_ms": _bound_sum(BWD_EMA_STEP, attention_bwd_bound), **{
                name: {key: _sum(bwd_rows, BWD_EMA_STEP, name, key + "_mean")
                       for key in ("device_ms", "host_paced_ms")}
                for name in designs}}
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
