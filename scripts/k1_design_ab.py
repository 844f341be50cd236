"""Time two builds of K1, the SR-attention forward
(`semisupervisedobjectdetection_torch/csrc/sr_attention_fwd.cu`), and of K2,
its backward (`csrc/sr_attention_bwd.cu`), on the same inputs with the same
two clocks, on one CUDA card.

    mkdir -p build/k1_ab
    for f in sr_attention_fwd.cu sr_attention_bwd.cu sr_attention_wgmma.cuh; do
        git show <commit>:semisupervisedobjectdetection_torch/csrc/$f \\
            > build/k1_ab/$f; done
    python3 scripts/k1_design_ab.py --other build/k1_ab [--bwd] \\
        [--dtype float32|bfloat16] [--other-name parent] \\
        [--out chiprun_out/k1_ab.jsonl]

`--other` is a directory holding an earlier commit's two sources and their
header; both are built with the package's nvcc flags. A build with the
package's C interface is called through the package's own wrappers, like
the package's build; a build with the C interface of commit d7bb129
(`sr_attention_fwd(q, k, v, out, b, nq, nk, c, heads, dtype, block_q, mma,
stream)`, whose float32 kernels are scalar, and `sr_attention_bwd(q, k, v,
g, dq, dk, dv, stats, part, b, nq, nk, c, heads, block_q, splits,
launched, stream)`, its float32 key pass over `d7bb129_key_splits` splits)
is called as that commit's wrapper called it.

At each MiT-B5 512x512 stage shape and each few-shot shape (a CLS query row
and key per stage, batch 2: Nq = H*W + 1, Nk 257), in the order other,
this, this, other, each design is timed by two clocks:

- `device_ms`: chip_smoke's `cuda_ms`, whose timed calls are queued behind
  a sleep kernel, so that CUDA events see the device run them back to back;
- `host_paced_ms`: the same events without the sleep, which read the host's
  pace of issuing the calls where a call's host cost exceeds its kernel.

The plain version and `F.scaled_dot_product_attention` (forward, or its
autograd backward with `--bwd`; a yardstick only) are timed beside them;
`host_us` is the host microseconds of one call. Each design's output is
held to the plain version at chip_smoke's `KERNEL_TOL` (`KERNEL_BWD_TOL`).
The stage shapes run at the batch of a serve forward (8) for K1 and of a
student microbatch (16) for K2. Prints one JSON line per shape, then one
with the sums per few-shot pass (K1: one float32 forward, 52 launches; K2:
one few-shot pair loss's backward, 2 x 52 launches) and per stage pass,
beside chip_smoke's bound, then the card's name and power limit. Exits 2
without a card, 1 if an output disagrees.
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
    B5_DEPTHS,
    BATCH,
    FEW_BATCH,
    FEWSHOT_SHAPES,
    KERNEL_BWD_TOL,
    KERNEL_TOL,
    MICRO,
    SEED,
    STAGE_SHAPES,
    _heads,
    _rel_err,
    attention_bound,
    attention_bwd_bound,
    cuda_ms,
    host_us,
)

# d7bb129's float32 backward: a key pass of 32-key blocks over 32-row query
# tiles, split so that about 528 blocks run; its scalar kernels' query
# block.
D7BB129_KEYS, D7BB129_TILE, D7BB129_BLOCKS, D7BB129_BLOCK_Q = 32, 32, 528, 128


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
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


class Other:
    """An earlier build of both sources and how to call it."""

    def __init__(self, folder: Path):
        from semisupervisedobjectdetection_torch.ops.sr_attention import (
            declare_bwd,
            declare_fwd,
        )

        self.fwd = _nvcc(folder / "sr_attention_fwd.cu")
        self.bwd_lib = _nvcc(folder / "sr_attention_bwd.cu")
        # d7bb129's forward exports the tensor-map timer this one dropped
        self.d7bb129 = hasattr(self.fwd, "sr_attention_fwd_map_ns")
        if self.d7bb129:
            self.fwd.sr_attention_fwd.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                + [ctypes.c_void_p])
            self.fwd.sr_attention_fwd.restype = ctypes.c_int
            self.bwd_lib.sr_attention_bwd.argtypes = (
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
            self.bwd_lib.sr_attention_bwd.restype = ctypes.c_int
            self.bwd_lib.sr_attention_bwd_wgmma.argtypes = (
                [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
            self.bwd_lib.sr_attention_bwd_wgmma.restype = ctypes.c_int
        else:
            declare_fwd(self.fwd)
            declare_bwd(self.bwd_lib)

    def attention(self, q, k, v, h):
        import torch

        from semisupervisedobjectdetection_torch.ops import sr_attention as s

        if not self.d7bb129:
            with using(self.fwd):
                return s.sr_attention(q, k, v, h)
        b, nq, c = q.shape
        out = q.new_empty(q.shape)
        bf16 = int(q.dtype == torch.bfloat16)
        err = s._launch(self.fwd.sr_attention_fwd, q.device, q.data_ptr(),
                        k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq,
                        k.shape[1], c, h, bf16, D7BB129_BLOCK_Q, bf16)
        if err:
            raise RuntimeError(f"earlier sr_attention_fwd failed: {err}")
        return out

    def backward(self, q, k, v, g, h):
        import torch

        from semisupervisedobjectdetection_torch.ops import sr_attention as s

        if not self.d7bb129:
            with using(self.bwd_lib, bwd=True):
                return s.sr_attention_bwd(q, k, v, g, h)
        b, nq, c = q.shape
        nk = k.shape[1]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        launched = ctypes.c_int(0)
        if q.dtype == torch.bfloat16:
            plan = s.bwd_launch_plan(b, nq, nk, c, h, s._sm_count(0))
            part = torch.empty(plan["workspace_floats"], device=q.device)
            err = s._launch(self.bwd_lib.sr_attention_bwd_wgmma, q.device,
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(),
                            part.data_ptr() if plan["split"] else None, b,
                            nq, nk, c, h, plan["grid"],
                            ctypes.byref(launched))
        else:
            stats = torch.empty(b * h * nq * 3, device=q.device)
            splits = d7bb129_key_splits(b, nq, nk, h)
            part = torch.empty(splits * 2 * k.numel() if splits > 1 else 0,
                               device=q.device)
            err = s._launch(self.bwd_lib.sr_attention_bwd, q.device,
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), stats.data_ptr(),
                            part.data_ptr() if splits > 1 else None, b, nq,
                            nk, c, h, D7BB129_BLOCK_Q, splits,
                            ctypes.byref(launched))
        if err:
            raise RuntimeError(f"earlier sr_attention_bwd failed: {err}")
        return dq, dk, dv


def d7bb129_key_splits(b: int, nq: int, nk: int, heads: int) -> int:
    """d7bb129's query-row splits of its float32 key pass."""
    blocks = -(-nk // D7BB129_KEYS) * b * heads
    want = -(-D7BB129_BLOCKS // blocks)
    rows = -(-(-(-nq // want)) // D7BB129_TILE) * D7BB129_TILE
    return -(-nq // rows)


@contextlib.contextmanager
def using(lib, bwd: bool = False):
    """`sr_attention` (with `bwd`, `sr_attention_bwd`) launches from `lib`
    inside the block."""
    from semisupervisedobjectdetection_torch.ops import sr_attention as sra

    name, limits = (("_bwd_lib", sra._bwd_limits) if bwd
                    else ("_lib", sra._fwd_limits))
    own = getattr(sra, name)
    setattr(sra, name, lambda: lib)
    limits.cache_clear()
    try:
        yield
    finally:
        setattr(sra, name, own)
        limits.cache_clear()


def _rows(other: Other, name: str, dtype_name: str, bwd: bool):
    """One row per shape: other, this, this, other, the plain version and
    SDPA, on both clocks."""
    import torch
    import torch.nn.functional as F

    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        sr_attention,
        sr_attention_backward_reference,
        sr_attention_bwd,
        sr_attention_reference,
    )

    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(SEED + bwd)
    stage_b = MICRO if bwd else BATCH
    cases = [(FEW_BATCH, s) for s in FEWSHOT_SHAPES] + \
        [(stage_b, s) for s in STAGE_SHAPES]
    rows, bad = [], []
    for b, (nq, nk, c, h) in cases:
        q, k, v, g = (torch.randn(b, n, c, device="cuda", generator=gen)
                      .to(dtype) for n in (nq, nk, nk, nq))
        if bwd:
            ref = sr_attention_backward_reference(q, k, v, g, h)
            fns = {name: lambda: other.backward(q, k, v, g, h),
                   "this": lambda: sr_attention_bwd(q, k, v, g, h)}
            plain = lambda: sr_attention_backward_reference(q, k, v, g, h)  # noqa: E731
            qs, ks, vs = (_heads(t, h).detach().requires_grad_()
                          for t in (q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs)
            gs = _heads(g, h)
            sdpa = lambda: torch.autograd.grad(out, (qs, ks, vs), gs,  # noqa: E731
                                               retain_graph=True)
            err_of = lambda got: _rel_err(got, ref)  # noqa: E731
            tol = KERNEL_BWD_TOL[dtype_name]
        else:
            ref = sr_attention_reference(q, k, v, h)
            fns = {name: lambda: other.attention(q, k, v, h),
                   "this": lambda: sr_attention(q, k, v, h)}
            plain = lambda: sr_attention_reference(q, k, v, h)  # noqa: E731
            qs, ks, vs = (_heads(t, h) for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs)  # noqa: E731
            err_of = lambda got: (got.float() - ref.float()).abs().max().item()  # noqa: E731
            tol = KERNEL_TOL[dtype_name]
        row = {"B": b, "shape": [nq, nk, c, h], "dtype": dtype_name,
               name: {"device_ms": [], "host_paced_ms": [], "host_us": []},
               "this": {"device_ms": [], "host_paced_ms": [],
                        "host_us": []}}
        for design in (name, "this", "this", name):
            fn, r = fns[design], row[design]
            r["err"] = max(r.get("err", 0.0), err_of(fn()))
            r["device_ms"].append(cuda_ms(fn, iters=10))
            r["host_paced_ms"].append(host_paced_ms(fn, iters=10))
            r["host_us"].append(host_us(fn, iters=20))
        for key, fn, iters in (("plain", plain, 3), ("sdpa", sdpa, 10)):
            row[key] = {"device_ms": [cuda_ms(fn, iters=iters)],
                        "host_paced_ms": [host_paced_ms(fn, iters=iters)]}
        for key, r in row.items():
            if isinstance(r, dict):
                for clock in ("device_ms", "host_paced_ms"):
                    r[clock + "_mean"] = sum(r[clock]) / len(r[clock])
                if r.get("err", 0.0) > tol:
                    bad.append((b, nq, key, r["err"]))
        bound = attention_bwd_bound if bwd else attention_bound
        row["bound_ms"] = bound(b, nq, nk, c, dtype_name)[0]
        chip_smoke.emit(row)
        rows.append(row)
        del q, k, v, g, ref, qs, ks, vs
    return rows, bad


def _sums(rows, passes, shapes, designs, dtype_name, bwd):
    per = {(r["B"],) + tuple(r["shape"]): r for r in rows}
    bound = attention_bwd_bound if bwd else attention_bound

    def total(fn):
        return sum(n * d * fn(b, s) for b, n in passes
                   for d, s in zip(B5_DEPTHS, shapes))

    return {"bound_ms": total(lambda b, s: bound(b, *s[:3], dtype_name)[0]),
            **{design: {clock: total(
                lambda b, s: per[(b,) + s][design][clock + "_mean"])
                for clock in ("device_ms", "host_paced_ms")}
               for design in designs}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", type=Path, required=True)
    p.add_argument("--bwd", action="store_true")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--other-name", default="other")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k1_design_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        _bwd_lib,
        _lib,
    )

    _lib()
    _bwd_lib()
    other = Other(args.other.resolve())
    designs = (args.other_name, "this", "plain", "sdpa")
    rows, bad = _rows(other, args.other_name, args.dtype, False)
    sums = {"k1_per_fewshot_forward": _sums(
                rows, ((FEW_BATCH, 1),), FEWSHOT_SHAPES, designs, args.dtype,
                False),
            "k1_per_stage_pass": _sums(rows, ((BATCH, 1),), STAGE_SHAPES,
                                       designs, args.dtype, False)}
    if args.bwd:
        bwd_rows, bwd_bad = _rows(other, args.other_name, args.dtype, True)
        rows += bwd_rows
        bad += bwd_bad
        sums["k2_per_fewshot_pair_loss"] = _sums(
            bwd_rows, ((FEW_BATCH, 2),), FEWSHOT_SHAPES, designs, args.dtype,
            True)
        sums["k2_per_stage_pass"] = _sums(bwd_rows, ((MICRO, 1),),
                                          STAGE_SHAPES, designs, args.dtype,
                                          True)
    sums["other_interface"] = "d7bb129" if other.d7bb129 else "package"
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
