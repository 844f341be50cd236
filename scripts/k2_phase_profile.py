"""Where a tile's time goes in K2's bf16 wgmma kernel, on one CUDA card.

    python3 scripts/k2_phase_profile.py [--out chiprun_out/k2_phases.jsonl]

Builds a copy of `semisupervisedobjectdetection_torch/csrc/sr_attention_bwd.cu`
(under `build/k2_phases/`) in which thread 0 of each consumer warpgroup
reads `clock64()` at the borders of the kernel's phases and sums the cycles
of each phase over its CTA's tiles; the sums go to a device array that a
C export copies out. Per 64-row query tile (the sum over all CTAs divided
by the tiles of the launch) the phases are:

- `kv`: waiting for a segment's K and V (its first TMA load or a reload);
- `wait_q`: waiting for the tile's q and g in the ring;
- `stats`: the row statistics' products and online fold over this
  consumer's share of the 32-key chunks;
- `b1`: the barrier where both consumers' partial statistics meet;
- `merge`: every warp's merge of the two partials;
- `main`: the main sweep (s^T, dp^T, p, ds, dv and dk of the owned
  M-tiles, ds^T to shared memory);
- `b3`: the barrier before dq;
- `dq`: dq = ds k and its store (every other tile on each consumer);
- `seg`: a segment's end (dk and dv written, bf16 or float32 partials).

The copy is called through the package's own `sr_attention_bwd` wrapper at
the MiT-B5 512x512 stage shapes at batch 16 and the transfer step's Nk-266
stage-1 shape, once each after a warm-up (the counters hold that launch's
sums). Prints one JSON line per shape (cycles per tile per consumer, the
launch's device ms, grid and tiles) and the card's name and power limit.
The stamps cost a few cycles each; the totals are a breakdown, not a
timing. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from chip_smoke import MICRO, SEED, STAGE_SHAPES  # noqa: E402

PHASES = ("kv", "wait_q", "stats", "b1", "merge", "main", "b3", "dq", "seg")
SHAPES = [(MICRO,) + s for s in STAGE_SHAPES] + [(MICRO, 16394, 266, 64, 1)]
MAX_CTAS = 1024


def _stamp(i: int) -> str:
    return (f"      if (ct == 0) {{ const long long t_ = clock64(); "
            f"prof_sum[{i}] += t_ - prof_t; prof_t = t_; }}\n")


def instrumented(src: str) -> str:
    """`src` with the phase counters: each edit is anchored on a line of
    the kernel and fails loudly if the source has moved on."""
    edits = [
        ("namespace {\n", "namespace {\n__device__ long long "
         f"g_prof[{MAX_CTAS}][2][{len(PHASES)}];\n"),
        ("  const bool has_tail = MT > 4 && wg == 0 && nmt > 4;\n",
         "  const bool has_tail = MT > 4 && wg == 0 && nmt > 4;\n"
         f"  long long prof_sum[{len(PHASES)}] = {{0}};\n"
         "  long long prof_t = clock64();\n"),
        ("    mbar_wait(kv_full, gen & 1);\n",
         "    mbar_wait(kv_full, gen & 1);\n" + _stamp(0)),
        ("      mbar_wait(full(st), (i / kRing) & 1);\n",
         "      mbar_wait(full(st), (i / kRing) & 1);\n" + _stamp(1)),
        ("      consumers_sync();\n      // every warp merges",
         _stamp(2) + "      consumers_sync();\n" + _stamp(3)
         + "      // every warp merges"),
        ("      __syncwarp();\n\n      // 2. the main sweep",
         "      __syncwarp();\n" + _stamp(4) + "\n      // 2. the main sweep"),
        ("      if (lane == 0) mbar_arrive(empty(st));\n"
         "      fence_proxy_async();\n",
         _stamp(5) + "      if (lane == 0) mbar_arrive(empty(st));\n"
         "      fence_proxy_async();\n"),
        ("      consumers_sync();\n\n      // 3. dq",
         "      consumers_sync();\n" + _stamp(6) + "\n      // 3. dq"),
        ("                    (u - bh * tiles_per_bh) * kRowTile, b);\n"
         "      }\n    }\n",
         "                    (u - bh * tiles_per_bh) * kRowTile, b);\n"
         "      }\n" + _stamp(7) + "    }\n"),
        ("    u = seg_end;\n", "    u = seg_end;\n" + _stamp(8)),
        ("  if (ct == 0) tma_store_wait<false>();\n}",
         "  if (ct == 0) tma_store_wait<false>();\n"
         f"  if (ct == 0 && blockIdx.x < {MAX_CTAS})\n"
         f"    for (int j = 0; j < {len(PHASES)}; ++j)\n"
         "      g_prof[blockIdx.x][wg][j] = prof_sum[j];\n}"),
        ('extern "C" {\n', 'extern "C" {\n'
         "int sr_attention_bwd_phases(long long* out) {\n"
         "  return int(cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)));\n"
         "}\n"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once in the source: "
                               f"{old!r}")
        src = src.replace(old, new)
    return src


def build(src_text: str) -> ctypes.CDLL:
    """The instrumented source built with the package's nvcc flags."""
    from semisupervisedobjectdetection_torch.ops import _build
    from semisupervisedobjectdetection_torch.ops.sr_attention import (
        declare_bwd,
    )

    out_dir = ROOT / "build" / "k2_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "sr_attention_bwd_phases.cu"
    cu.write_text(src_text)
    so = out_dir / "sr_attention_bwd_phases.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.FLAGS, "-I",
                           str(_build.CSRC), "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = declare_bwd(ctypes.CDLL(str(so)))
    lib.sr_attention_bwd_phases.argtypes = [ctypes.c_void_p]
    lib.sr_attention_bwd_phases.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_phase_profile: no CUDA device", file=sys.stderr)
        return 2
    from semisupervisedobjectdetection_torch.ops import _build
    from semisupervisedobjectdetection_torch.ops import sr_attention as sra

    lib = build(instrumented(
        (_build.CSRC / "sr_attention_bwd.cu").read_text()))
    sra._bwd_lib = lambda: lib
    sra._bwd_limits.cache_clear()
    buf = (ctypes.c_longlong * (MAX_CTAS * 2 * len(PHASES)))()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows = []
    for b, nq, nk, c, h in SHAPES:
        q, k, v, g = (torch.randn(b, n, c, device="cuda", generator=gen)
                      .to(torch.bfloat16) for n in (nq, nk, nk, nq))
        sra.sr_attention_bwd(q, k, v, g, h)
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        sra.sr_attention_bwd(q, k, v, g, h)
        t1.record()
        torch.cuda.synchronize()
        if lib.sr_attention_bwd_phases(buf):
            raise RuntimeError("reading the phase counters failed")
        plan = sra.bwd_launch_plan(b, nq, nk, c, h,
                                   sra._sm_count(q.device.index))
        sums = np.frombuffer(buf, dtype=np.int64).reshape(
            MAX_CTAS, 2, len(PHASES))[:plan["grid"]].sum(0)
        per_tile = sums / plan["tiles"]
        row = {"B": b, "shape": [nq, nk, c, h],
               "device_ms": t0.elapsed_time(t1), "grid": plan["grid"],
               "tiles": plan["tiles"],
               **{f"cycles_per_tile_wg{w}": {
                   name: round(float(x)) for name, x in zip(PHASES,
                                                            per_tile[w])}
                  for w in range(2)}}
        chip_smoke.emit(row)
        rows.append(row)
        del q, k, v, g
    card = chip_smoke.nvidia_smi_line()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n"
                                    for r in rows + [{"card": card}]))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
