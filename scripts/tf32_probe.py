"""How close one 3xTF32 product of the float32 SR-attention kernels comes to
float64, on one CUDA card.

    python3 scripts/tf32_probe.py [--nq 16384] [--nk 256]

Builds `scripts/tf32_probe.cu` (the shared helpers of
`semisupervisedobjectdetection_torch/csrc/sr_attention_wgmma.cuh` on one
warpgroup) with the package's nvcc flags and runs it at MiT-B5's stage-1
shape (one head of width 64, seeded N(0, 1) inputs): s = q k^T and
o = s v (o per 64-key block, s split again as the register A operand,
v^T in kperm order), each by the 3xTF32 split and by one TF32 product,
beside torch's float32 matmul (TF32 off). Prints one JSON line: the largest
error of each against the float64 product, as a share of the product's
largest magnitude and absolute, and how many of the q k^T values of the
m64n32 product with q as A (rows, as the backward's row pass forms it)
equal bit for bit those of the m64n32 product with k as A (its key pass),
with the cross terms of the latter in the row pass's order and in
swapped order (as the key pass issues them), then the card's name and
power limit. Exits 2 without a card.
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


def _build() -> ctypes.CDLL:
    from semisupervisedobjectdetection_torch.ops import _build as b

    src = ROOT / "scripts" / "tf32_probe.cu"
    out = ROOT / "build" / "tf32_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [b.nvcc_path(), *b.FLAGS, "-I", str(b.CSRC), "-o", str(out),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.tf32_probe.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.tf32_probe.restype = ctypes.c_int
    return lib, proc.stdout + proc.stderr


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nq", type=int, default=16384)
    p.add_argument("--nk", type=int, default=256)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("tf32_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lib, log = _build()
    nq, nk = args.nq, args.nk
    nkb = nk // 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(n, 64, device="cuda", generator=gen)
               for n in (nq, nk, nk))
    stream = torch.cuda.current_stream().cuda_stream

    def run(terms, swap=0):
        s64 = torch.empty(nq, nk, device="cuda")
        o = torch.empty(nq, nkb, 64, device="cuda")
        s32 = torch.empty(nq, nkb * 32, device="cuda")
        st32 = torch.empty(nk, (nq // 64) * 32, device="cuda")
        err = lib.tf32_probe(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             s64.data_ptr(), o.data_ptr(), s32.data_ptr(),
                             st32.data_ptr(), nq, nk, terms, swap, stream)
        if err:
            raise RuntimeError(f"tf32_probe launch failed: {err}")
        torch.cuda.synchronize()
        return s64, o, s32, st32

    s_ref = q.double() @ k.double().T
    vb = v.double().reshape(nkb, 64, 64)
    out = {"shape": {"nq": nq, "nk": nk, "d": 64}}

    def errs(got, ref):
        e = (got.double() - ref).abs().max().item()
        return {"max_abs_err": e, "rel_to_max": e / ref.abs().max().item()}

    for name, terms, swap in (("3xtf32", 3, 0), ("3xtf32_swapped", 3, 1),
                              ("1xtf32", 1, 0)):
        s64, o, s32, st32 = run(terms, swap)
        # o against s64 (as the kernel formed it) times v, in float64
        o_ref = torch.einsum("qbk,bkd->qbd",
                             s64.double().reshape(nq, nkb, 64), vb)
        a = s32.reshape(nq // 64, 64, nkb, 32)[:, :32]          # q<32, k<32
        b = st32.reshape(nkb, 64, nq // 64, 32)[:, :32]         # k<32, q<32
        b = b.permute(2, 3, 0, 1)                                # qt,q,kb,k
        same = (a == b).float().mean().item()
        out[name] = {"s_qk": errs(s64, s_ref), "o_sv": errs(o, o_ref),
                     "s_n32_vs_n64": errs(s32.reshape(nq, nkb, 32),
                                          s_ref.reshape(nq, nkb, 64)
                                          [:, :, :32]),
                     "share_bit_equal_rows_vs_keys_as_a": same}
        del s64, o, s32, st32
    s_f32 = q @ k.T
    o_f32 = torch.einsum("qbk,bkd->qbd", s_f32.reshape(nq, nkb, 64),
                         v.reshape(nkb, 64, 64))
    out["torch_f32"] = {"s_qk": errs(s_f32, s_ref),
                        "o_sv": errs(o_f32, torch.einsum(
                            "qbk,bkd->qbd", s_f32.double().reshape(
                                nq, nkb, 64), vb))}
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "stack" in ln]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out["card"] = smi
    print(json.dumps({"tf32_probe": out}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
