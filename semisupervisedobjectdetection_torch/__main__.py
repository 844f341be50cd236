"""`python -m semisupervisedobjectdetection_torch --quick`: the install
self-test of the port, the JAX package's `__main__.py` on PyTorch.

In well under a minute it checks the stack end to end on the CUDA card
(`--device cpu` for the CPU): device discovery, the model build, eight
supervised steps on one seeded batch (the loss finite and improving), a
predict whose probabilities can be binarised, and a checkpoint round trip.
The model is MiT-B0 at depth 1 in float32 (head width 32, so on the card
SR-attention runs its float32 kernels). Each check prints ok or FAIL with
its seconds; the exit code is 0 when every check passed, else 1.

The JAX self-test also runs a data-parallel step when it sees more than one
device. The port has no multi-device path yet (ROADMAP.md, Queue 1,
parallelism), so that check is refused: run with `--quick`, which leaves it
out, as the JAX self-test's `--quick` does.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time


def _check(name: str, fn, results: list) -> bool:
    t0 = time.perf_counter()
    try:
        detail = fn() or ""
    except Exception as e:  # a self-test reports each failure and goes on
        results.append((name, False))
        print(f"  FAIL  {name}: {type(e).__name__}: {e}", flush=True)
        return False
    results.append((name, True))
    print(f"  ok    {name} ({time.perf_counter() - t0:.1f}s) {detail}",
          flush=True)
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Install self-test of the PyTorch port.")
    p.add_argument("--quick", action="store_true",
                   help="leave out the multi-device check (required: the "
                        "port has no multi-device path yet)")
    p.add_argument("--size", type=int, default=64,
                   help="self-test tile size (default 64)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)
    if not args.quick:
        raise SystemExit(
            "the multi-device check needs the port's parallelism, which is "
            "not ported yet (ROADMAP.md, Queue 1); run with --quick")

    import numpy as np
    import torch

    import semisupervisedobjectdetection_torch as pkg
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import (
        TrainConfig,
        mit_b0,
    )
    from semisupervisedobjectdetection_torch.utils.device import (
        device_name,
        resolve_device,
    )

    results: list = []
    box: dict = {}
    s = args.size
    cfg = mit_b0(depths=(1, 1, 1, 1), decoder_hidden=32, dtype="float32")

    def discover():
        dev = resolve_device(args.device)
        box["device"] = dev
        count = torch.cuda.device_count() if dev.type == "cuda" else 1
        return (f"{pkg.__name__}, torch {torch.__version__}, "
                f"{device_name(dev)} ({count} device(s))")

    def build():
        box["model"] = SegFormerModel(config=cfg, device=box["device"],
                                      train_config=TrainConfig(lr=3e-3))
        n = sum(t.numel() for t in box["model"].model.parameters())
        return f"MiT-B0 depth 1, {n} parameters"

    def train():
        rng = np.random.default_rng(0)
        imgs = rng.uniform(size=(4, s, s, 3)).astype(np.float32)
        masks = (rng.uniform(size=(4, s, s)) > 0.7).astype(np.float32)
        model = box["model"]
        losses = [float(model.train_one_epoch(imgs, masks)[0])
                  for _ in range(8)]
        if not all(np.isfinite(losses)):
            raise RuntimeError(f"non-finite losses: {losses}")
        if not losses[-1] < losses[0] - 1e-3:
            raise RuntimeError(f"loss did not improve: {losses[0]:.4f} -> "
                               f"{losses[-1]:.4f}")
        return f"loss {losses[0]:.3f} -> {losses[-1]:.3f}"

    def predict():
        m = box["model"].predict(np.zeros((2, s, s, 3), np.float32))
        if m.shape != (2, s, s) or not np.isfinite(m).all():
            raise RuntimeError(f"bad predict output {m.shape}")
        if m.min() < 0.0 or m.max() > 1.0:
            raise RuntimeError("probabilities outside [0, 1]")
        return f"mask {m.shape}, p in [{m.min():.2f}, {m.max():.2f}]"

    def checkpoint_roundtrip():
        model = box["model"]
        with tempfile.TemporaryDirectory(prefix="ssod_selftest_") as d:
            model.save(f"{d}/ck.pt")
            fresh = SegFormerModel(config=cfg, device=box["device"], seed=7)
            fresh.load(f"{d}/ck.pt", full_state=True)
        want = model.state.model.state_dict()
        for name, t in fresh.state.model.state_dict().items():
            if not torch.equal(t, want[name]):
                raise RuntimeError(f"{name} differs after the round trip")
        return "parameters and statistics bit-identical after restore"

    if _check("device discovery", discover, results) \
            and _check("model build", build, results) \
            and _check("8 supervised train steps", train, results):
        _check("predict (binarizable probabilities)", predict, results)
        _check("checkpoint save/restore round-trip", checkpoint_roundtrip,
               results)
    n_fail = sum(1 for _, ok in results if not ok)
    print(f"self-test: {len(results) - n_fail} passed, {n_fail} failed",
          flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
