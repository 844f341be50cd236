"""The port stands alone: no module of `semisupervisedobjectdetection_torch`
nor `chip_smoke.py` nor `scripts/k1_design_ab.py` imports JAX, Flax,
transformers or the JAX package, and the entry points do not fall back to
the CPU when no card is present."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import semisupervisedobjectdetection_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transformers",
             "semisupervisedobjectdetection_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix=port.__name__ + "."))


def test_every_module_imports_without_jax():
    mods = _port_modules()
    for m in ("ops.sr_attention", "losses", "bench", "train.ema",
              "train.state", "train.pseudo", "train.common",
              "train.teacher_student", "train.supervised", "data.synthetic",
              "data.tiles", "data.loader", "data.augment", "data.prefetch",
              "eval.metrics", "utils.logging", "checkpoint.io",
              "cli.common", "cli.teacher_student", "cli.supervised",
              "cli.transfer", "api", "utils.profile_forward",
              "train.autoencoder", "cli.autoencoder", "train.fewshot",
              "data.classified", "cli.fewshot"):
        assert f"semisupervisedobjectdetection_torch.{m}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "chip_smoke.attention_bound(8, 16384, 256, 64, 'bfloat16')\n"
        "chip_smoke.attention_bwd_bound(16, 16384, 256, 64, 'bfloat16')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_bound_from_shapes():
    """The bound of B5 stage 1 at batch 8 in bf16: 34.1 MB at 3.35 TB/s
    outweighs 8.59 GFLOP at 989 TFLOP/s."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    ms, by = chip_smoke.attention_bound(8, 16384, 256, 64, "bfloat16")
    assert by == "bytes"
    assert ms == pytest.approx((2 * 8 * 16384 * 64 + 2 * 8 * 256 * 64)
                               * 2 / 3.35e12 * 1e3)
    ms, by = chip_smoke.attention_bound(8, 16384, 256, 64, "float32")
    assert by == "operations"
    assert ms == pytest.approx(4 * 8 * 16384 * 256 * 64 / 67e12 * 1e3)


def test_chip_smoke_backward_bound_from_shapes():
    """The backward's bound per launch at B=16 in bf16: 10*B*Nq*Nk*C flops
    at 989 TFLOP/s bound stages 1-3 (stage 1: 43.4 us), the bytes of q, g,
    dq and k, v, dk, dv at 3.35 TB/s bound stage 4 (8.8 us); 1.66 ms over
    the 104 launches of a flagship EMA step."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    ms, by = chip_smoke.attention_bwd_bound(16, 16384, 256, 64, "bfloat16")
    assert by == "operations"
    assert ms == pytest.approx(10 * 16 * 16384 * 256 * 64 / 989e12 * 1e3)
    assert ms == pytest.approx(0.0434, abs=1e-4)
    ms, by = chip_smoke.attention_bwd_bound(16, 256, 256, 512, "bfloat16")
    assert by == "bytes"
    assert ms == pytest.approx((3 + 4) * 16 * 256 * 512 * 2 / 3.35e12 * 1e3)
    per_step = 2 * sum(
        d * chip_smoke.attention_bwd_bound(16, *s[:3], "bfloat16")[0]
        for d, s in zip(chip_smoke.B5_DEPTHS, chip_smoke.STAGE_SHAPES))
    assert per_step == pytest.approx(1.659, abs=1e-3)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """No CUDA (and, alone, no repo beside it): a non-zero exit and no
    result line."""
    src = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if where == "alone":
        cwd = str(tmp_path)
        with open(src) as f, open(tmp_path / "chip_smoke.py", "w") as g:
            g.write(f.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_default_entry_point_needs_a_card(monkeypatch):
    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import mit_b0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SegFormerModel(config=mit_b0())
    # asking for the CPU is the one way to run without a card
    assert SegFormerModel(config=mit_b0(depths=(1, 1, 1, 1)),
                          device="cpu").device.type == "cpu"


def test_k1_design_ab_sums_and_imports():
    """`scripts/k1_design_ab.py` imports no JAX, sums the 312 launches of a
    flagship EMA step (bound 3.623 ms) and the 52 of a serve forward (bound
    0.2265 ms), and without a card exits 2 before it builds anything."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'scripts')\n"
        "import k1_design_ab as ab\n"
        "rows = [{'B': b, 'shape': list(s), 'x': {'k': 1.0}}\n"
        "        for b in (32, 16, 8) for s in ab.STAGE_SHAPES]\n"
        "print(ab._sum(rows, ab.EMA_STEP, 'x', 'k'),\n"
        "      ab._sum(rows, ab.SERVE_FORWARD, 'x', 'k'),\n"
        "      round(ab._bound_sum(ab.EMA_STEP), 3),\n"
        "      round(ab._bound_sum(ab.SERVE_FORWARD), 4))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["312.0", "52.0", "3.623", "0.2265"]
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "scripts/k1_design_ab.py", "--other",
         "no_such_source.cu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 2, proc.stdout + proc.stderr
