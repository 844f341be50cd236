"""The fp8 reading at full MiT-B5 depth, held against the JAX package.

chip_smoke's quant_serve reads the seeded full-depth MiT-B5 (512x512,
bfloat16, tanh GELU) fp8 snapshot's masks agreeing with the float32 model's
at ~0.95, under the 0.97 the JAX package's bounds were set at (depths
1-1-2-1). This test reads the same function through both packages on the
CPU: the port's seeded weights (seed 0, as quant_serve) and quant_serve's
first two images (seed 20) go through the port's plain path
(`SegFormerModel.predict` on the CPU: the plain attention and the plain
int8 and fp8 products) and, bridged into the JAX package's variables,
through `SegFormer(cfg).apply` and `SegFormer(qcfg).apply` on the JAX
package's own quantized trees (tests/_fp8_depth_main.py, a fresh
interpreter).

Two configurations:

- `as_drawn`: quant_serve's seeded weights as the running torch release
  draws them. The draw depends on the release: under the card's release
  quant_serve's probabilities sit within hundredths of 0.5, where fp8's
  rounding flips ~5% of the pixels; under another release the same seed
  can leave every probability below 0.5, where nothing flips and only the
  probabilities' distances say anything. So this is quant_serve's
  configuration only where the release draws the card's weights.
- `centred`: the same weights with one change, not quant_serve's: the
  classifier's bias set to minus the float32 model's mean logit on the two
  images, so that the probabilities straddle 0.5 on any release (the
  regime in which pixels flip).

Held, for each quantized width: the two packages' masks of that width
agree per pixel at `PORT_JAX_AGREE` or more and differ by at most
`PORT_JAX_MEAN_DP` in mean |dp|; each width's agreement with its
package's float32 masks is within `AGREE_GAP` of the other package's; the
two packages' float32 masks agree. The limits sit halfway between the
readings of a sound run and the nearest control: the port's masks of
another width against the JAX masks of this width, or the other way round
(what a port path computing another arithmetic would read). In bfloat16
the two packages differ by bfloat16's own rounding, about as far as
bfloat16 is from float32, so the bfloat16 limits catch a port as far off
as int8, not one as far off as float32.

Marked `slow`: Tier-1 (`-m 'not slow'`) does not run it. Each case runs
four full-depth B5 forwards per package on the CPU, one image a call, a
few GB of memory: `python -m pytest -o addopts="" -m slow -s
tests/test_torch_fp8_depth.py`. It prints the readings as one JSON line a
case.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.core.config import mit_b5
from semisupervisedobjectdetection_torch.models.segformer import (
    forward_logits,
)

SEED, IMG, BATCH, IMAGES = 0, 512, 8, 2
WIDTHS = ("float32", "bfloat16", "int8", "fp8")
# each width's agreement with float32, port against JAX (chip_smoke's
# QUANT_WITNESS_GAP between the card's and the CPU's fp8 readings)
AGREE_GAP = 0.01
FLOAT32_AGREE = 0.999
# Port against JAX at the same width, halfway between a sound run's reading
# and the nearest control's (the centred case's, in this sandbox: agreement
# bf16 0.98713 against 0.98523, int8 0.97645 against 0.97241, fp8 0.95927
# against 0.89826; mean |dp| bf16 4.254e-4 against 4.939e-4, int8 7.861e-4
# against 9.382e-4, fp8 1.398e-3 against 3.369e-3).
PORT_JAX_AGREE = {"bfloat16": 0.986, "int8": 0.974, "fp8": 0.93}
PORT_JAX_MEAN_DP = {"bfloat16": 4.6e-4, "int8": 8.6e-4, "fp8": 2.4e-3}


def _agree(a, b) -> float:
    return float(((a > 0.5) == (b > 0.5)).mean())


def _weights(cfg, x, config):
    """The seeded float32 weights; with `config` "centred" the classifier's
    bias set to minus the mean logit of the images."""
    model = SegFormerModel(config=cfg.replace(dtype="float32"), seed=SEED,
                           device="cpu")
    sd = {n: t.clone() for n, t in model._net.state_dict().items()}
    if config == "centred":
        with torch.no_grad():
            mean = np.mean([forward_logits(model.model, torch.from_numpy(
                x[i:i + 1]))[0].mean().item() for i in range(x.shape[0])])
        sd["decode_head.classifier.bias"].fill_(-mean)
    return sd


def _port_masks(cfg, x, sd):
    out = {}
    for width in WIDTHS:
        dtype = "float32" if width == "float32" else "bfloat16"
        model = SegFormerModel(config=cfg.replace(dtype=dtype), seed=SEED,
                               device="cpu")
        model.load_state_dict(sd)
        if width in ("int8", "fp8"):
            model.quantize(width)
        out[width] = np.concatenate([model.predict(x[i:i + 1])
                                     for i in range(x.shape[0])])
        del model
    return out


@pytest.mark.slow
@pytest.mark.parametrize("config", ["as_drawn", "centred"])
def test_fp8_full_depth_against_jax(config, tmp_path):
    torch.set_num_threads(os.cpu_count() or 1)
    cfg = mit_b5(dtype="bfloat16", gelu_approx=True)
    rng = np.random.default_rng(SEED + 20)
    x = rng.uniform(size=(BATCH, IMG, IMG, 3)).astype(np.float32)[:IMAGES]
    sd = _weights(cfg, x, config)
    port = _port_masks(cfg, x, sd)
    weights = {n: t.numpy() for n, t in sd.items() if t.is_floating_point()}
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, __images__=x, **weights)
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_fp8_depth_main.py")
    proc = subprocess.run([sys.executable, script, str(src), str(dst)],
                          capture_output=True, text=True, timeout=3600)
    assert proc.returncode == 0 and "fp8-depth-jax-ok" in proc.stdout, (
        f"the JAX side failed:\n{proc.stdout[-3000:]}\n"
        f"{proc.stderr[-3000:]}")
    with np.load(dst) as f:
        ref = dict(f)
    row = {"config": config, "variant": "b5", "img": IMG, "images": IMAGES,
           "torch": torch.__version__,
           "near_half_0.01": float(
               (np.abs(port["float32"] - 0.5) < 0.01).mean()),
           "float32_port_vs_jax": _agree(port["float32"], ref["float32"]),
           "max_abs_dp_float32_port_vs_jax": float(
               np.abs(port["float32"] - ref["float32"]).max())}
    for width in WIDTHS[1:]:
        row[width] = {
            "port_agree_vs_float32": _agree(port[width], port["float32"]),
            "jax_agree_vs_float32": _agree(ref[width], ref["float32"]),
            "port_vs_jax_agree": _agree(port[width], ref[width]),
            "max_abs_dp_port_vs_jax": float(
                np.abs(port[width] - ref[width]).max()),
            "mean_abs_dp_port_vs_jax": float(
                np.abs(port[width] - ref[width]).mean()),
            # the controls: the port's other widths against JAX's this
            # width, and this width against JAX's other widths
            "controls": {f"{a}_vs_jax_{b}": {
                "agree": _agree(port[a], ref[b]),
                "mean_abs_dp": float(np.abs(port[a] - ref[b]).mean())}
                for a, b in [(o, width) for o in WIDTHS if o != width]
                + [(width, o) for o in WIDTHS if o != width]}}
    print("fp8_depth " + json.dumps(row), flush=True)
    assert row["float32_port_vs_jax"] >= FLOAT32_AGREE
    for width in WIDTHS[1:]:
        r = row[width]
        assert abs(r["port_agree_vs_float32"]
                   - r["jax_agree_vs_float32"]) <= AGREE_GAP, (width, r)
        assert r["port_vs_jax_agree"] >= PORT_JAX_AGREE[width], (width, r)
        assert r["mean_abs_dp_port_vs_jax"] <= PORT_JAX_MEAN_DP[width], (
            width, r)
