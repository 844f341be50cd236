"""Quantized serving in the port on the CPU: `SegFormerModel.quantize`,
`dequantize`, `save_quantized` and `load_quantized` with the JAX package's
semantics (the float32 masters quantized, the snapshot stale under
training and dropped by a rebuild, its width read from the stored dtypes),
and the CLIs that serve it: `cli/serve.py --int8 / --fp8 /
--int8-snapshot` and `cli/supervised.py --predict --int8 / --fp8`."""

import contextlib
import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint.io import (
    load_snapshot,
    save_snapshot,
)
from semisupervisedobjectdetection_torch.cli import serve, supervised
from semisupervisedobjectdetection_torch.core.config import mit_b0
from semisupervisedobjectdetection_torch.ops import quant
from semisupervisedobjectdetection_torch.ops.quant import QLinear
from test_torch_segformer import one_torch_thread  # noqa: F401

SMALL = dict(depths=(1, 1, 1, 1), hidden_sizes=(16, 32, 64, 128),
             num_heads=(1, 2, 4, 8), decoder_hidden=32)
SIZE = 64
KINDS = ("int8", "fp8")


def _model(seed=0, **kw):
    return SegFormerModel(config=mit_b0(**SMALL, **kw), device="cpu",
                          seed=seed)


def _images(n=2, seed=1):
    return np.random.default_rng(seed).uniform(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_serves_the_snapshot_of_the_float32_masters(kind):
    """A bfloat16 model: every dense layer of the snapshot holds the
    quantization of its float32 master (not of the bfloat16 serving copy),
    the convs are cast once, and `predict` runs it."""
    m = _model(dtype="bfloat16")
    x = _images()
    float_masks = m.predict(x)
    m.quantize(kind)
    assert m.quant == kind and m.model.cfg.quant == kind
    masters = dict(m._net.named_modules())
    layers = {n: mod for n, mod in m.model.named_modules()
              if isinstance(mod, QLinear)}
    assert len(layers) == 6 * 4 + 4
    for n, layer in layers.items():
        w, s = (quant.quantize_weight if kind == "int8"
                else quant.quantize_weight_fp8)(masters[n].weight)
        assert torch.equal(layer.weight.view(torch.uint8),
                           w.view(torch.uint8)), n
        assert torch.equal(layer.weight_scale, s), n
        assert layer.dtype == torch.bfloat16
    assert m.model.decode_head.classifier.weight.dtype == torch.bfloat16
    got = m.predict(x)
    assert got.shape == float_masks.shape and np.isfinite(got).all()
    assert not np.array_equal(got, float_masks)
    np.testing.assert_allclose(got, float_masks, atol=0.05)


def test_dequantize_serves_the_float_model_again():
    m = _model()
    x = _images()
    want = m.predict(x)
    m.quantize("int8")
    assert not np.array_equal(m.predict(x), want)
    m.dequantize()
    assert m.quant == "none"
    np.testing.assert_array_equal(m.predict(x), want)


@pytest.mark.parametrize("kind", KINDS)
def test_snapshot_round_trip_is_bit_identical(kind, tmp_path):
    """save_quantized -> load_quantized into a model with other weights:
    the same tensors and the same masks, bit for bit, the width read back
    from the file."""
    m = _model(seed=3)
    m.quantize(kind)
    path = str(tmp_path / "snap.pt")
    m.save_quantized(path)
    fresh = _model(seed=4)
    fresh.load_quantized(path)
    assert fresh.quant == kind
    a, b = m.model.state_dict(), fresh.model.state_dict()
    assert set(a) == set(b)
    for n in a:
        assert a[n].dtype == b[n].dtype, n
        assert torch.equal(a[n].view(torch.uint8) if a[n].dtype in (
            torch.int8, quant.FP8) else a[n],
            b[n].view(torch.uint8) if b[n].dtype in (
                torch.int8, quant.FP8) else b[n]), n
    x = _images()
    np.testing.assert_array_equal(fresh.predict(x), m.predict(x))


def test_snapshot_needs_exactly_one_quantized_dtype(tmp_path):
    m = _model()
    none_path = str(tmp_path / "none.pt")
    save_snapshot(none_path, m._net)          # a float model: no width
    with pytest.raises(ValueError, match="none"):
        _model().load_quantized(none_path)
    m.quantize("int8")
    m.save_quantized(str(tmp_path / "int8.pt"))
    sd = load_snapshot(str(tmp_path / "int8.pt"))
    name = next(n for n, t in sd.items() if t.dtype == torch.int8)
    sd[name] = sd[name].to(quant.FP8)
    both = str(tmp_path / "both.pt")
    torch.save({"snapshot": sd}, both)
    with pytest.raises(ValueError, match="fp8.*int8"):
        _model().load_quantized(both)


def test_save_quantized_before_quantize_raises(tmp_path):
    with pytest.raises(ValueError, match="quantize"):
        _model().save_quantized(str(tmp_path / "q.pt"))


def test_training_leaves_the_snapshot_stale_and_a_rebuild_drops_it():
    """A train step changes the float model but not the snapshot (until the
    next quantize()); a structural rebuild drops it."""
    m = _model()
    x = _images()
    gt = (np.random.default_rng(2).uniform(size=(2, SIZE, SIZE)) > 0.5
          ).astype(np.float32)
    m.quantize("int8")
    before = m.predict(x)
    snap = {n: t.clone() for n, t in m.model.state_dict().items()}
    m.train_one_epoch(x, gt)
    np.testing.assert_array_equal(m.predict(x), before)
    assert all(torch.equal(t, snap[n]) for n, t in
               m.model.state_dict().items())
    m.quantize("int8")
    assert not np.array_equal(m.predict(x), before)
    m.add_prompt_token((2, 2, 2, 2))
    assert m.quant == "none"
    assert not any(isinstance(mod, QLinear) for mod in m.model.modules())


def _serve_main(argv, x, monkeypatch):
    """Run `serve.main` in-process on the CPU: each tile of `x` posted
    alone (the server pads it with zeros to --max-batch 2), /healthz read,
    then stopped. Returns (masks, health, stdout)."""
    got = {}

    def serve_then_stop(srv):
        try:
            base = f"http://127.0.0.1:{srv._httpd.server_address[1]}"
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                got["health"] = json.loads(r.read())
            got["masks"] = np.stack([srv.submit(t, timeout=120.0)
                                     for t in x])
        finally:
            srv.stop()

    monkeypatch.setattr(serve, "_serve_until_signal", serve_then_stop)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--variant", "b0", "--img-size", str(SIZE),
                    "--max-batch", "2", "--dtype", "float32", "--port", "0",
                    "--device", "cpu"] + argv)
    return got["masks"], got["health"], out.getvalue()


def _padded_predict(model, x):
    """What the server computes for each tile: the tile, then zeros."""
    out = []
    for t in x:
        batch = np.zeros((2, SIZE, SIZE, 3), np.float32)
        batch[0] = t
        out.append(model.predict(batch)[0])
    return np.stack(out)


@pytest.mark.parametrize("kind", KINDS)
def test_main_serves_quantized(kind, monkeypatch):
    x = _images()
    masks, health, out = _serve_main([f"--{kind}"], x, monkeypatch)
    assert health["quant"] == kind and health["int8"] == (kind == "int8")
    assert f", {kind})" in out
    want = SegFormerModel(config=mit_b0(dtype="float32"), device="cpu")
    want.quantize(kind)
    np.testing.assert_array_equal(masks, _padded_predict(want, x))


def test_main_writes_then_loads_the_snapshot(tmp_path, monkeypatch):
    """--int8-snapshot: written after quantize() when the file is absent,
    loaded (width from its dtypes) when present; both runs serve the same
    masks. Mutually exclusive widths and a snapshot without a width are
    refused."""
    x = _images(1)
    path = str(tmp_path / "b0_int8.pt")
    first, _, out1 = _serve_main(["--int8", "--int8-snapshot", path], x,
                                 monkeypatch)
    assert "int8 snapshot written" in out1
    # --fp8 asked, but the file's width (int8) is what is served
    second, health, out2 = _serve_main(["--fp8", "--int8-snapshot", path],
                                       x, monkeypatch)
    assert "quantized snapshot loaded" in out2 and health["quant"] == "int8"
    np.testing.assert_array_equal(second, first)
    for argv, msg in ((["--int8", "--fp8"], "mutually exclusive"),
                      (["--int8-snapshot", path], "needs --int8")):
        with pytest.raises(SystemExit, match=msg):
            serve.main(["--variant", "b0", "--device", "cpu"] + argv)


@pytest.mark.parametrize("kind", KINDS)
def test_supervised_predict_quantized(kind, tmp_path):
    """`--predict --int8/--fp8` evaluates the quantized snapshot through
    `predict` and the binarised dice (`--int8-snapshot` written, then read
    by a second run with the same loss); without --predict the flags are
    refused."""
    snap = str(tmp_path / "snap.pt")
    argv = ["--device", "cpu", "--synthetic", "--synthetic-n", "6",
            "--variant", "b0", "--img-size", str(SIZE), "--predict",
            f"--{kind}", "--int8-snapshot", snap]
    first = supervised.main(argv + ["--dump-masks", str(tmp_path / "d")])
    again = supervised.main(argv)
    assert first["eval_loss"] == again["eval_loss"]
    assert 0.0 <= first["eval_loss"] <= 1.0 and first["dumped"] > 0
    with pytest.raises(SystemExit, match="--predict only"):
        supervised.main(["--device", "cpu", "--synthetic", f"--{kind}"])
