"""The port's sliding-window raster (`semisupervisedobjectdetection_torch/
eval/sliding_window.py`) against the JAX package's: the cases of
tests/test_sliding_window.py, the same blended bits from the same numpy
predictor, and `cli/supervised.py --predict --sliding-raster` (plain and
`--int8`) writing the PNG of a numpy blend of `model.predict` over the same
windows."""

import numpy as np
import pytest
from PIL import Image

from semisupervisedobjectdetection_tpu.eval.sliding_window import (
    sliding_window_predict as jax_sliding_window_predict,
)
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.cli import supervised
from semisupervisedobjectdetection_torch.core.config import mit_b0
from semisupervisedobjectdetection_torch.eval.sliding_window import (
    _hann2d,
    sliding_window_predict,
    window_coords,
)
from test_torch_segformer import one_torch_thread  # noqa: F401


def _mean_rgb(tiles):
    return np.asarray(tiles).mean(-1)


def test_constant_predictor_gives_constant_field():
    img = np.zeros((150, 200, 3), np.float32)
    out = sliding_window_predict(
        lambda t: np.full(t.shape[:3], 0.7, np.float32), img, window=64,
        overlap=16, batch=4)
    assert out.shape == (150, 200)
    np.testing.assert_allclose(out, 0.7, atol=1e-5)


def test_content_dependent_predictor_matches_direct():
    img = np.random.default_rng(0).uniform(
        0, 1, (130, 96, 3)).astype(np.float32)
    out = sliding_window_predict(_mean_rgb, img, window=64, overlap=32,
                                 batch=2)
    np.testing.assert_allclose(out, img.mean(-1), atol=1e-4)


def test_window_equal_to_image():
    img = np.random.default_rng(1).uniform(
        0, 1, (64, 64, 3)).astype(np.float32)
    out = sliding_window_predict(_mean_rgb, img, window=64, overlap=16)
    np.testing.assert_allclose(out, img.mean(-1), atol=1e-4)


@pytest.mark.parametrize("shape,window,overlap,batch", [
    ((150, 200), 64, 16, 4), ((130, 96), 64, 32, 2), ((64, 64), 64, 16, 8),
    ((200, 177), 48, 8, 3)])
def test_bit_equal_to_jax(shape, window, overlap, batch):
    """A predictor that mixes the channels nonlinearly, so every window's
    weights and sums matter: the port's blend equals the JAX package's."""
    img = np.random.default_rng(2).uniform(
        0, 1, shape + (3,)).astype(np.float32)

    def predictor(tiles):
        t = np.asarray(tiles)
        return np.tanh(t[..., 0] * 3 - t[..., 1] * t[..., 2])

    want = jax_sliding_window_predict(predictor, img, window, overlap,
                                      batch)
    got = sliding_window_predict(predictor, img, window, overlap, batch)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _numpy_blend(predict, img, window, overlap, batch=8):
    """The blend written out by hand over `window_coords`' windows."""
    coords = window_coords(img.shape[0], img.shape[1], window, overlap)
    weight = _hann2d(window) + 1e-3
    acc = np.zeros(img.shape[:2], np.float32)
    norm = np.zeros(img.shape[:2], np.float32)
    for i in range(0, len(coords), batch):
        chunk = coords[i:i + batch]
        tiles = np.zeros((batch, window, window, 3), np.float32)
        for j, (y, x) in enumerate(chunk):
            tiles[j] = img[y:y + window, x:x + window]
        preds = predict(tiles)
        for (y, x), p in zip(chunk, preds):
            acc[y:y + window, x:x + window] += p * weight
            norm[y:y + window, x:x + window] += weight
    return acc / np.maximum(norm, 1e-8)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_sliding_raster_cli(quant, tmp_path):
    """`--predict --sliding-raster` on a 150x170 PNG with 64-pixel windows
    and 16 of overlap (12 windows, batches of 8, the second padded): the
    written PNG is the numpy blend of `SegFormerModel.predict` (quantized
    the same way) over the same windows, byte for byte."""
    rgb = (np.random.default_rng(3).uniform(size=(150, 170, 3)) * 255
           ).astype(np.uint8)
    raster = str(tmp_path / "scene.png")
    Image.fromarray(rgb).save(raster)
    argv = ["--device", "cpu", "--variant", "b0", "--predict",
            "--sliding-raster", raster, "--window", "64", "--overlap", "16",
            "--dump-masks", str(tmp_path / "out")]
    if quant != "none":
        argv.append("--int8")
    out = supervised.main(argv)
    assert tuple(out["shape"]) == (150, 170)
    assert len(window_coords(150, 170, 64, 16)) == 12
    got = np.asarray(Image.open(tmp_path / "out" / "raster_mask.png"))
    # the CLI's model: b0 in its default bfloat16, seed 0
    model = SegFormerModel(config=mit_b0(dtype="bfloat16"), device="cpu")
    if quant != "none":
        model.quantize(quant)
    img = rgb.astype(np.float32) / 255.0
    want = (_numpy_blend(model.predict, img, 64, 16) * 255).astype(np.uint8)
    np.testing.assert_array_equal(got, want)
