"""The port's serving artifact (`checkpoint/serving_export.py`,
`cli/export.py`, `cli/serve.py --artifact`) on the CPU, in the config of the
JAX package's tests/test_serving_export.py (MiT-B0 at depth 1, widths
8-16-32-64, 64x64, batch 4): the header, the loaded predict against
`predict` (float32 and int8), the padding of a partial batch, the refusals,
the exported graph's K1 operator, the server over a loaded artifact, and the
loaded predict of the port's artifact against the JAX package's artifact on
the same bridged weights (the file's one JAX compile, in a module fixture).
The card's artifact (bit-equal to `predict`, 52 K1 launches per call at
MiT-B5) is held by chip_smoke's export phase and tests/test_torch_cuda.py."""

import contextlib
import io
import json
import struct
import urllib.request

import numpy as np
import pytest
import torch

from semisupervisedobjectdetection_tpu.checkpoint import serving_export as jx
from semisupervisedobjectdetection_tpu.core.config import mit_b0 as jmit_b0
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
)
from semisupervisedobjectdetection_torch.checkpoint.serving_export import (
    ExportedPredictor,
    load_serving,
    read_header,
)
from semisupervisedobjectdetection_torch.cli import export, serve
from semisupervisedobjectdetection_torch.core.config import mit_b0
from test_torch_segformer import jax_variables, one_torch_thread  # noqa: F401

CFG = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
           num_heads=(1, 2, 4, 8), decoder_hidden=32, dtype="float32")
SIZE = 64
BATCH = 4
# the port's artifact against the JAX package's, float32 on the CPU
JAX_TOL = 1e-5


def _images(b, seed=0):
    return np.random.default_rng(seed).random((b, SIZE, SIZE, 3),
                                              np.float32)


def _model(quant=None):
    m = SegFormerModel(config=mit_b0(**CFG), device="cpu", seed=3)
    if quant:
        m.quantize(quant)
    return m


@pytest.fixture(scope="module")
def models():
    return {"float32": _model(), "int8": _model("int8")}


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    d = tmp_path_factory.mktemp("artifact")
    out = {}
    for kind, m in models.items():
        path = str(d / f"tiny_{kind}.ssod")
        out[kind] = path, m.export_serving(path, batch_size=BATCH,
                                           img_size=SIZE,
                                           platforms=("cpu",))
    return out


@pytest.fixture(scope="module")
def predictors(artifacts):
    return {kind: load_serving(path, "cpu")
            for kind, (path, _) in artifacts.items()}


def test_header_fields(artifacts):
    path, header = artifacts["float32"]
    assert read_header(path) == header
    assert header["batch"] == BATCH and header["img_size"] == SIZE
    assert header["channels"] == 3 and header["num_labels"] == 1
    assert header["platforms"] == ["cpu"] and header["quant"] == "none"
    assert header["torch_version"] == torch.__version__
    assert read_header(artifacts["int8"][0])["quant"] == "int8"


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_loaded_predict_matches_model(kind, predictors, models):
    pred = predictors[kind]
    assert isinstance(pred, ExportedPredictor)
    assert pred.quant == ("none" if kind == "float32" else kind)
    x = _images(BATCH)
    got = pred.predict(x)
    want = models[kind].predict(x)
    assert got.shape == want.shape == (BATCH, SIZE, SIZE)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_partial_batch_pads_and_slices(predictors, models):
    pred = predictors["float32"]
    x = _images(BATCH - 1, seed=1)
    got = pred.predict(x)
    assert got.shape == (BATCH - 1, SIZE, SIZE)
    padded = np.concatenate([x, np.zeros((1, SIZE, SIZE, 3), np.float32)])
    np.testing.assert_allclose(got, models["float32"].predict(padded)[:-1],
                               rtol=0, atol=1e-6)
    assert pred.predict(x[0]).shape == (1, SIZE, SIZE)


def test_shape_contract_errors(predictors):
    pred = predictors["float32"]
    with pytest.raises(ValueError, match="exceeds"):
        pred.predict(_images(BATCH + 1))
    with pytest.raises(ValueError, match="compiled"):
        pred.predict(np.zeros((1, SIZE, SIZE + 8, 3), np.float32))


def test_missing_platform_and_foreign_file_refused(artifacts, tmp_path):
    """A file that holds no program for the asked device is refused (the
    JAX package refuses a backend the artifact was not lowered for); so
    is a file that is not an artifact, and an unknown platform."""
    path, header = artifacts["float32"]
    with open(path, "rb") as f:
        blob = f.read()
    (n,) = struct.unpack("<I", blob[8:12])
    hdr = json.dumps({**header, "platforms": ["cuda"]}).encode()
    cuda_only = tmp_path / "cuda_only.ssod"
    cuda_only.write_bytes(blob[:8] + struct.pack("<I", len(hdr)) + hdr
                          + blob[12 + n:])
    with pytest.raises(ValueError, match="exported for"):
        load_serving(str(cuda_only), "cpu")
    foreign = tmp_path / "foreign.bin"
    foreign.write_bytes(b"NOTANARTIFACT" + bytes(16))
    with pytest.raises(ValueError, match="not a serving artifact"):
        read_header(str(foreign))
    with pytest.raises(ValueError, match="platforms"):
        _model().export_serving(str(tmp_path / "x.ssod"), batch_size=1,
                                img_size=SIZE, platforms=("tpu",))


@pytest.mark.parametrize("kind", ["float32", "int8"])
def test_exported_graph_calls_the_kernel_operator(kind, predictors):
    """Each encoder layer's SR-attention is the operator
    `ssod::sr_attention_fwd` in the exported graph (one per layer)."""
    calls = [n for n in predictors[kind]._module.graph.nodes
             if n.op == "call_function"
             and n.target is torch.ops.ssod.sr_attention_fwd.default]
    assert len(calls) == sum(CFG["depths"])


def test_serve_artifact_drives_the_inference_server(artifacts, models,
                                                    monkeypatch):
    """`cli/serve.py --artifact`: the server takes its batch and image size
    from the header, /healthz names the artifact, and each reply is the
    artifact's mask of the request padded with zeros."""
    path, _ = artifacts["float32"]
    got = {}

    def serve_then_stop(srv):
        try:
            base = f"http://127.0.0.1:{srv._httpd.server_address[1]}"
            with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
                got["health"] = json.loads(r.read())
            got["masks"] = np.stack([srv.submit(t, timeout=120.0)
                                     for t in _images(2, seed=4)])
        finally:
            srv.stop()

    monkeypatch.setattr(serve, "_serve_until_signal", serve_then_stop)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--artifact", path, "--device", "cpu", "--port", "0"])
    health = got["health"]
    assert health["variant"].startswith("artifact:tiny_float32")
    assert health["max_batch"] == BATCH and health["img_size"] == SIZE
    assert health["platform"] == "cpu" and health["quant"] == "none"
    want = []
    for t in _images(2, seed=4):
        batch = np.zeros((BATCH, SIZE, SIZE, 3), np.float32)
        batch[0] = t
        want.append(models["float32"].predict(batch)[0])
    np.testing.assert_allclose(got["masks"], np.stack(want), rtol=0,
                               atol=1e-6)


def test_export_cli_writes_a_loadable_artifact(tmp_path):
    """`cli/export.py` with the JAX CLI's flags and --device: MiT-B0 at
    64x64, batch 2, the CPU's program; the "wrote ... MB" line."""
    path = str(tmp_path / "b0.ssod")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        header = export.main(["--variant", "b0", "--img-size", str(SIZE),
                              "--dtype", "float32", "--batch", "2",
                              "--platforms", "cpu", "--device", "cpu",
                              "--out", path])
    assert f"wrote {path} (" in out.getvalue()
    assert header["quant"] == "none" and header["batch"] == 2
    masks = load_serving(path, "cpu").predict(_images(1))
    assert masks.shape == (1, SIZE, SIZE) and np.isfinite(masks).all()
    with pytest.raises(SystemExit, match="mutually exclusive"):
        export.main(["--int8", "--fp8", "--out", path])


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """The JAX package's artifact of the float32 config on seeded numpy
    weights (`jax.eval_shape` and numpy, no jitted init), and its loaded
    predict of the images."""
    jcfg = jmit_b0(**CFG)
    v = jax_variables(jcfg, seed=11)
    path = str(tmp_path_factory.mktemp("jax_artifact") / "tiny.ssod")
    jx.export_serving(jcfg, v, path, batch_size=BATCH, img_size=SIZE,
                      platforms=("cpu",))
    x = _images(BATCH, seed=5)
    return v, x, np.asarray(jx.load_serving(path).predict(x))


def test_port_artifact_matches_jax_artifact(jax_artifact, tmp_path):
    v, x, want = jax_artifact
    cfg = mit_b0(**CFG)
    model = SegFormerModel(config=cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, v["params"],
                                               v["batch_stats"]))
    path = str(tmp_path / "port.ssod")
    model.export_serving(path, batch_size=BATCH, img_size=SIZE,
                         platforms=("cpu",))
    got = load_serving(path, "cpu").predict(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
