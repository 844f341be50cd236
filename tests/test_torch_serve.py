"""The port's HTTP inference server (`semisupervisedobjectdetection_torch/
cli/serve.py`) on the CPU, in the manner of tests/test_serve.py: routes,
batching, formats, drain-stop, served masks equal to the JAX package's
`forward_masks` with the same weights, `main --pretrain-weight` serving a
checkpoint of the port's own CLIs, and the artifact flag refused (the
quantized flags are held in tests/test_torch_quant_serving.py)."""

import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu.core.config import mit_b0 as jax_b0
from semisupervisedobjectdetection_tpu.train.common import (
    forward_masks as jax_forward_masks,
)
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
)
from semisupervisedobjectdetection_torch.cli import serve
from semisupervisedobjectdetection_torch.cli.serve import InferenceServer
from semisupervisedobjectdetection_torch.core.config import mit_b0
from semisupervisedobjectdetection_torch.utils import preemption
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    jax_variables,
    one_torch_thread,
)

SMALL = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
             num_heads=(1, 2, 4, 8), decoder_hidden=32)
SIZE = 64
MAX_BATCH = 4


@pytest.fixture(scope="module")
def jax_model():
    jcfg = jax_b0(**SMALL)
    v = jax_variables(jcfg, size=SIZE)
    fwd = jax.jit(lambda v, x: jax_forward_masks(jcfg, v, x)[0])
    return v, lambda x: np.asarray(fwd(v, jnp.asarray(x)))


@pytest.fixture(scope="module")
def server(jax_model):
    v, _ = jax_model
    cfg = mit_b0(**SMALL)
    model = SegFormerModel(config=cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, v["params"],
                                               v["batch_stats"]))
    srv = InferenceServer(model, img_size=SIZE, max_batch=MAX_BATCH,
                          batch_window_ms=20.0, variant="b0-small")
    port = srv.start()
    yield srv, f"http://127.0.0.1:{port}"
    srv.stop()


def _png_bytes(h=80, w=96, seed=0) -> bytes:
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _post(url, body, raw=False):
    headers = {"Content-Type": "application/octet-stream"} if raw else {}
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, dict(r.headers), r.read()


def _http_error(fn):
    try:
        fn()
    except urllib.error.HTTPError as e:
        return e.code
    return None


def test_healthz_reports_torch_device(server):
    _, base = server
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        obj = json.loads(r.read())
    assert obj["status"] == "ok"
    assert obj["platform"] == "cpu" and obj["device_name"] == "cpu"
    assert obj["img_size"] == SIZE and obj["max_batch"] == MAX_BATCH


def test_served_npy_matches_jax_forward_masks(server, jax_model):
    """Raw uint8 in, float32 probabilities out, equal to the JAX package's
    forward_masks on the same pixels and weights (float32 on both sides;
    the port's batch is zero-padded to max_batch, which the JAX side sees
    as one image: no op mixes the batch)."""
    _, base = server
    _, jax_fwd = jax_model
    img = np.random.default_rng(7).integers(0, 255, (SIZE, SIZE, 3),
                                            dtype=np.uint8)
    status, _, body = _post(base + "/predict?format=npy", img.tobytes(),
                            raw=True)
    assert status == 200
    probs = np.load(io.BytesIO(body))
    assert probs.shape == (SIZE, SIZE) and probs.dtype == np.float32
    expect = jax_fwd(img[None].astype(np.float32) / 255.0)[0]
    np.testing.assert_allclose(probs, expect, atol=1e-4)


def test_served_raw_mask_matches_jax_threshold(server, jax_model):
    _, base = server
    _, jax_fwd = jax_model
    img = np.random.default_rng(8).integers(0, 255, (SIZE, SIZE, 3),
                                            dtype=np.uint8)
    status, headers, body = _post(base + "/predict", img.tobytes(),
                                  raw=True)
    assert status == 200 and headers["X-Mask-Shape"] == f"{SIZE}x{SIZE}"
    mask = np.frombuffer(body, np.uint8).reshape(SIZE, SIZE)
    expect = jax_fwd(img[None].astype(np.float32) / 255.0)[0]
    near = np.abs(expect - 0.5) < 1e-4   # may round either way
    np.testing.assert_array_equal(
        mask[~near], ((expect >= 0.5).astype(np.uint8) * 255)[~near])


def test_png_roundtrip_at_original_size(server):
    _, base = server
    status, headers, body = _post(base + "/predict", _png_bytes(80, 96))
    assert status == 200 and headers["Content-Type"] == "image/png"
    mask = np.asarray(Image.open(io.BytesIO(body)))
    assert mask.shape == (80, 96)
    assert set(np.unique(mask)) <= {0, 255}


def test_concurrent_requests_share_batches(server):
    srv, base = server
    before = srv.snapshot_stats()
    results = [None] * 6

    def worker(i):
        results[i] = _post(base + "/predict", _png_bytes(seed=10 + i))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(r is not None and r[0] == 200 for r in results)
    with urllib.request.urlopen(base + "/stats", timeout=30) as r:
        stats = json.loads(r.read())
    assert stats["requests"] - before["requests"] == 6
    # 6 requests against max_batch=4 with a 20ms window: 2..6 batches
    assert 2 <= stats["batches"] - before["batches"] <= 6
    lat = stats["latency_ms"]
    assert lat["n"] >= 6 and 0 < lat["p50"] <= lat["p90"] <= lat["p99"]


def test_bad_inputs_are_400_and_unknown_route_404(server):
    _, base = server
    assert _http_error(lambda: _post(base + "/predict", b"not an image")) \
        == 400
    assert _http_error(lambda: _post(base + "/predict", b"\0" * 100,
                                     raw=True)) == 400
    assert _http_error(lambda: urllib.request.urlopen(base + "/nope",
                                                      timeout=30)) == 404


def test_stop_drains_queued_requests():
    """stop(drain=True) answers every queued request before the model
    thread exits, and refuses submits afterwards."""
    import time

    model = SegFormerModel(config=mit_b0(**SMALL), device="cpu")
    srv = InferenceServer(model, img_size=SIZE, max_batch=2,
                          batch_window_ms=1.0)
    srv.start()
    n = 5
    results, errors = [None] * n, [None] * n

    def client(i):
        arr = np.random.default_rng(i).uniform(
            size=(SIZE, SIZE, 3)).astype(np.float32)
        try:
            results[i] = srv.submit(arr, timeout=120.0)
        except Exception as e:
            errors[i] = e

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    srv.stop(drain=True)
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(e is None for e in errors), errors
    assert all(r.shape == (SIZE, SIZE) for r in results)
    with pytest.raises(RuntimeError):
        srv.submit(np.zeros((SIZE, SIZE, 3), np.float32), timeout=1.0)


def test_main_serves_on_cpu_until_stop_requested():
    """`main` with --device cpu builds the model, warms up, serves, and
    drain-stops when a stop is requested (here before it starts)."""
    preemption.request_stop()
    try:
        serve.main(["--variant", "b0", "--img-size", "64", "--max-batch",
                    "2", "--dtype", "float32", "--port", "0",
                    "--device", "cpu"])
    finally:
        preemption.uninstall()


def test_main_without_a_card_raises(monkeypatch):
    """Without --device cpu the entry point serves on CUDA or not at all."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--variant", "b0", "--img-size", "64", "--port", "0"])


def test_main_serves_a_port_checkpoint(tmp_path, monkeypatch):
    """`--pretrain-weight` loads a checkpoint saved by the port (here by
    `SegFormerModel.save`, as the training CLIs save theirs): the served
    masks equal `SegFormerModel.load(...).predict` of the same tiles."""
    cfg = mit_b0(dtype="float32")
    trained = SegFormerModel(config=cfg, device="cpu", seed=7)
    path = str(tmp_path / "sup.pt")
    trained.save(path)
    x = np.random.default_rng(8).uniform(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    served = {}

    def serve_then_stop(srv):
        served["masks"] = np.stack([srv.submit(t, timeout=120.0) for t in x])
        srv.stop()

    monkeypatch.setattr(serve, "_serve_until_signal", serve_then_stop)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--variant", "b0", "--img-size", str(SIZE),
                    "--max-batch", "2", "--dtype", "float32", "--port", "0",
                    "--device", "cpu", "--pretrain-weight", path])
    assert "Pretrained model loaded" in out.getvalue()
    assert "randomly initialized" not in out.getvalue()
    want = SegFormerModel(config=cfg, device="cpu", seed=0)
    want.load(path)
    np.testing.assert_allclose(served["masks"], want.predict(x), atol=1e-6)
    # not the seeded weights the server would otherwise serve
    assert not np.allclose(served["masks"],
                           SegFormerModel(config=cfg, device="cpu")
                           .predict(x), atol=1e-3)


@pytest.mark.parametrize("flags", [["--artifact", "a.bin"]],
                         ids=["artifact"])
def test_main_refuses_unported_serving(flags, tmp_path, monkeypatch):
    """--artifact, ported since, serves a file written by cli/export.py
    (tests/test_torch_serving_export.py); a path that is no artifact is an
    error, and no model is built in its place."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(serve, "_serve_until_signal", lambda srv: None)
    with pytest.raises(FileNotFoundError):
        serve.main(["--variant", "b0", "--device", "cpu"] + flags)
    (tmp_path / "a.bin").write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="not a serving artifact"):
        serve.main(["--variant", "b0", "--device", "cpu"] + flags)
