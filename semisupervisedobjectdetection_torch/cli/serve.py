"""HTTP inference server: serve SegFormer over REST on one CUDA card.

The port of the JAX package's `cli/serve.py`, with the same behaviour:

- **One batch shape.** Requests are decoded on HTTP worker threads and
  queued; one model thread drains the queue into batches of exactly
  ``--max-batch`` images, zero-padding partial ones, so the card always
  sees the shape it was warmed up on.
- **Dynamic batching.** The model thread waits up to ``--batch-window-ms``
  after the first queued request for more to arrive, so concurrent clients
  share a forward while a lone request sees little queueing delay.
- **Single device owner.** All model work happens on the one model thread.

- **Quantized serving.** ``--int8`` or ``--fp8`` serves the model's
  quantized snapshot (`SegFormerModel.quantize`: per-channel int8 or e4m3
  dense weights, per-token activations, on the card's int8 and fp8
  GEMMs); ``--int8-snapshot FILE`` loads the snapshot when the file is
  there (its width read from the stored dtypes), else writes it after
  quantizing, so that a serving process needs no float checkpoint.
- **Serving artifacts.** ``--artifact FILE`` serves a file written by
  `cli/export.py` (`SegFormerModel.export_serving`): the exported predict
  of the artifact's platform for ``--device``, its weights in the file, no
  checkpoint or model build; ``--max-batch`` and ``--img-size`` come from
  its header.

Endpoints:
  GET  /healthz  -> {"status": "ok", "platform", "device", "device_name",
                     "variant", "img_size", "max_batch", "quant", "int8"}
  GET  /stats    -> request/batch counters, mean batch fill, latency
                    p50/p90/p99 (ms)
  POST /predict  -> body: PNG/JPEG image (any size; resized to the model's
                    input, mask resized back), OR Content-Type:
                    application/octet-stream with one raw uint8 HWC image
                    of exactly img_size x img_size x 3 (no codec).
                    Query: ?format=png (default for image bodies; binarized
                    L mask), ?format=npy (float32 probability map) or
                    ?format=raw (default for octet-stream bodies; uint8
                    binarized mask bytes, shape in X-Mask-Shape),
                    &threshold=0.5 (binarize level).

Run: python -m semisupervisedobjectdetection_torch.cli.serve --variant b5 \
         [--pretrain-weight <a checkpoint of this package's training CLIs>]

The weights are seeded random ones unless --pretrain-weight (a `.pt`
checkpoint of the port's CLIs, loaded as `SegFormerModel.load` does) or
--hf-weights is given.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from semisupervisedobjectdetection_torch.utils.device import device_name


class _Pending:
    """A queued request: input array + a slot for the result."""

    __slots__ = ("arr", "done", "result", "error")

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self.done = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class InferenceServer:
    """Batching HTTP server around a `SegFormerModel`-like object.

    `model` needs a `predict(batch_nhwc) -> (B,H,W) float` method and may
    have a `device` (a `torch.device`) and a `quant` ("none", "int8" or
    "fp8"), which /healthz reports.
    """

    def __init__(self, model, img_size: int, max_batch: int = 8,
                 batch_window_ms: float = 5.0, variant: str = "?"):
        self.model = model
        self.img_size = int(img_size)
        self.max_batch = max(int(max_batch), 1)
        self.batch_window_s = batch_window_ms / 1e3
        self.variant = variant
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._httpd = None
        self._threads: list = []
        self.stats = {"requests": 0, "batches": 0, "errors": 0,
                      "images_in_batches": 0}
        self._stats_lock = threading.Lock()
        # end-to-end submit latencies (seconds), the last 1024
        self._lat = deque(maxlen=1024)

    # ---------------------------------------------------------- model thread
    def _warmup(self) -> None:
        z = np.zeros((self.max_batch, self.img_size, self.img_size, 3),
                     np.float32)
        self.model.predict(z)

    def _model_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._draining.is_set():
                    return   # graceful stop: queue drained, we are done
                continue
            batch = [first]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < self.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=wait))
                except queue.Empty:
                    break
            n = len(batch)
            padded = np.zeros(
                (self.max_batch, self.img_size, self.img_size, 3),
                np.float32)
            for i, p in enumerate(batch):
                padded[i] = p.arr
            try:
                masks = np.asarray(self.model.predict(padded))
                for i, p in enumerate(batch):
                    p.result = masks[i]
            except Exception as e:  # surface per request, keep serving
                for p in batch:
                    p.error = e
                with self._stats_lock:
                    self.stats["errors"] += n
            finally:
                for p in batch:
                    p.done.set()
                with self._stats_lock:
                    self.stats["batches"] += 1
                    self.stats["images_in_batches"] += n

    def submit(self, arr: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        """Queue one (H,W,3) float image sized to img_size; block for the
        (img_size, img_size) probability mask."""
        if self._draining.is_set() or self._stop.is_set():
            raise RuntimeError("server is shutting down")
        t0 = time.monotonic()
        p = _Pending(arr)
        self._q.put(p)
        with self._stats_lock:
            self.stats["requests"] += 1
        if not p.done.wait(timeout):
            raise TimeoutError("predict timed out")
        if p.error is not None:
            raise p.error
        with self._stats_lock:
            self._lat.append(time.monotonic() - t0)
        return p.result

    def health(self) -> dict:
        dev = getattr(self.model, "device", None)
        quant = getattr(self.model, "quant", "none")
        return {
            "status": "ok",
            "platform": dev.type if dev is not None else "?",
            "device": str(dev),
            "device_name": device_name(dev) if dev is not None else "?",
            "variant": self.variant,
            "img_size": self.img_size,
            "max_batch": self.max_batch,
            "quant": quant,
            "int8": quant == "int8",
        }

    def snapshot_stats(self) -> dict:
        with self._stats_lock:
            s = dict(self.stats)
            lat = sorted(self._lat)
        s["mean_batch_fill"] = (s["images_in_batches"] / s["batches"]
                                if s["batches"] else 0.0)
        if lat:
            def q(p):
                return round(lat[min(int(p * (len(lat) - 1)),
                                     len(lat) - 1)] * 1e3, 2)
            s["latency_ms"] = {"p50": q(0.50), "p90": q(0.90),
                               "p99": q(0.99), "n": len(lat)}
        return s

    # ------------------------------------------------------------- http part
    def _make_handler(server):  # noqa: N805 — bound as a class factory
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet; stats carry the signal
                pass

            def _json(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/healthz":
                    self._json(200, server.health())
                elif path == "/stats":
                    self._json(200, server.snapshot_stats())
                else:
                    self._json(404, {"error": f"no route {path}"})

            def do_POST(self):
                from PIL import Image

                path, _, qs = self.path.partition("?")
                if path != "/predict":
                    self._json(404, {"error": f"no route {path}"})
                    return
                params = {}
                for kv in qs.split("&"):
                    if "=" in kv:
                        k, _, v = kv.partition("=")
                        params[k] = v
                # media types are case-insensitive (RFC 9110 §8.3.1)
                raw_input = self.headers.get(
                    "Content-Type", "").split(";")[0].strip().lower() \
                    == "application/octet-stream"
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(length)
                    if raw_input:
                        # one uint8 HWC image at exactly the input size:
                        # no PNG/JPEG decode or resize on the host
                        s = server.img_size
                        expect = s * s * 3
                        if length != expect:
                            raise ValueError(
                                f"raw payload must be uint8 HWC "
                                f"({s}x{s}x3 = {expect} bytes), "
                                f"got {length}")
                        arr = np.frombuffer(raw, np.uint8).reshape(
                            s, s, 3).astype(np.float32) / 255.0
                        orig_w = orig_h = s
                    else:
                        img = Image.open(io.BytesIO(raw)).convert("RGB")
                        orig_w, orig_h = img.size
                        resized = img.resize(
                            (server.img_size, server.img_size),
                            Image.BILINEAR)
                        arr = np.asarray(resized, np.float32) / 255.0
                except Exception as e:
                    self._json(400, {"error": f"bad image: {e}"})
                    return
                try:
                    mask = server.submit(arr)
                except Exception as e:
                    self._json(500, {"error": str(e)})
                    return
                # raw input defaults to raw output (no codec either way)
                fmt = params.get("format", "raw" if raw_input else "png")
                mask_h = mask_w = server.img_size
                if fmt != "npy":
                    # binarized 0/255 mask at the ORIGINAL image size
                    thr = float(params.get("threshold", 0.5))
                    m = (np.asarray(mask) >= thr).astype(np.uint8) * 255
                    if (orig_h, orig_w) != m.shape:
                        m = np.asarray(Image.fromarray(m, mode="L").resize(
                            (orig_w, orig_h), Image.NEAREST))
                    mask_h, mask_w = m.shape
                if fmt == "raw":
                    body = m.tobytes()
                    ctype = "application/octet-stream"
                elif fmt == "npy":
                    buf = io.BytesIO()
                    np.save(buf, np.asarray(mask, np.float32))
                    body = buf.getvalue()
                    ctype = "application/octet-stream"
                else:
                    buf = io.BytesIO()
                    Image.fromarray(m, mode="L").save(buf, format="PNG")
                    body = buf.getvalue()
                    ctype = "image/png"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if fmt == "raw":
                    # raw bytes carry no shape (npy and png do)
                    self.send_header("X-Mask-Shape", f"{mask_h}x{mask_w}")
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Warm up the predict, start the model thread and a threading HTTP
        server; returns the bound port (ephemeral if 0)."""
        from http.server import ThreadingHTTPServer

        self._warmup()
        t = threading.Thread(target=self._model_loop, daemon=True,
                             name="sso-serve-model")
        t.start()
        self._threads.append(t)
        self._httpd = ThreadingHTTPServer((host, port),
                                          self._make_handler())
        ht = threading.Thread(target=self._httpd.serve_forever,
                              daemon=True, name="sso-serve-http")
        ht.start()
        self._threads.append(ht)
        return self._httpd.server_address[1]

    def stop(self, drain: bool = True) -> None:
        """Stop serving. With `drain` (default) the HTTP listener closes
        first (no new requests land), then the model thread answers
        everything already queued before exiting. `drain=False` aborts
        at once (queued requests hit their submit timeout)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if drain:
            self._draining.set()
            for t in self._threads:
                if t.name == "sso-serve-model":
                    t.join(timeout=120.0)
        self._stop.set()


def _serve_until_signal(srv: InferenceServer) -> None:
    """Block until SIGTERM/SIGINT, then drain-stop: the listener closes,
    queued predicts finish, exit 0."""
    from semisupervisedobjectdetection_torch.utils import preemption

    preemption.install()
    try:
        while not preemption.stop_requested():
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    print(f"\nshutting down ({preemption.signal_name()}): draining "
          "in-flight requests", flush=True)
    srv.stop(drain=True)
    print("drained; bye", flush=True)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Serve SegFormer over HTTP (POST /predict with a "
                    "PNG/JPEG body or a raw uint8 HWC tensor).")
    p.add_argument("--variant", default="b5")
    p.add_argument("--img-size", type=int, default=512)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--pretrain-weight",
                   help="checkpoint (.pt) written by one of this package's "
                        "training CLIs, loaded through SegFormerModel.load; "
                        "a checkpoint of the JAX package (orbax) is "
                        "converted first on a host with JAX, by "
                        "checkpoint/convert.py::state_dict_from_flax")
    p.add_argument("--hf-weights",
                   help="torch .pth/.safetensors SegFormer weights")
    p.add_argument("--artifact",
                   help="serving artifact (cli.export / SegFormerModel."
                        "export_serving): serves its exported predict, no "
                        "checkpoint or model build")
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 snapshot (per-channel int8 dense "
                        "weights, per-token activations, int8 GEMMs)")
    p.add_argument("--fp8", action="store_true",
                   help="serve an fp8 (e4m3) snapshot (fp8 GEMMs)")
    p.add_argument("--int8-snapshot",
                   help="with --int8/--fp8: snapshot file, loaded if it "
                        "exists (width from its dtypes), else written after "
                        "quantize()")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--perf", action="store_true",
                   help="tanh-approx GELU")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' to "
                        "run without a card)")
    args = p.parse_args(argv)
    import torch

    # float32 serving computes in float32: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.artifact:
        import os

        from semisupervisedobjectdetection_torch.checkpoint.serving_export \
            import load_serving

        predictor = load_serving(args.artifact, args.device)
        hdr = predictor.header
        srv = InferenceServer(
            predictor, img_size=hdr["img_size"], max_batch=hdr["batch"],
            batch_window_ms=args.batch_window_ms,
            variant=f"artifact:{os.path.basename(args.artifact)}")
        port = srv.start(args.host, args.port)
        print(f"serving artifact {args.artifact} on "
              f"http://{args.host}:{port}  ({predictor.device}, batch "
              f"{hdr['batch']}, quant {predictor.quant})", flush=True)
        _serve_until_signal(srv)
        return
    if args.int8 and args.fp8:
        raise SystemExit("--int8 and --fp8 are mutually exclusive")
    quant = "fp8" if args.fp8 else ("int8" if args.int8 else "none")
    if args.int8_snapshot and quant == "none":
        raise SystemExit("--int8-snapshot needs --int8 or --fp8")

    from semisupervisedobjectdetection_torch.api import SegFormerModel
    from semisupervisedobjectdetection_torch.core.config import MIT_VARIANTS

    cfg = MIT_VARIANTS[args.variant](dtype=args.dtype,
                                     gelu_approx=args.perf)
    model = SegFormerModel(pretrain_weight=args.pretrain_weight,
                           config=cfg, hf_weights=args.hf_weights,
                           device=args.device)
    if not (args.pretrain_weight or args.hf_weights):
        print("WARNING: serving randomly initialized weights "
              "(no --pretrain-weight / --hf-weights)")
    if quant != "none":
        model.load_or_quantize(quant, args.int8_snapshot)
    srv = InferenceServer(model, img_size=args.img_size,
                          max_batch=args.max_batch,
                          batch_window_ms=args.batch_window_ms,
                          variant=args.variant)
    port = srv.start(args.host, args.port)
    print(f"serving {args.variant} on http://{args.host}:{port}  "
          f"({model.device}, batch {args.max_batch}, window "
          f"{args.batch_window_ms}ms"
          + (f", {model.quant}" if model.quant != "none" else "") + ")",
          flush=True)
    _serve_until_signal(srv)


if __name__ == "__main__":
    main()
