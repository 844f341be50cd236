"""Serving artifacts: the eval-mode predict, exported by `torch.export` at
one pinned input shape, in one file. The counterpart of the JAX package's
`checkpoint/serving_export.py`.

The exported program maps float32 NHWC images (batch, H, W, C) to float32
sigmoid masks through the same serving model that `SegFormerModel.predict`
runs (the bfloat16 or float32 serving copy, or an int8/fp8 snapshot), its
weights held in the program. A file holds one program per platform
(`platforms`: "cuda", "cpu" or both; by default both, as the JAX package's
default holds "cpu" and "tpu"): each is traced with the model and an example
input on that platform's device, so its weights and any tensor its graph
makes live there, and a process loads only the program of its device.

File layout:

    8-byte magic  b"SSODTRC1"
    u32 little-endian header length
    header JSON   {"batch", "img_size", "channels", "num_labels",
                   "platforms", "quant", "torch_version", "sizes"}
    the `torch.export.save` bytes of each platform's program, in the
    order of "platforms" ("sizes" gives their lengths)

What differs from a JAX artifact, which runs without any model code: the
graph calls the operator `ssod::sr_attention_fwd` (K1, `ops/sr_attention.py`)
wherever the model runs the SR-attention kernel, so the loading process
must have the port's operator library registered (`load_serving` imports
it), and the program is read by the torch release that wrote it
(`torch_version` in the header). int8 and fp8 snapshots export through
`torch._int_mm` and `torch._scaled_mm` on the card (aten operators); their
plain products on the CPU.

`ExportedPredictor.predict` zero-pads a partial batch to the exported batch
and slices the result back (one program, no re-export per size), and
refuses a larger batch or another image shape, with the JAX package's
messages; `cli/serve.py --artifact` serves it.
"""

from __future__ import annotations

import copy
import io
import json
import struct
from typing import Sequence

import numpy as np
import torch
from torch import nn

# registers ssod::sr_attention_fwd (and its backward) for export and load
from semisupervisedobjectdetection_torch.ops import sr_attention  # noqa: F401
from semisupervisedobjectdetection_torch.models.segformer import (
    forward_masks,
)
from semisupervisedobjectdetection_torch.utils.device import resolve_device

_MAGIC = b"SSODTRC1"
PLATFORMS = ("cuda", "cpu")


class _Predict(nn.Module):
    """The serving closure: float32 NHWC images -> float32 sigmoid masks,
    eval mode."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward_masks(self.model, images)[0].float()


def _check_platforms(platforms: Sequence[str]) -> list:
    plats = [p for p in platforms if p]
    if not plats or any(p not in PLATFORMS for p in plats) \
            or len(set(plats)) != len(plats):
        raise ValueError(f"platforms must be distinct names from "
                         f"{PLATFORMS}, got {list(platforms)}")
    return plats


def _on(model: nn.Module, device: torch.device) -> nn.Module:
    """`model` itself when it lives on `device`, else a copy moved there
    (the caller's model stays where it is)."""
    here = next(model.parameters()).device
    if here.type == device.type:
        return model
    return copy.deepcopy(model).to(device)


def _export_program(model: nn.Module, device: torch.device,
                    shape: tuple) -> bytes:
    example = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(_Predict(_on(model, device)).eval(),
                                      (example,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_serving(cfg, model: nn.Module, path: str, *, batch_size: int,
                   img_size: int = 512, channels: int = 3,
                   platforms: Sequence[str] = PLATFORMS) -> dict:
    """Export the eval-mode predict of the serving model `model` (config
    `cfg`: its `quant` is recorded) at the pinned shape (batch_size,
    img_size, img_size, channels) for each of `platforms`, and write the
    artifact to `path`. Returns the header."""
    plats = _check_platforms(platforms)
    size = int(img_size)
    shape = (int(batch_size), size, size, int(channels))
    blobs = [_export_program(model, resolve_device(p), shape)
             for p in plats]
    header = {
        "batch": shape[0],
        "img_size": size,
        "channels": shape[3],
        "num_labels": int(cfg.num_labels),
        "platforms": plats,
        "quant": cfg.quant,
        "torch_version": torch.__version__,
        "sizes": [len(b) for b in blobs],
    }
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(hdr)))
        f.write(hdr)
        for blob in blobs:
            f.write(blob)
    return header


def _read_header(f, path: str) -> dict:
    magic = f.read(len(_MAGIC))
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a serving artifact (magic {magic!r})")
    (n,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(n))


def read_header(path: str) -> dict:
    """The artifact's header, without reading its programs."""
    with open(path, "rb") as f:
        return _read_header(f, path)


class ExportedPredictor:
    """A loaded artifact on `device`, with the `predict(batch) -> masks`
    surface that `cli/serve.py`'s server and `eval/sliding_window.py`
    take, and the `device` and `quant` its /healthz reports."""

    def __init__(self, header: dict, program, device: torch.device):
        self.header = header
        self.batch = header["batch"]
        self.img_size = header["img_size"]
        self.quant = header.get("quant") or "none"
        self.device = device
        self._module = program.module()

    def predict(self, images) -> np.ndarray:
        """Masks of a (B, H, W, C) float batch (or one (H, W, C) image),
        B at most the exported batch: a smaller batch is zero-padded to the
        exported shape and the result sliced back."""
        arr = np.asarray(images, np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        b = arr.shape[0]
        if b > self.batch:
            raise ValueError(
                f"batch {b} exceeds the artifact's compiled batch "
                f"{self.batch}; split the batch or re-export")
        if arr.shape[1:] != (self.img_size, self.img_size,
                             self.header["channels"]):
            raise ValueError(
                f"input shape {arr.shape[1:]} != compiled "
                f"({self.img_size}, {self.img_size}, "
                f"{self.header['channels']})")
        if b < self.batch:
            pad = np.zeros((self.batch - b,) + arr.shape[1:], np.float32)
            arr = np.concatenate([arr, pad], axis=0)
        with torch.inference_mode():
            out = self._module(torch.from_numpy(arr).to(self.device))
        return out.cpu().numpy()[:b]


def load_serving(path: str, device=None) -> ExportedPredictor:
    """Load the program of `device`'s platform (the CUDA card unless
    device="cpu") from the artifact at `path`. Raises when the file holds
    no program for it, as the JAX package refuses a backend the artifact
    was not lowered for."""
    dev = torch.device("cuda" if device is None else device)
    with open(path, "rb") as f:
        header = _read_header(f, path)
        if dev.type not in header["platforms"]:
            raise ValueError(
                f"artifact was exported for {header['platforms']}, but "
                f"this process serves on {dev.type!r}; re-export with "
                f"platforms including it")
        i = header["platforms"].index(dev.type)
        f.seek(sum(header["sizes"][:i]), io.SEEK_CUR)
        blob = f.read(header["sizes"][i])
    dev = resolve_device(dev)
    program = torch.export.load(io.BytesIO(blob))
    return ExportedPredictor(header, program, dev)
