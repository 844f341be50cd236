"""The kernels' build and choice, on the CPU: the library digest of
`ops/_build.py` follows the headers a source includes; the forward's kernel
follows the dtype of the tensors a model sends it (training and serving
models, in bfloat16 and float32); the kernel-shape refusals follow the
config's dtype (bfloat16 refuses Nk > 288, float32 takes any Nk);
`utils/serve_gate.py` reads the serving paths on the CPU.
No JAX: these run in well under a second each."""

import numpy as np
import pytest
import torch

from semisupervisedobjectdetection_torch import bench
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.core.config import MiTConfig, mit_b5
from semisupervisedobjectdetection_torch.models.segformer import (
    EfficientSelfAttention,
    SegFormer,
    check_attention_kernels,
)
from semisupervisedobjectdetection_torch.ops import _build
from semisupervisedobjectdetection_torch.ops import sr_attention as sra
from semisupervisedobjectdetection_torch.train.common import forward_masks
from semisupervisedobjectdetection_torch.utils import serve_gate


def _sources(tmp_path):
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n'
                                   '#include "a.cuh"\n__global__ void f() {}\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    return tmp_path / "k.cu"


def test_digest_follows_included_headers(tmp_path):
    src = _sources(tmp_path)
    assert [p.name for p in _build.source_files(src)] == [
        "k.cu", "a.cuh", "b.cuh"]
    before = _build.source_digest(src)
    (tmp_path / "other.cuh").write_text("// edited\n")
    assert _build.source_digest(src) == before
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.source_digest(src) != before


@pytest.mark.parametrize("source", ["sr_attention_fwd.cu",
                                    "sr_attention_bwd.cu"])
def test_kernel_sources_hash_the_shared_header(source):
    names = [p.name for p in _build.source_files(_build.CSRC / source)]
    assert names == [source, "sr_attention_wgmma.cuh"]


def _attention_layers(model):
    return [m for m in model.modules()
            if isinstance(m, EfficientSelfAttention)]


def _attention_dtypes(model, x, monkeypatch):
    """The dtypes of the q tensors `model`'s SR-attention calls take in the
    training steps' forward of `x` (NHWC float32), read in `SRAttention`'s
    forward."""
    seen = []
    fwd = sra.SRAttention.forward

    def record(ctx, q, k, v, num_heads):
        seen.append(q.dtype)
        return fwd(ctx, q, k, v, num_heads)

    monkeypatch.setattr(sra.SRAttention, "forward", staticmethod(record))
    with torch.no_grad():
        forward_masks(model, x)
    return seen


def test_model_takes_the_tensor_core_forward(monkeypatch):
    """The training step builds `SegFormer` from its config: every
    attention layer takes the kernel path, and the forward kernel it
    reaches is the one of its config's dtype (the quick config's float32:
    the 3xTF32 kernel, on the tensor cores like the bfloat16 one)."""
    cfg = bench.quick_config()
    model = SegFormer(cfg)
    layers = _attention_layers(model)
    assert len(layers) == 4 and all(m.attn_impl == "kernel"
                                    for m in layers)
    dtypes = _attention_dtypes(model, torch.rand(1, 64, 64, 3), monkeypatch)
    assert cfg.dtype == "float32" and dtypes == [torch.float32] * 4
    assert sra.FWD_KERNELS[dtypes[0]] == "sr_attention_fwd_f32_kernel"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_model_takes_the_hopper_forward_in_bf16(dtype, monkeypatch):
    """The serving copy sends every attention layer tensors of its
    config's dtype, so the forward kernel follows the dtype: the bfloat16
    wgmma kernel in bfloat16 (held to the float32 model by chip_smoke's
    serve gate), the float32 3xTF32 kernel in float32."""
    cfg = MiTConfig(depths=(1, 2, 1, 1), hidden_sizes=(8, 16, 32, 64),
                    num_heads=(1, 2, 4, 8), decoder_hidden=16, dtype=dtype)
    served = SegFormerModel(config=cfg, device="cpu").model
    assert len(_attention_layers(served)) == 5
    dtypes = _attention_dtypes(served, torch.rand(1, 64, 64, 3), monkeypatch)
    assert dtypes == [getattr(torch, dtype)] * 5
    assert sra.FWD_KERNELS[dtypes[0]] == {
        "bfloat16": "sr_attention_fwd_wgmma_kernel",
        "float32": "sr_attention_fwd_f32_kernel"}[dtype]


@pytest.mark.parametrize("size,tokens", [(512, 100), (1024, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_refusals_follow_the_dtype(dtype, size, tokens):
    """`check_attention_kernels` on a CUDA device (it reads only the device
    type): MiT-B5 with 100 prompt tokens per stage at 512x512 (Nk 356) and
    at 1024x1024 (Nk 1024 at stage 1) passes in float32, whose kernels take
    any Nk, and is refused in bfloat16 with the bf16 limit's message."""
    cfg = mit_b5(dtype=dtype, prompt_tokens=(tokens,) * 4)
    device = torch.device("cuda")
    if dtype == "float32":
        check_attention_kernels(cfg, size, size, device)
        return
    nk = 256 + tokens if size == 512 else 1024
    with pytest.raises(ValueError,
                       match=f"stage 0: SR-attention over Nk={nk} keys .*"
                             f"the kernels take Nk <= {sra.MAX_NK}"):
        check_attention_kernels(cfg, size, size, device)


def test_serve_gate_readings_on_cpu():
    """`utils/serve_gate.py` on the CPU, where every bfloat16 path runs the
    plain attention: no pixel flips against the plain path, and each path
    has its readings against float32."""
    cfg = MiTConfig(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
                    num_heads=(1, 2, 4, 8), decoder_hidden=16)
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    out = serve_gate.compare(cfg, x, device=torch.device("cpu"))
    assert out["mask_flip_vs_plain"] == {"served": 0.0}
    assert out["max_abs_err_vs_plain"] == {"served": 0.0}
    for key in ("mask_flip_vs_float32", "mean_abs_err_vs_float32"):
        assert set(out[key]) == {"served", "plain"}
        assert all(0.0 <= v <= 1.0 for v in out[key].values())
    assert list(out["float32_abs_minus_half_quantiles"]) == [
        "0.001", "0.01", "0.1", "0.5"]
