"""The kernels' build and choice, on the CPU: the library digest of
`ops/_build.py` follows the headers a source includes; the forward's kernel
follows the dtype of the tensors a model sends it (training and serving
models, in bfloat16 and float32); the kernel-shape refusals follow the
config's head width alone (both dtypes take any Nk: bfloat16 streams K/V
past 288 keys); the bfloat16 forward's kernel follows Nk;
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
    attention_shapes,
    check_attention_kernels,
)
from semisupervisedobjectdetection_torch.ops import _build
from semisupervisedobjectdetection_torch.ops import sr_attention as sra
from semisupervisedobjectdetection_torch.ops.sr_attention import (
    bwd_launch_plan,
)
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
    training steps' forward of `x` (NHWC float32), read in the body of the
    forward operator (`_forward`)."""
    seen = []
    fwd = sra._forward

    def record(q, k, v, num_heads):
        seen.append(q.dtype)
        return fwd(q, k, v, num_heads)

    monkeypatch.setattr(sra, "_forward", record)
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
    at 1024x1024 (Nk 1024 at stage 1) passes in both dtypes: float32
    streams K/V in blocks, and so does bfloat16 past 288 keys."""
    cfg = mit_b5(dtype=dtype, prompt_tokens=(tokens,) * 4)
    nk = 256 + tokens if size == 512 else 1024
    assert attention_shapes(cfg, size, size)[0][1] == nk
    check_attention_kernels(cfg, size, size, torch.device("cuda"))


@pytest.mark.parametrize("tokens", [40, 100, 768])
def test_bf16_check_takes_any_nk_on_cuda(tokens):
    """bfloat16 at Nk 296, 356 and 1024 (40, 100 and 768 prompt tokens per
    stage at 512x512): the check that refused Nk > 288 takes them all."""
    cfg = mit_b5(dtype="bfloat16", prompt_tokens=(tokens,) * 4)
    assert {nk for _, nk, _ in attention_shapes(cfg, 512, 512)} == {
        256 + tokens}
    check_attention_kernels(cfg, 512, 512, torch.device("cuda"))


def test_check_still_refuses_a_head_width_outside_head_dims():
    """A head width the kernels do not take (48) is refused on the card,
    at any Nk, and taken on the CPU and by the plain attention."""
    cfg = mit_b5(dtype="bfloat16", prompt_tokens=(100,) * 4).replace(
        hidden_sizes=(48, 128, 320, 512))
    assert attention_shapes(cfg, 512, 512)[0][2] == 48 not in sra.HEAD_DIMS
    with pytest.raises(ValueError, match=r"stage 0: head width 48; the "
                                         r"SR-attention kernels take \(32, "
                                         r"64\)"):
        check_attention_kernels(cfg, 512, 512, torch.device("cuda"))
    check_attention_kernels(cfg, 512, 512, torch.device("cpu"))
    check_attention_kernels(cfg.replace(attn_impl="plain"), 512, 512,
                            torch.device("cuda"))


@pytest.mark.parametrize("nk,streams", [(1, False), (288, False),
                                        (289, True), (1024, True)])
def test_bf16_forward_kernel_follows_nk(nk, streams):
    """bfloat16 keeps K/V on chip up to `BF16_ON_CHIP_NK` (288) keys and
    streams them past it, in both directions (the backward's launch plan
    says so too); float32 has one design at every Nk."""
    assert sra.BF16_ON_CHIP_NK == 288
    assert sra.streams_bf16(torch.bfloat16, nk) == streams
    assert bwd_launch_plan(2, 100, nk, 64, 1)["stream"] == streams
    assert not sra.streams_bf16(torch.float32, nk)
    assert sra.FWD_STREAM_KERNEL == "sr_attention_fwd_wgmma_stream_kernel"


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
