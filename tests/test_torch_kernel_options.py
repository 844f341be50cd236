"""The kernels' build and options, on the CPU: the library digest of
`ops/_build.py` follows the headers a source includes; the forward's kernel
choice (`sr_attention(..., mma=)`) leaves the CPU path the plain version;
a model takes the Hopper (wgmma) forward, and so does the bfloat16 serving
model, while the float32 one takes the scalar forward;
`utils/serve_gate.py` reads the serving paths on the CPU.
No JAX: these run in well under a second each."""

import numpy as np
import pytest
import torch

from semisupervisedobjectdetection_torch import bench
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.models.segformer import (
    EfficientSelfAttention,
    SegFormer,
)
from semisupervisedobjectdetection_torch.ops import _build
from semisupervisedobjectdetection_torch.ops.sr_attention import (
    sr_attention,
    sr_attention_reference,
)
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


@pytest.mark.parametrize("mma", [False, True])
def test_mma_option_on_cpu_is_the_plain_version(mma):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, n, 64))
                                .astype(np.float32)).to(torch.bfloat16)
               for n in (33, 17, 17))
    before = sr_attention.launches, sr_attention.mma_launches
    out = sr_attention(q, k, v, 2, mma=mma)
    assert torch.equal(out, sr_attention_reference(q, k, v, 2))
    assert (sr_attention.launches, sr_attention.mma_launches) == before


def _attention_layers(model):
    return [m for m in model.modules()
            if isinstance(m, EfficientSelfAttention)]


def test_model_takes_the_tensor_core_forward():
    """The training step builds `SegFormer` from its config: every
    attention layer takes the Hopper (wgmma) bfloat16 forward."""
    layers = _attention_layers(SegFormer(bench.quick_config()))
    assert len(layers) == 4
    assert all(m.attn_impl == "kernel" and m.attn_fwd_mma for m in layers)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_model_takes_the_hopper_forward_in_bf16(dtype):
    """bfloat16 serving runs the Hopper forward in every attention layer,
    held to the float32 model by chip_smoke's serve gate; float32 serving
    keeps the scalar forward (the flag reads true only where the Hopper
    kernel runs)."""
    cfg = MiTConfig(depths=(1, 2, 1, 1), hidden_sizes=(8, 16, 32, 64),
                    num_heads=(1, 2, 4, 8), decoder_hidden=16, dtype=dtype)
    layers = _attention_layers(SegFormerModel(config=cfg,
                                              device="cpu").model)
    assert len(layers) == 5
    assert [m.attn_fwd_mma for m in layers] == [dtype == "bfloat16"] * 5


def test_serve_gate_readings_on_cpu():
    """`utils/serve_gate.py` on the CPU, where every bfloat16 path runs the
    plain attention: no pixel flips against the plain path, and each path
    has its readings against float32."""
    cfg = MiTConfig(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
                    num_heads=(1, 2, 4, 8), decoder_hidden=16)
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    out = serve_gate.compare(cfg, x, device=torch.device("cpu"))
    assert out["mask_flip_vs_plain"] == {"served": 0.0, "scalar": 0.0}
    assert out["max_abs_err_vs_plain"] == {"served": 0.0, "scalar": 0.0}
    for key in ("mask_flip_vs_float32", "mean_abs_err_vs_float32"):
        assert set(out[key]) == {"served", "scalar", "plain"}
        assert all(0.0 <= v <= 1.0 for v in out[key].values())
    assert list(out["float32_abs_minus_half_quantiles"]) == [
        "0.001", "0.01", "0.1", "0.5"]
