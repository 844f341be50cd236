"""Card-only tests of the port's CUDA kernel: `sr_attention_fwd` against its
plain version on the card. Marked `cuda`; each skips without a CUDA device
(decided in a fixture, not at import). On a machine with a card and no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from semisupervisedobjectdetection_torch.ops.sr_attention import (
    sr_attention,
    sr_attention_reference,
)

pytestmark = pytest.mark.cuda

# bfloat16: one or two output ulps where a sum rounds the other way
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(cuda, b, nq, nk, c, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(b, n, c, device=cuda, generator=g).to(dtype)
            for n in (nq, nk, nk)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,c,h", [
    (2, 256, 256, 64, 1),      # square, aligned
    (1, 1030, 266, 64, 1),     # prompt prefix, ragged query tail
    (2, 131, 96, 128, 2),      # multi-head, unaligned nk
    (2, 77, 257, 320, 5),      # CLS prefix, B1-B5 stage-3 heads
    (2, 300, 5, 32, 1),        # B0 head width, tiny key stream
])
def test_kernel_matches_plain(cuda, dtype, b, nq, nk, c, h):
    q, k, v = _qkv(cuda, b, nq, nk, c, dtype)
    before = sr_attention.launches
    out = sr_attention(q, k, v, h)
    torch.cuda.synchronize()
    assert sr_attention.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = sr_attention_reference(q, k, v, h)
    assert (out.float() - ref.float()).abs().max().item() <= TOL[dtype]


def test_kernel_rejects_what_it_cannot_run(cuda):
    q, k, v = _qkv(cuda, 1, 16, 8, 48, torch.float32)
    with pytest.raises(ValueError, match="head width"):
        sr_attention(q, k, v, 1)                      # d = 48
    q, k, v = _qkv(cuda, 1, 16, 300, 64, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        sr_attention(q, k, v, 1)                      # nk = 300
    q, k, v = _qkv(cuda, 1, 16, 8, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sr_attention(q, k, v, 1)
    q, k, v = _qkv(cuda, 1, 16, 8, 128, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        sr_attention(q[..., :64], k[..., :64], v[..., :64], 1)
