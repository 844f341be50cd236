"""K1 and K2 as `torch.library` operators (`ssod::sr_attention_fwd`,
`ssod::sr_attention_bwd`, `ops/sr_attention.py`) on the CPU: the operator
path's forward and gradients equal the operator bodies' own results (the
call path before the operators) bit for bit, `torch.library.opcheck`
passes on both operators (schema, fake implementation, autograd
registration, AOT dispatch), the fake implementations give the outputs'
shapes and dtypes without running the body, and a CPU call launches
nothing. The bodies are held against the JAX package by
tests/test_torch_sr_attention.py and tests/test_torch_sr_attention_bwd.py;
on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from semisupervisedobjectdetection_torch.ops import sr_attention as sra
from test_torch_segformer import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(2, 40, 9, 64, 2), (1, 33, 17, 32, 1)]


def _inputs(b, nq, nk, c, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(b, n, c)).astype(np.float32))
            .to(dtype) for n in (nq, nk, nk, nq)]


@pytest.mark.parametrize("b,nq,nk,c,h", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operator_path_equals_the_bodies(b, nq, nk, c, h, dtype):
    q, k, v, g = _inputs(b, nq, nk, c, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sra.sr_attention(*leaves, h)
    out.backward(g)
    assert torch.equal(out.detach(), sra._forward(q, k, v, h))
    for got, want in zip((t.grad for t in leaves),
                         sra._backward(q, k, v, g, h)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for got, want in zip(sra.sr_attention_bwd(q, k, v, g, h),
                         sra._backward(q, k, v, g, h)):
        assert torch.equal(got, want)


def test_opcheck_both_operators():
    b, nq, nk, c, h = SHAPES[0]
    q, k, v, g = _inputs(b, nq, nk, c)
    fwd = torch.ops.ssod.sr_attention_fwd.default
    bwd = torch.ops.ssod.sr_attention_bwd.default
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    for op, args in ((fwd, (*leaves, h)), (fwd, (q, k, v, h)),
                     (bwd, (q, k, v, g, h))):
        result = torch.library.opcheck(op, args)
        assert all(v == "SUCCESS" for v in result.values()), result


def test_fake_implementations_give_shapes_and_dtypes(monkeypatch):
    """Under fake tensors (what `torch.export` traces with) the operators
    give q's shape and dtype and (dq, dk, dv) in the inputs' shapes and
    dtypes, and the bodies never run."""
    def boom(*args):
        raise AssertionError("a body ran on fake tensors")

    monkeypatch.setattr(sra, "_forward", boom)
    monkeypatch.setattr(sra, "_backward", boom)
    with FakeTensorMode():
        q = torch.empty(2, 40, 64, dtype=torch.bfloat16)
        k = torch.empty(2, 9, 64, dtype=torch.bfloat16)
        out = torch.ops.ssod.sr_attention_fwd(q, k, k, 2)
        dq, dk, dv = torch.ops.ssod.sr_attention_bwd(q, k, k, q, 2)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert {dq.dtype, dk.dtype, dv.dtype} == {torch.bfloat16}


def test_cpu_operator_calls_launch_nothing():
    q, k, v, g = _inputs(*SHAPES[1][:4])
    before = (sra.sr_attention.launches, sra.sr_attention_bwd.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    sra.sr_attention(*leaves, 1).backward(g)
    assert (sra.sr_attention.launches,
            sra.sr_attention_bwd.launches) == before
