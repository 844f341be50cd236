"""The port's quantized serving path (`semisupervisedobjectdetection_torch/
ops/quant.py`, `QLinear` in the model) against the JAX package's
`ops/quant.py` on the CPU, where each product runs its plain version:

- int8 and fp8 weights and scales bit-equal to JAX's, eager, no `jax.jit`;
- the int8 product bit-equal, the fp8 product within 1e-5 of each output's
  largest value (both sum exact e4m3 products in float32, in other orders);
- the port quantizes exactly the leaves that JAX's `quantize_dense_params`
  quantizes, to the same bits, mapped through the weight bridge;
- the int8 and fp8 forwards of a tiny float32 config against JAX's
  `SegFormer(qcfg).apply` (one jit of both widths, in a module fixture).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu.core.config import MiTConfig as JCfg
from semisupervisedobjectdetection_tpu.models.segformer import (
    SegFormer as JSegFormer,
    predict_masks as jax_predict_masks,
)
from semisupervisedobjectdetection_tpu.ops import quant as jquant
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    cast_to_compute_dtype,
    forward_masks,
)
from semisupervisedobjectdetection_torch.ops import quant
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    SIZE,
    jax_variables,
    one_torch_thread,
)

# Depth 1, widths in multiples of 16 (what the card's fp8 GEMM takes), one
# width in every stage: the eager JAX quantization compiles each of its ops
# once per distinct kernel shape, and this config has four.
QTINY = dict(depths=(1, 1, 1, 1), hidden_sizes=(32, 32, 32, 32),
             num_heads=(1, 1, 2, 2), sr_ratios=(8, 4, 2, 1),
             decoder_hidden=32, num_labels=1, drop_path_rate=0.0)
# The quantized forwards, port against JAX: both quantize the same float32
# weights to the same bits, but an activation that differs by an ulp (the
# convs and float sums run in other orders) can round to the next int8 or
# e4m3 step, which moves that token's product by one step's worth.
QUANT_PROB_TOL = 2e-3
QUANT_AGREE = 0.999
KINDS = ("int8", "fp8")
_JAX_QUANTIZE = {"int8": jquant.quantize_weight,
                 "fp8": jquant.quantize_weight_fp8}
_PORT_QUANTIZE = {"int8": quant.quantize_weight,
                  "fp8": quant.quantize_weight_fp8}


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of an int8 or e4m3 tensor."""
    return t.contiguous().view(torch.uint8).numpy()


def _jax_bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _weights(seed=0):
    """An (in, out) float32 kernel with a zero column (scale at its 1e-8
    floor), a column of one value and a heavy-tailed one."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 0.02, (48, 40)).astype(np.float32)
    w[:, 0] = 0.0
    w[:, 1] = 0.5
    w[:, 2] = rng.standard_cauchy(48).astype(np.float32) * 0.01
    return w


def _activations(seed=1):
    """(2, 37, 48) float32 tokens with an outlier token and a zero one."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (2, 37, 48)).astype(np.float32)
    x[0, 3] *= 100.0
    x[1, 5] = 0.0
    return x


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_weights_and_scales_bit_equal(kind):
    w = _weights()
    jq, js = _JAX_QUANTIZE[kind](jnp.asarray(w))
    q, s = _PORT_QUANTIZE[kind](torch.from_numpy(w.T.copy()))
    assert q.dtype == quant.WEIGHT_DTYPES[kind] and s.dtype == torch.float32
    np.testing.assert_array_equal(_bits(q.t()), _jax_bits(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_int8_matmul_bit_equal():
    w, x = _weights(), _activations()
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js))
    q, s = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    got = quant.int8_matmul(torch.from_numpy(x), q, s)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fp8_matmul_within_1e5_of_largest():
    w, x = _weights(), _activations()
    jq, js = jquant.quantize_weight_fp8(jnp.asarray(w))
    want = np.asarray(jquant.fp8_matmul(jnp.asarray(x), jq, js))
    q, s = quant.quantize_weight_fp8(torch.from_numpy(w.T.copy()))
    got = quant.fp8_matmul(torch.from_numpy(x), q, s).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("kind", KINDS)
def test_qlinear_is_jax_dense_layer(kind):
    """QLinear = JAX's QDense / F8Dense: the product, plus the float32 bias,
    cast to the layer's dtype (bfloat16 here)."""
    w, x = _weights(), _activations()
    b = np.random.default_rng(2).normal(0, 0.02, 40).astype(np.float32)
    layer = quant.QLinear(48, 40, kind, torch.bfloat16)
    layer.set_from(torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    dense = jquant.QDense if kind == "int8" else jquant.F8Dense
    jq, js = _JAX_QUANTIZE[kind](jnp.asarray(w))
    want = dense(40, dtype=jnp.bfloat16).apply(
        {"params": {"kernel": jq, "kernel_scale": js,
                    "bias": jnp.asarray(b)}},
        jnp.asarray(x, jnp.bfloat16))
    got = layer(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tol = 0 if kind == "int8" else 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_linear_is_the_cpu_forward(kind):
    """`plain_linear`, the reference of the card's checks, is the layer's
    own forward on a CPU tensor, bit for bit."""
    w, x = _weights(), _activations()
    layer = quant.QLinear(48, 40, kind, torch.bfloat16)
    layer.set_from(torch.from_numpy(w.T.copy()), torch.zeros(40))
    xt = torch.from_numpy(x).bfloat16()
    assert torch.equal(quant.plain_linear(layer, xt), layer(xt))


def test_bad_kinds_raise():
    with pytest.raises(ValueError, match="quant"):
        MiTConfig(quant="int4")
    with pytest.raises(ValueError, match="kind"):
        quant.quantize_dense_params(SegFormer(MiTConfig(**QTINY)), "int4")
    with pytest.raises(ValueError, match="kind"):
        quant.QLinear(16, 16, "bf16")


@pytest.fixture(scope="module")
def jax_side():
    """JAX variables of QTINY, its int8 and fp8 trees (eager
    `quantize_dense_params`, as the JAX package's `quantize()` runs it: a
    jit would divide by 127 as a multiplication by its reciprocal), and the
    masks of both quantized configs on seeded images, from one jit."""
    jcfg = JCfg(**QTINY)
    v = jax_variables(jcfg, seed=5)
    trees = {k: jax.tree.map(np.asarray, jquant.quantize_dense_params(
        v["params"], kind=k)) for k in KINDS}
    x = np.random.default_rng(6).uniform(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)

    @jax.jit
    def masks(ti, tf, stats, images):
        out = {}
        for k, p in (("int8", ti), ("fp8", tf)):
            logits, _ = JSegFormer(jcfg.replace(quant=k)).apply(
                {"params": p, "batch_stats": stats}, images)
            out[k] = jax_predict_masks(logits, images.shape[1:3])
        return out

    m = masks(trees["int8"], trees["fp8"], v["batch_stats"], jnp.asarray(x))
    return {"variables": v, "trees": trees, "images": x,
            "masks": jax.tree.map(np.asarray, m)}


def _port_float(variables):
    cfg = MiTConfig(**QTINY)
    model = SegFormer(cfg)
    model.load_state_dict(state_dict_from_flax(
        cfg, variables["params"], variables["batch_stats"]), strict=True)
    return model.eval()


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_leaves_match_jax(kind, jax_side):
    """The port's quantized state_dict equals JAX's quantized tree carried
    over by the bridge: the same keys quantized, to the same bits, and the
    rest equal."""
    v = jax_side["variables"]
    qcfg = MiTConfig(**QTINY, quant=kind)
    bridged = state_dict_from_flax(qcfg, jax_side["trees"][kind],
                                   v["batch_stats"])
    ours = quant.quantize_dense_params(_port_float(v), kind).state_dict()
    dtype = quant.WEIGHT_DTYPES[kind]
    quantized = {n for n, t in bridged.items() if t.dtype == dtype}
    assert quantized == {n for n, t in ours.items() if t.dtype == dtype}
    # q/k/v, out, dense1, dense2 per layer (4 layers), linear_c per stage
    assert len(quantized) == 6 * 4 + 4
    assert set(bridged) == set(ours)
    for n, t in ours.items():
        if n in quantized:
            np.testing.assert_array_equal(_bits(t), _bits(bridged[n]),
                                          err_msg=n)
        else:
            assert torch.equal(t, bridged[n]), n
    # the bridged snapshot loads into the quantized model
    SegFormer(qcfg).load_state_dict(bridged, strict=True)


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_forward_matches_jax(kind, jax_side):
    """Measured on this config on the CPU: max |dp| 6.0e-8 against JAX in
    both widths, every binarised pixel equal (no activation landed on the
    other side of a quantization step); the bounds are QUANT_PROB_TOL and
    QUANT_AGREE. The quantized masks also differ
    from the port's float ones (the quantized path really ran)."""
    model = _port_float(jax_side["variables"])
    q = cast_to_compute_dtype(quant.quantize_dense_params(model, kind))
    images = torch.from_numpy(jax_side["images"])
    with torch.no_grad():
        got = forward_masks(q, images)[0].numpy()
        float_masks = forward_masks(model, images)[0].numpy()
    want = jax_side["masks"][kind]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= QUANT_PROB_TOL
    assert ((got > 0.5) == (want > 0.5)).mean() >= QUANT_AGREE
    assert np.abs(got - float_masks).max() > 1e-5
