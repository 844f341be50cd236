"""The port's SegFormer (`semisupervisedobjectdetection_torch/models/
segformer.py`) against the JAX package's: the same weights (JAX
`SegFormer.init` -> `state_dict_from_flax`) and the same numpy images give
the same logits, per-stage CLS tokens and masks, on a tiny config at
64x64. Also the weight bridge itself: key-for-key agreement with the JAX
package's `export_torch_state_dict`, and `load_torch_checkpoint`'s
classifier and prompt/CLS policies."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu.checkpoint.hf_export import (
    export_prompt_tokens,
    export_torch_state_dict,
    save_torch_checkpoint,
)
from semisupervisedobjectdetection_tpu.core.config import MiTConfig as JCfg
from semisupervisedobjectdetection_tpu.models.segformer import (
    SegFormer as JSegFormer,
    predict_masks as jax_predict_masks,
    upsample_bilinear as jax_upsample_bilinear,
)
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    load_torch_checkpoint,
    state_dict_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    cast_to_compute_dtype,
    forward_logits,
    forward_masks,
)

# tests/test_hf_export.py's TINY: every stage's sr_ratio, uneven depths
TINY = dict(depths=(2, 1, 1, 2), hidden_sizes=(8, 16, 32, 64),
            num_heads=(1, 2, 4, 8), sr_ratios=(8, 4, 2, 1),
            decoder_hidden=32, num_labels=1, drop_path_rate=0.0)
SIZE = 64

CASES = {
    "plain": {},
    "shared_prompts_cls": dict(prompt_tokens=(4, 4, 4, 4),
                               cls_tokens=(1, 1, 1, 1)),
    "per_layer_prompts_cls": dict(prompt_tokens=(3, 0, 2, 4),
                                  prompt_per_layer=True,
                                  cls_tokens=(1, 1, 1, 1)),
    "cls_some_stages": dict(cls_tokens=(1, 0, 1, 1)),
    "gelu_approx": dict(gelu_approx=True),
}


def _jax_variables(jcfg, seed=0):
    v = jax.jit(JSegFormer(jcfg).init)(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, SIZE, SIZE, 3)))
    v = jax.tree.map(np.asarray, v)
    # non-trivial BatchNorm statistics, so the head's BN is exercised
    rng = np.random.default_rng(seed)
    bn = v["batch_stats"]["decode_head"]["batch_norm"]
    bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
    bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    return v


def _images(n=2, seed=0):
    return np.random.default_rng(seed).uniform(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _port_model(cfg, variables):
    model = SegFormer(cfg)
    model.load_state_dict(state_dict_from_flax(
        cfg, variables["params"], variables["batch_stats"]), strict=True)
    return cast_to_compute_dtype(model).eval()


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax_f32(case):
    jcfg = JCfg(**TINY, **CASES[case])
    cfg = MiTConfig(**TINY, **CASES[case])
    v = _jax_variables(jcfg)
    x = _images()
    jl, jcls = jax.jit(lambda v, x: JSegFormer(jcfg).apply(v, x))(
        v, jnp.asarray(x))
    jmasks = jax_predict_masks(jl, (SIZE, SIZE))

    model = _port_model(cfg, v)
    with torch.no_grad():
        tl, tcls = model(torch.from_numpy(x))
        tmasks, _ = forward_masks(model, torch.from_numpy(x))
        tup, _ = forward_logits(model, torch.from_numpy(x))
    # float32 end to end; sums in another order through 6 layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        tup.numpy(), np.asarray(jax_upsample_bilinear(jl, (SIZE, SIZE))),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tmasks.numpy(), np.asarray(jmasks),
                               atol=1e-4)
    assert tmasks.shape == (2, SIZE, SIZE)
    assert len(tcls) == len(jcls)
    for a, b in zip(jcls, tcls):
        assert (a is None) == (b is None)
        if a is not None:
            assert b.shape == a.shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4)


def test_forward_matches_jax_bf16():
    """bfloat16 compute: the JAX side runs its Pallas attention (interpret
    mode on the CPU), whose scores are float32 like the port's kernel.
    Every layer rounds to bf16 (2**-8 relative) in a different order on
    the two sides, so logits (magnitude ~0.2 here) agree to ~1e-2 and
    probabilities to ~1e-2."""
    extra = CASES["shared_prompts_cls"]
    jcfg = JCfg(**TINY, **extra, dtype="bfloat16", attn_impl="pallas")
    cfg = MiTConfig(**TINY, **extra, dtype="bfloat16")
    v = _jax_variables(jcfg)
    x = _images()
    jl, jcls = jax.jit(lambda v, x: JSegFormer(jcfg).apply(v, x))(
        v, jnp.asarray(x))
    model = _port_model(cfg, v)
    with torch.no_grad():
        tl, tcls = model(torch.from_numpy(x))
        tmasks, _ = forward_masks(model, torch.from_numpy(x))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2)
    np.testing.assert_allclose(
        tmasks.numpy(), np.asarray(jax_predict_masks(jl, (SIZE, SIZE))),
        atol=1e-2)
    for a, b in zip(jcls, tcls):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=2e-2)


@pytest.mark.parametrize("case", ["plain", "shared_prompts_cls"])
def test_state_dict_agrees_with_jax_export(case):
    """`state_dict_from_flax` (the port's own code) and the JAX package's
    `export_torch_state_dict` give the same tensor under every key they
    share; the keys only the port has are its prompt/CLS tokens, which the
    JAX export hands out apart (`export_prompt_tokens`)."""
    jcfg = JCfg(**TINY, **CASES[case])
    cfg = MiTConfig(**TINY, **CASES[case])
    v = _jax_variables(jcfg)
    ours = state_dict_from_flax(cfg, v["params"], v["batch_stats"])
    theirs = export_torch_state_dict(jcfg, v["params"], v["batch_stats"])
    assert set(theirs) <= set(ours)
    for key, arr in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), arr, err_msg=key)
    prompts, cls = export_prompt_tokens(jcfg, v["params"])
    extra = set(ours) - set(theirs)
    assert extra == {f"segformer.encoder.prompt_tokens.{i}"
                     for i, p in enumerate(prompts) if p is not None} | \
        {f"segformer.encoder.cls_token.{i}"
         for i, c in enumerate(cls) if c is not None}
    for i, p in enumerate(prompts):
        if p is not None:
            np.testing.assert_array_equal(
                ours[f"segformer.encoder.prompt_tokens.{i}"].numpy(), p)
    # and the port's model takes it whole
    SegFormer(cfg).load_state_dict(ours, strict=True)


@pytest.mark.parametrize("fmt", ["ck.safetensors", "ck.pth"])
def test_load_checkpoint_slices_wider_classifier(tmp_path, fmt):
    """A 2-label checkpoint into a 1-label model takes output channel 0
    (the JAX importer's classifier_policy="slice0"), from either format,
    and predicts what the JAX model with that head predicts."""
    pytest.importorskip("safetensors")
    jcfg2 = JCfg(**{**TINY, "num_labels": 2})
    v = _jax_variables(jcfg2)
    path = str(tmp_path / fmt)
    save_torch_checkpoint(path, export_torch_state_dict(
        jcfg2, v["params"], v["batch_stats"]))

    cfg = MiTConfig(**TINY)
    sd = load_torch_checkpoint(path, cfg)
    assert sd["decode_head.classifier.weight"].shape[0] == 1
    model = SegFormerModel(config=cfg, device="cpu", hf_weights=path)

    jcfg1 = JCfg(**TINY)
    v1 = jax.tree.map(lambda a: a, v)
    head = v1["params"]["decode_head"]["classifier"]
    v1["params"]["decode_head"]["classifier"] = {
        "kernel": head["kernel"][..., :1], "bias": head["bias"][:1]}
    x = _images(1, seed=3)
    jl, _ = jax.jit(lambda v, x: JSegFormer(jcfg1).apply(v, x))(
        v1, jnp.asarray(x))
    np.testing.assert_allclose(
        model.predict(x), np.asarray(jax_predict_masks(jl, (SIZE, SIZE))),
        atol=1e-4)


def test_load_checkpoint_without_prompt_tokens_is_refused(tmp_path):
    """The JAX export keeps prompt/CLS tokens out of the state_dict; such a
    file serves a prompt config only with its tokens, so it is refused."""
    extra = CASES["shared_prompts_cls"]
    jcfg = JCfg(**TINY, **extra)
    v = _jax_variables(jcfg)
    path = str(tmp_path / "ck.pth")
    save_torch_checkpoint(path, export_torch_state_dict(
        jcfg, v["params"], v["batch_stats"]))
    with pytest.raises(ValueError, match="prompt/CLS"):
        load_torch_checkpoint(path, MiTConfig(**TINY, **extra))
    # the same file serves a config without prompt/CLS tokens
    sd = load_torch_checkpoint(path, MiTConfig(**TINY))
    assert not any("prompt" in k or "cls_token" in k for k in sd)


def test_port_state_dict_roundtrips_with_tokens(tmp_path):
    """The port's own saved state_dict carries the prompt/CLS tokens and
    loads back into an identical model."""
    cfg = MiTConfig(**TINY, **CASES["per_layer_prompts_cls"])
    a = SegFormerModel(config=cfg, device="cpu", seed=1)
    path = str(tmp_path / "port.pth")
    torch.save(a.model.state_dict(), path)
    b = SegFormerModel(config=cfg, device="cpu", seed=2, hf_weights=path)
    x = _images(1, seed=4)
    np.testing.assert_array_equal(a.predict(x), b.predict(x))
    assert b.model.segformer.encoder.prompt_tokens["0"].shape == (2, 3, 8)


def test_predict_accepts_nchw():
    model = SegFormerModel(config=MiTConfig(**TINY), device="cpu")
    x = _images(2, seed=5)
    np.testing.assert_array_equal(model.predict(x),
                                  model.predict(x.transpose(0, 3, 1, 2)))


def test_seeded_init_is_reproducible_and_distinct():
    cfg = MiTConfig(**TINY, **CASES["shared_prompts_cls"])
    a, b, c = (SegFormerModel(config=cfg, device="cpu", seed=s).model
               for s in (7, 7, 8))
    for (k, ta), tb, tc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(ta, tb), k
    assert not torch.equal(a.segformer.encoder.cls_token["0"],
                           c.segformer.encoder.cls_token["0"])
