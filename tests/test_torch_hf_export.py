"""`SegFormerModel.export_hf` and `checkpoint/hf_export.py` of the port
against the JAX package's `checkpoint/hf_export.py` on the same bridged
weights (with prompt tokens, a CLS token per stage and so the decode head's
`cls_proj`): `export_torch_state_dict`'s keys, shapes, dtypes and values,
and `export_prompt_tokens`' per-stage arrays, equal; the written `.pth`
and `.safetensors` of a model without tokens load back through
`checkpoint/convert.py` (`SegFormerModel(hf_weights=...)`) with `predict`
bit-equal. All eager:
nothing of JAX is compiled."""

import numpy as np
import pytest

from semisupervisedobjectdetection_tpu.checkpoint import hf_export as jhf
from semisupervisedobjectdetection_tpu.core.config import MiTConfig as JCfg
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint import hf_export
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import MiTConfig
from test_torch_segformer import TINY, jax_variables  # noqa: F401
from test_torch_segformer import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(TINY, prompt_tokens=(2, 0, 3, 0), cls_tokens=(1, 1, 1, 1),
           dtype="float32")


@pytest.fixture(scope="module")
def bridged():
    jcfg = JCfg(**CFG)
    v = jax_variables(jcfg, seed=8)
    cfg = MiTConfig(**CFG)
    model = SegFormerModel(config=cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(cfg, v["params"],
                                               v["batch_stats"]))
    return jcfg, v, model


def test_state_dict_equals_jax_export(bridged):
    jcfg, v, model = bridged
    want = jhf.export_torch_state_dict(jcfg, v["params"], v["batch_stats"])
    got = hf_export.export_torch_state_dict(model._net)
    assert set(got) == set(want)
    assert any(".cls_proj." in k for k in got)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_prompt_tokens_equal_jax_export(bridged):
    jcfg, v, model = bridged
    want = jhf.export_prompt_tokens(jcfg, v["params"])
    got = hf_export.export_prompt_tokens(model._net)
    for g_list, w_list in zip(got, want):
        assert [g is None for g in g_list] == [w is None for w in w_list]
        for g, w in zip(g_list, w_list):
            if w is not None:
                np.testing.assert_array_equal(g, w)
    assert [p is None for p in got[0]] == [False, True, False, True]


@pytest.mark.parametrize("suffix", [".pth", ".safetensors"])
def test_export_hf_loads_back_with_equal_predict(tmp_path, suffix):
    """A model without tokens (the HF layout has no key for them, and the
    port's reader refuses a file that lacks the tokens its config has):
    the file loads through `checkpoint/convert.py`'s reader into a model of
    another seed, and `predict` is bit-equal."""
    cfg = MiTConfig(**dict(TINY, dtype="float32"))
    model = SegFormerModel(config=cfg, device="cpu", seed=5)
    path = str(tmp_path / f"segformer{suffix}")
    model.export_hf(path)
    back = SegFormerModel(config=cfg, device="cpu", seed=9, hf_weights=path)
    x = np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(back.predict(x), model.predict(x))
