"""The port's few-shot domain prompting (`semisupervisedobjectdetection_torch/
train/fewshot.py`, the CLS losses of `losses.py`, `SegFormerModel.predict(
output_cls_token=True)` and `data/classified.py`) against the JAX package
on the CPU, with the same weights (`jax_variables` carried over by
`train_state_from_flax`) and the same numpy inputs, float32, on a tiny
config at 64x64: two stages of one layer with a CLS token each (the JAX
package's few-shot step compiles in ~16 s at four stages against ~10 s at
two, and the new tests keep within 150 worker-seconds of the suite):

- `cosine_similarity`, `inter_domain_loss` and `intra_domain_loss` at
  batch 2, 3 (odd: the middle sample is left out) and 4, and on zero
  vectors (the eps branch);
- two `fewshot_ae_step`s at accum 1 and 2 (batch 4): the loss, the four
  reconstruction and two inter losses, and every parameter, the CLS tokens
  among them;
- two `fewshot_seg_step`s at `cls_loss_weight` 0 with accum 1 and at 1.0
  with accum 2: the loss, `loss_1`, `loss_2`, `pred_1` and every
  parameter;
- the `ValueError`s of both steps, word for word;
- `predict(output_cls_token=True)` with "dice" and "mse" against the JAX
  `SegFormerModel.predict`; None in the token's place without CLS tokens
  and from `train_one_epoch(output_cls_token=True)`;
- `category_loaders`: the same categories, batches and bytes as the JAX
  package's over two epochs.

Each JAX step is compiled once per case, in a module-scoped fixture that
the tests of that case share.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu import api as japi
from semisupervisedobjectdetection_tpu import losses as jlosses
from semisupervisedobjectdetection_tpu.core.config import (
    DataConfig as JDataConfig,
    MiTConfig as JCfg,
    TrainConfig as JTrainConfig,
)
from semisupervisedobjectdetection_tpu.data import classified as jclassified
from semisupervisedobjectdetection_tpu.train import fewshot as jfw
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
    train_state_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import (
    DataConfig,
    MiTConfig,
)
from semisupervisedobjectdetection_torch.data import classified
from semisupervisedobjectdetection_torch.data.synthetic import (
    write_synthetic_dataset,
)
from semisupervisedobjectdetection_torch.train import fewshot as fw
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    jax_variables,
    one_torch_thread,
)
from test_torch_supervised import (
    LR,
    _Gradients,
    _check_params,
    _jax_mu,
    _jax_state_dict,
)

SIZE = 64
FEW = dict(depths=(1, 1), hidden_sizes=(8, 16), num_heads=(1, 2),
           patch_sizes=(7, 3), strides=(4, 2), sr_ratios=(8, 4),
           decoder_hidden=32, drop_path_rate=0.0, classifier_dropout=0.0,
           prompt_tokens=(0, 0), cls_tokens=(1, 1))
CLS_TOKENS = [f"segformer.encoder.cls_token.{i}" for i in range(2)]


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **kw)


# ------------------------------------------------------------- CLS losses
@pytest.mark.parametrize("case", ["b2", "b3_odd", "b4", "zero"])
def test_cls_losses_match_jax(case):
    """float32 sums over 64 channels in another order: 1e-6. Zero vectors
    take the eps branch: cos 0, inter 0.5, intra 0.5."""
    rng = np.random.default_rng(50)
    b = {"b2": 2, "b3_odd": 3, "b4": 4, "zero": 2}[case]
    a = rng.uniform(size=(b, 1, 64)).astype(np.float32)
    c = rng.normal(size=(b, 1, 64)).astype(np.float32)
    if case == "zero":
        a[0] = 0.0
        c[:] = 0.0
    cos = losses.cosine_similarity(_t(a[:, 0]), _t(c[:, 0]), dim=1)
    _close(cos, jlosses.cosine_similarity(a[:, 0], c[:, 0], axis=1),
           atol=1e-6)
    _close(losses.inter_domain_loss(_t(a), _t(c)),
           jlosses.inter_domain_loss(a, c), atol=1e-6)
    for x in (a, c):
        _close(losses.intra_domain_loss(_t(x)),
               jlosses.intra_domain_loss(x), atol=1e-6)
    if case == "zero":
        assert float(losses.inter_domain_loss(_t(a), _t(c))) == 0.5
        assert float(losses.intra_domain_loss(_t(c))) == 0.5
    if case == "b3_odd":
        # the halves are samples 0 and 2; the middle one does not count
        moved = a.copy()
        moved[1] = 0.0
        assert float(losses.intra_domain_loss(_t(moved))) == \
            float(losses.intra_domain_loss(_t(a)))


# ----------------------------------------------------------- train steps
def _states(seed, num_labels):
    jcfg = JCfg(**FEW, num_labels=num_labels)
    cfg = MiTConfig(**FEW, num_labels=num_labels)
    js = JTrainState.create(jax_variables(jcfg, seed=seed, size=SIZE),
                            JTrainConfig(), lr=LR)
    return jcfg, cfg, js, train_state_from_flax(cfg, js)


def _images(rng, n):
    return rng.uniform(size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _masks(rng, n):
    return (rng.uniform(size=(n, SIZE, SIZE)) > 0.6).astype(np.float32)


def _trajectory(num_labels, seed, make_inputs, jax_step, port_step):
    """Two steps of both sides from one state, fresh inputs each step:
    (cfg, port state, JAX state, gradients of each step, the start of the
    CLS tokens, [(port out, JAX out)] per step)."""
    jcfg, cfg, js, state = _states(seed, num_labels)
    start = {n: state.params[n].detach().clone() for n in CLS_TOKENS}
    grads = _Gradients(cfg, state)
    rng = np.random.default_rng(seed + 1)
    outs = []
    for _ in range(2):
        x = make_inputs(rng)
        jout = jax_step(js, [jnp.asarray(a) for a in x], jcfg)
        js = jout.state
        out = port_step(state, [_t(a) for a in x])
        grads.record(_jax_mu(cfg, js))
        outs.append((out, jout))
    assert int(state.count) == 2
    return cfg, state, js, grads, start, outs


def _check_trajectory(run):
    """Every parameter as `_check_params` bounds it (eval mode), and the
    CLS tokens moved on both sides."""
    cfg, state, js, grads, start, _ = run
    _check_params(cfg, state, _jax_state_dict(cfg, js), False, 2, grads)
    ref = state_dict_from_flax(cfg, jax.tree.map(np.asarray, js.params))
    for n in CLS_TOKENS:
        assert not torch.equal(state.params[n].detach(), start[n]), n
        assert not torch.equal(ref[n], start[n]), n


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def ae_run(request):
    accum = request.param
    return _trajectory(
        3, 60 + accum, lambda rng: [_images(rng, 4) for _ in range(4)],
        lambda js, x, jcfg: jfw.fewshot_ae_step(js, *x, jcfg, accum=accum),
        lambda st, x: fw.fewshot_ae_step(st, *x, accum=accum))


def test_fewshot_ae_losses_match_jax(ae_run):
    """The AE loss is recon (sums of squared errors over 64x64x3 per
    sample over B*3, ~400) + 100 x the cosine terms, in float32 sums of
    another order: 1e-5 relative; the reconstruction losses likewise, the
    inter losses (in [0, 1]) to 1e-6."""
    for out, jout in ae_run[-1]:
        _close(out.loss, jout.loss, rtol=1e-5)
        assert out.recon_losses.shape == (4,)
        _close(out.recon_losses, jout.recon_losses, rtol=1e-5)
        _close(out.inter_losses, jout.inter_losses, atol=1e-6)


def test_fewshot_ae_params_match_jax(ae_run):
    _check_trajectory(ae_run)


# cls_loss_weight 0 (the shipped reference) at accum 1, and 1.0 at accum 2
# (the cosine terms, the microbatch check with them on, pred_1 put back
# together): each value of each option once, one JAX compile each (~10 s
# alone, 20-35 s under the suite's six workers).
@pytest.fixture(scope="module", params=[(0.0, 1), (1.0, 2)],
                ids=["cls0_accum1", "cls1_accum2"])
def seg_run(request):
    w, accum = request.param
    return _trajectory(
        1, 70 + int(w) * 2 + accum,
        lambda rng: [_images(rng, 4), _masks(rng, 4), _images(rng, 4),
                     _masks(rng, 4)],
        lambda js, x, jcfg: jfw.fewshot_seg_step(js, *x, jcfg, w,
                                                 accum=accum),
        lambda st, x: fw.fewshot_seg_step(st, *x, w, accum=accum))


def test_fewshot_seg_outputs_match_jax(seg_run):
    """Dice losses (means of per-sample ratios) to 2e-6, the predicted
    masks of category 1 over the whole batch to 1e-5 (float32 sums in
    another order through 2 layers), as tests/test_torch_supervised.py."""
    for out, jout in seg_run[-1]:
        for a, b in ((out.loss, jout.loss), (out.loss_1, jout.loss_1),
                     (out.loss_2, jout.loss_2)):
            _close(a, b, atol=2e-6, rtol=1e-5)
        assert out.pred_1.shape == (4, SIZE, SIZE)
        _close(out.pred_1, jout.pred_1, atol=1e-5)


def test_fewshot_seg_params_match_jax(seg_run):
    _check_trajectory(seg_run)


@pytest.mark.parametrize("case", ["ae_indivisible", "ae_micro_of_1",
                                  "seg_indivisible", "seg_cls_micro_of_1"])
def test_fewshot_step_errors_match_jax(case):
    """Both sides refuse, in the same words, a batch that accum does not
    divide and microbatches of one sample where a cosine loss is on."""
    b, accum = {"ae_indivisible": (3, 2), "ae_micro_of_1": (2, 2),
                "seg_indivisible": (3, 2), "seg_cls_micro_of_1": (2, 2)}[case]
    ae = case.startswith("ae")
    jcfg, cfg, js, state = _states(80, 3 if ae else 1)
    x = np.zeros((b, SIZE, SIZE, 3), np.float32)
    m = np.zeros((b, SIZE, SIZE), np.float32)
    with pytest.raises(ValueError) as jerr:
        if ae:
            jfw.fewshot_ae_step(js, x, x, x, x, jcfg, accum=accum)
        else:
            jfw.fewshot_seg_step(js, x, m, x, m, jcfg, 1.0, accum=accum)
    with pytest.raises(ValueError) as err:
        if ae:
            fw.fewshot_ae_step(state, *[_t(x)] * 4, accum=accum)
        else:
            fw.fewshot_seg_step(state, _t(x), _t(m), _t(x), _t(m), 1.0,
                                accum=accum)
    assert str(err.value) == str(jerr.value)
    assert int(state.count) == 0


# ----------------------------------------------------------------- predict
@pytest.fixture(scope="module")
def predict_models():
    """JAX and port `SegFormerModel`s of the tiny CLS config with the same
    weights, 1 label (dice) and 3 (mse). The JAX model's `init` is replaced
    by the seeded values of `jax_variables` (no compile)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi.SegFormerModel, "_init_variables",
                   lambda self, jcfg: jax_variables(jcfg, seed=90,
                                                    size=SIZE))
        for labels in (1, 3):
            jm = japi.SegFormerModel(config=JCfg(**FEW), num_labels=labels)
            m = SegFormerModel(config=MiTConfig(**FEW), num_labels=labels,
                               device="cpu")
            v = jm.state.variables()
            m.load_state_dict(state_dict_from_flax(
                m.cfg, jax.tree.map(np.asarray, v["params"]),
                jax.tree.map(np.asarray, v["batch_stats"])))
            out[labels] = (jm, m)
    return out


@pytest.mark.parametrize("use_loss", ["dice", "mse"])
def test_predict_output_cls_token_matches_jax(predict_models, use_loss):
    """One float32 forward for the masks and the token: the loss (dice to
    2e-6; the MSE, ~400, to 1e-5 relative), the masks to 1e-5 and
    sigmoid(cls[-1]) (B, 1, 16) float32 to 1e-5, float32 sums in another
    order through 2 layers."""
    rng = np.random.default_rng(91)
    x = _images(rng, 2)
    gt = _masks(rng, 2) if use_loss == "dice" else None
    jm, m = predict_models[3 if use_loss == "mse" else 1]
    jloss, jpred, jcls = jm.predict(x, gt, use_loss=use_loss,
                                    output_cls_token=True)
    loss, pred, cls = m.predict(x, gt, use_loss=use_loss,
                                output_cls_token=True)
    _close(loss, jloss, atol=2e-6, rtol=1e-5)
    _close(_t(pred), jpred, atol=1e-5)
    assert cls.shape == (2, 1, 16) and cls.dtype == np.float32
    _close(_t(cls), jcls, atol=1e-5)
    # without a target or loss the masks alone, as in JAX
    if use_loss == "dice":
        alone = m.predict(x, output_cls_token=True)
        assert isinstance(alone, np.ndarray)
        np.testing.assert_array_equal(alone, pred)


def test_output_cls_token_none_where_jax_gives_none():
    """A model without CLS tokens gives None in the token's place, and
    `train_one_epoch(output_cls_token=True)` gives None always (JAX
    `api.py:336-340`)."""
    cfg = MiTConfig(**dict(FEW, cls_tokens=(0, 0)))
    m = SegFormerModel(config=cfg, device="cpu")
    rng = np.random.default_rng(92)
    x, gt = _images(rng, 2), _masks(rng, 2)
    loss, pred, cls = m.predict(x, gt, output_cls_token=True)
    assert cls is None and pred.shape == (2, SIZE, SIZE)
    _close(loss, m.predict(x, gt)[0], atol=0)
    m = SegFormerModel(config=MiTConfig(**FEW), device="cpu")
    got = m.train_one_epoch(x, gt, output_cls_token=True)
    assert len(got) == 3 and got[2] is None
    assert got[1].shape == (2, SIZE, SIZE)


# ---------------------------------------------------------------- loaders
def test_category_loaders_match_jax(tmp_path):
    """Three labeled domains (one of them ragged: 5 tiles) and two
    unlabeled ones: sorted categories, seeds seed*1000+i, batches of
    `few_shot_batch_size`, byte-equal over two epochs."""
    root = str(tmp_path)
    for name, n, unlab in (("labeled/dom_b", 4, False),
                           ("labeled/dom_a", 5, False),
                           ("labeled/dom_c", 4, False),
                           ("unlabeled/u1", 4, True),
                           ("unlabeled/u0", 4, True)):
        write_synthetic_dataset(os.path.join(root, name),
                                None if unlab else os.path.join(root, "m"),
                                n=n, size=64, seed=len(name) + n,
                                unlabeled=unlab)
    with open(os.path.join(root, "labeled", "notes.txt"), "w") as f:
        f.write("a file, not a domain")
    kw = dict(labeled_classified=os.path.join(root, "labeled"),
              unlabeled_classified=os.path.join(root, "unlabeled"),
              maskdir=os.path.join(root, "m"), canvas=64)
    dcfg, jdcfg = DataConfig(**kw), JDataConfig(**kw)
    for flag in ("labeled", "unlabeled"):
        cats = classified.get_categories(dcfg, flag)
        assert cats == jclassified.get_categories(jdcfg, flag)
        assert cats == sorted(cats)
        ours = classified.category_loaders(dcfg, flag, seed=3)
        theirs = jclassified.category_loaders(jdcfg, flag, seed=3)
        assert len(ours) == len(theirs) == len(cats)
        for lo, lj, cat in zip(ours, theirs, cats):
            assert lo.dataset.category == lj.dataset.category == cat
            assert lo.batch_size == dcfg.few_shot_batch_size == 2
            for _ in range(2):
                got, want = list(lo), list(lj)
                assert len(got) == len(want) > 0
                for (gi, gm), (wi, wm) in zip(got, want):
                    np.testing.assert_array_equal(gi, wi)
                    assert (gm is None) == (wm is None) == (flag !=
                                                            "labeled")
                    if gm is not None:
                        np.testing.assert_array_equal(gm, wm)
    assert classified.get_categories(DataConfig(), "labeled") == []
