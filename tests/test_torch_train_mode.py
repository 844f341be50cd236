"""The port's train-mode forward against the JAX package on the CPU, with
the same weights and the same numpy inputs on both sides:

- with drop-path and dropout rates at 0 (no randomness on either side),
  `train/common.py::forward_masks(train_mode=True)` gives the masks, the
  new BatchNorm running statistics and the gradients of the JAX
  `forward_masks(train_mode=True)` (BatchNorm on batch statistics, biased
  variance into the running average with flax's momentum);
- with rates above 0, the drop-path masks are per sample with keep
  probability 1 - rate of the linear schedule, a seed fixes the forward, and
  `remat="full"` recomputes each layer with the masks its forward drew;
- a 3-step float32 `ema_semi_step(train_mode=True)` at rates 0 follows the
  JAX step at accum 1 and 2: losses, kept counts, and both models' final
  parameters and BatchNorm statistics.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu import losses as jlosses
from semisupervisedobjectdetection_tpu.core.config import (
    MiTConfig as JCfg,
    TrainConfig as JTrainConfig,
)
from semisupervisedobjectdetection_tpu.train import ema as jema
from semisupervisedobjectdetection_tpu.train.common import (
    forward_masks as jax_forward_masks,
)
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
    train_state_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import MiTConfig
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    TrainDraws,
    drop_path_rates,
    init_weights,
)
from semisupervisedobjectdetection_torch.train.common import (
    forward_masks,
    grads_of,
)
from semisupervisedobjectdetection_torch.train.ema import ema_semi_step
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    CASES,
    SIZE,
    TINY,
    jax_variables,
    one_torch_thread,
)

NO_RANDOM = dict(drop_path_rate=0.0, classifier_dropout=0.0)
BN = "decode_head.batch_norm."


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **kw)


def _jax_bn(stats):
    bn = stats["decode_head"]["batch_norm"]
    return {BN + "running_mean": bn["mean"], BN + "running_var": bn["var"]}


@pytest.mark.parametrize("case", ["shared_prompts_cls",
                                  "per_layer_prompts_cls"])
def test_train_forward_matches_jax(case):
    """Rates 0, both sides in train mode on the tiny config with prompt
    tokens and a CLS token at every stage: masks, new BatchNorm running
    statistics and every parameter gradient of the dice loss. float32 sums
    in another order: 1e-5, gradients 1e-5 of the largest."""
    jcfg = JCfg(**{**TINY, **NO_RANDOM}, **CASES[case])
    cfg = MiTConfig(**{**TINY, **NO_RANDOM}, **CASES[case])
    v = jax_variables(jcfg, seed=6)
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(3, SIZE, SIZE)) > 0.6).astype(np.float32)

    def loss_fn(params):
        m, _, st = jax_forward_masks(
            jcfg, {"params": params, "batch_stats": v["batch_stats"]}, x,
            train_mode=True, rng=jax.random.PRNGKey(0))
        return jlosses.dice_loss(m, gt), (m, st)

    (jloss, (jm, jstats)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"])

    model = SegFormer(cfg)
    model.load_state_dict(state_dict_from_flax(cfg, v["params"],
                                               v["batch_stats"]))
    before = {n: b.clone() for n, b in model.named_buffers()}
    m, _, stats = forward_masks(model, _t(x), train_mode=True,
                                generator=torch.Generator().manual_seed(0))
    loss = losses.dice_loss(m, _t(gt))
    params = dict(model.named_parameters())
    grads = grads_of(loss, params)
    _close(m, jm, atol=1e-5)
    _close(loss, jloss, atol=1e-6)
    ref_stats = _jax_bn(jstats)
    assert set(stats) == set(ref_stats)
    for n, s in stats.items():
        _close(s, ref_stats[n], atol=1e-5, rtol=1e-5, err_msg=n)
        assert not torch.equal(s, before[n])
    # the model's own statistics are left as they were
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n
    ref = state_dict_from_flax(cfg, jax.tree.map(np.asarray, jgrads))
    scale = max(float(np.abs(ref[n].numpy()).max()) for n in params)
    for n, g in grads.items():
        _close(g, ref[n], atol=1e-5 * scale, rtol=1e-3, err_msg=n)


def test_drop_path_masks_follow_the_schedule():
    """The schedule is `np.linspace(0, rate, sum(depths))`; each layer's
    mask keeps each sample of each branch with probability 1 - rate[l]
    (within 4 standard deviations over 4000 samples); the first layer keeps
    everything."""
    cfg = MiTConfig(**{**TINY, "drop_path_rate": 0.5})
    rates = drop_path_rates(cfg)
    np.testing.assert_array_equal(rates,
                                  np.linspace(0.0, 0.5, sum(TINY["depths"])))
    n = 4000
    d = TrainDraws.draw(cfg, n, torch.Generator().manual_seed(3),
                        torch.device("cpu"))
    assert d.keep.shape == (len(rates), 2, n)
    assert set(torch.unique(d.keep).tolist()) <= {0.0, 1.0}
    _close(d.keep_prob, 1.0 - rates, atol=1e-7)
    for layer, r in enumerate(rates):
        kept = d.keep[layer].mean(1).numpy()
        sigma = np.sqrt(r * (1 - r) / n)
        assert np.all(np.abs(kept - (1 - r)) <= 4 * sigma + 1e-12), \
            (layer, kept, r)
    assert bool(d.keep[0].all())
    # per sample: the two branches of a layer draw apart
    assert not torch.equal(d.keep[-1, 0], d.keep[-1, 1])
    assert d.generator is not None


def _train_loss(cfg, x, seed, model=None):
    model = model or init_weights(SegFormer(cfg),
                                  torch.Generator().manual_seed(1))
    m, _, stats = forward_masks(model, x, train_mode=True,
                                generator=torch.Generator().manual_seed(seed))
    return losses.dice_loss(m, (x[..., 0] > 0.5).float()), stats, model


def test_train_mode_is_seeded():
    """With drop-path and classifier dropout on, the same seed gives the
    same loss and a different seed a different one; eval mode ignores
    both."""
    cfg = MiTConfig(**{**TINY, "drop_path_rate": 0.3,
                       "classifier_dropout": 0.1})
    x = torch.from_numpy(np.random.default_rng(8).uniform(
        size=(2, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        a, sa, model = _train_loss(cfg, x, 5)
        b, sb, _ = _train_loss(cfg, x, 5, model)
        c, _, _ = _train_loss(cfg, x, 6, model)
        e1 = forward_masks(model, x)[0]
        e2 = forward_masks(model, x)[0]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    for n in sa:
        assert torch.equal(sa[n], sb[n])
    assert torch.equal(e1, e2)


def test_remat_does_not_change_train_mode_gradients():
    """`remat="full"` recomputes each layer under `torch.utils.checkpoint`
    with the drop-path masks drawn before the forward, so it gives the same
    gradients as `"none"` from the same seed, bit for bit."""
    cfg = MiTConfig(**{**TINY, "drop_path_rate": 0.4,
                       "classifier_dropout": 0.2},
                    **CASES["per_layer_prompts_cls"])
    full = init_weights(SegFormer(cfg), torch.Generator().manual_seed(2))
    none = SegFormer(cfg.replace(remat="none"))
    none.load_state_dict(full.state_dict())
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        size=(2, SIZE, SIZE, 3)).astype(np.float32))
    lf, _, _ = _train_loss(cfg, x, 11, full)
    ln, _, _ = _train_loss(cfg, x, 11, none)
    gf = grads_of(lf, dict(full.named_parameters()))
    gn = grads_of(ln, dict(none.named_parameters()))
    torch.testing.assert_close(lf, ln, rtol=0, atol=0)
    for n in gf:
        torch.testing.assert_close(gf[n], gn[n], rtol=0, atol=0)


def test_attention_and_hidden_dropout_raise_in_train_mode():
    x = torch.zeros(1, SIZE, SIZE, 3)
    g = torch.Generator()
    for rate in ("attention_dropout", "hidden_dropout"):
        model = SegFormer(MiTConfig(**{**TINY, rate: 0.1}))
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            forward_masks(model, x, train_mode=True, generator=g)
        forward_masks(model, x)          # eval mode does not use them
    with pytest.raises(ValueError, match="Generator"):
        forward_masks(SegFormer(MiTConfig(**TINY, classifier_dropout=0.1)),
                      x, train_mode=True)


EMA_TINY = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
                num_heads=(1, 2, 4, 8), decoder_hidden=32, **NO_RANDOM)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_mode_ema_trajectory_matches_jax(accum):
    """3 float32 train-mode steps of `ema_semi_step` at rates 0 against the
    JAX step: the student normalises with batch statistics and keeps their
    running averages (threaded through the microbatches), the teacher
    follows by EMA. As `test_torch_train.py::test_ema_trajectory_matches_jax`
    (classifier bias 2, so no binary decision hangs on a rounding): losses
    to 2e-6, parameters to 2e-6 (student) and 1e-8 (teacher). One
    exception: the biases of the decode head's per-stage projections add a
    per-channel constant that BatchNorm on batch statistics removes, so
    their gradient is 0 in exact arithmetic and rounding noise on both
    sides, which Adam scales to a move of about lr per step in either
    direction; they agree to 3 lr (the student's lr is 3e-5). Their
    difference reaches the BatchNorm input's mean through the fuse, so the
    running means agree to 1e-5."""
    jcfg = JCfg(**EMA_TINY)
    cfg = MiTConfig(**EMA_TINY)
    v = jax_variables(jcfg, seed=12)
    v["params"]["decode_head"]["classifier"]["bias"][:] = 2.0
    tc = JTrainConfig()
    jt = JTrainState.create(v, tc, lr=5e-7)
    js = JTrainState.create(v, tc, lr=3e-5)
    teacher = train_state_from_flax(cfg, jt)
    student = train_state_from_flax(cfg, js)
    rng = np.random.default_rng(13)
    for step in range(3):
        unl, imgs = (rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
                     for _ in "ui")
        gt = (rng.uniform(size=(2, SIZE, SIZE)) > 0.6).astype(np.float32)
        jout = jema.ema_semi_step(jt, js, jnp.asarray(unl),
                                  jnp.asarray(imgs), jnp.asarray(gt),
                                  jnp.asarray(0.8), jnp.asarray(0.999),
                                  jcfg, train_mode=True,
                                  rng=jax.random.PRNGKey(step), accum=accum)
        jt, js = jout.teacher_state, jout.student_state
        out = ema_semi_step(teacher, student, _t(unl), _t(imgs), _t(gt),
                            0.8, 0.999, train_mode=True, accum=accum,
                            generator=torch.Generator().manual_seed(step))
        for a, b in zip(out[2:6], jout[2:6]):
            _close(a, b, atol=2e-6, rtol=1e-5)
        assert float(out.n_kept) == float(jout.n_kept) == 2.0
    moved = _jax_bn(js.batch_stats)
    assert not np.allclose(moved[BN + "running_mean"],
                           v["batch_stats"]["decode_head"]["batch_norm"]
                           ["mean"])
    shift_only = {f"decode_head.linear_c.{i}.proj.bias" for i in range(4)}
    for ours, theirs, atol in ((student, js, 2e-6), (teacher, jt, 1e-8)):
        ref = state_dict_from_flax(cfg, jax.tree.map(np.asarray,
                                                     theirs.params),
                                   jax.tree.map(np.asarray,
                                                theirs.batch_stats))
        for n, p in ours.params.items():
            tol = 3 * 3e-5 * (atol / 2e-6) if n in shift_only else atol
            _close(p, ref[n], atol=tol, rtol=1e-6, err_msg=n)
        for n, b in ours.batch_stats.items():
            _close(b, ref[n], atol=1e-5, rtol=1e-5, err_msg=n)
    assert int(student.count) == 3
