"""The port's training slice against the JAX package on the CPU, with the
same numpy inputs and the same weights on both sides:

- losses (`losses.py`), pseudo-labels and denoising (`train/pseudo.py`),
  the optimizer state (`train/state.py`, NaN-skip and a trainable mask)
  and the mean-teacher EMA (`train/teacher_student.py::ema_update`);
- the model's logits and every parameter gradient against
  `jax.value_and_grad` of the JAX model on the tiny config of
  tests/test_torch_segformer.py, under remat;
- a 3-step float32 trajectory of `train/ema.py::ema_semi_step` against the
  JAX `ema_semi_step`, from one state carried across with
  `train_state_from_flax`, at accum 1 and 2;
- the port's bench on the CPU.
"""

import contextlib
import copy
import io
import json

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu import losses as jlosses
from semisupervisedobjectdetection_tpu.core.config import (
    MiTConfig as JCfg,
    TrainConfig as JTrainConfig,
)
from semisupervisedobjectdetection_tpu.models.segformer import (
    SegFormer as JSegFormer,
    predict_masks as jax_predict_masks,
)
from semisupervisedobjectdetection_tpu.train import ema as jema
from semisupervisedobjectdetection_tpu.train import pseudo as jpseudo
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
from semisupervisedobjectdetection_tpu.train.teacher_student import (
    ema_update as jax_ema_update,
)
from semisupervisedobjectdetection_torch import bench, losses
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
    train_state_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    predict_masks,
)
from semisupervisedobjectdetection_torch.train import pseudo
from semisupervisedobjectdetection_torch.train.common import (
    forward_masks,
    grads_of,
)
from semisupervisedobjectdetection_torch.train.ema import ema_semi_step
from semisupervisedobjectdetection_torch.train.state import TrainState
from semisupervisedobjectdetection_torch.train.teacher_student import (
    ema_update,
)
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    CASES,
    SIZE,
    TINY,
    jax_variables,
    one_torch_thread,
)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **kw)


# ---- losses and pseudo-labels ------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(weighted):
    """Sums over 64x64 pixels in float32, in another order: ~1e-7."""
    rng = np.random.default_rng(0)
    pred = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    gt = (rng.uniform(size=(3, 64, 64)) > 0.6).astype(np.float32)
    w = np.array([1.0, 0.0, 1.0], np.float32) if weighted else None
    tw = None if w is None else _t(w)
    jw = None if w is None else jnp.asarray(w)
    for ours, theirs in ((losses.dice_coeff, jlosses.dice_coeff),
                         (losses.dice_loss, jlosses.dice_loss),
                         (losses.dice_argmax_loss, jlosses.dice_argmax_loss)):
        _close(ours(_t(pred), _t(gt), sample_weight=tw),
               theirs(jnp.asarray(pred), jnp.asarray(gt), sample_weight=jw),
               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", ["mixed", "none_kept", "no_throw"])
def test_pseudo_labels_match_jax(case):
    """Thresholds and gates are exact; the kept-sample dice loss is a
    float32 sum (~1e-7); NaN when no sample is kept, on both sides."""
    rng = np.random.default_rng(1)
    soft = rng.uniform(size=(4, 64, 64)).astype(np.float32)
    # a confident, mostly-foreground sample and a confident background one
    soft[0] = np.where(soft[0] > 0.2, 0.95, 0.02)
    soft[2] = np.where(soft[2] > 0.9, 0.9, 0.05)
    if case == "none_kept":
        soft = np.full_like(soft, 0.5)
    allow = case != "no_throw"
    ours = pseudo.threshold_pseudo_masks(_t(soft),
                                         allow_throw_sample=allow)
    theirs = jpseudo.threshold_pseudo_masks(jnp.asarray(soft),
                                            allow_throw_sample=allow)
    for a, b in zip(ours, theirs):
        _close(a, b, atol=1e-6, rtol=1e-6, equal_nan=True)
    n_kept = float(ours.n_kept)
    assert n_kept == {"mixed": 1.0, "none_kept": 0.0, "no_throw": 4.0}[case]
    assert np.isnan(float(ours.loss)) == (n_kept == 0)
    gt = (rng.uniform(size=(4, 64, 64)) > 0.5).astype(np.float32)
    _close(pseudo.denoise_labels(_t(soft), _t(gt)),
           jpseudo.denoise_labels(jnp.asarray(soft), jnp.asarray(gt)),
           atol=0)


# ---- optimizer state and EMA -------------------------------------------

class _Toy(nn.Module):
    """A dense layer and a BatchNorm, from numpy arrays under flat names."""

    def __init__(self, arrays):
        super().__init__()
        self.lin = nn.Linear(5, 3)
        self.bn = nn.BatchNorm1d(3)
        with torch.no_grad():
            for name, t in list(self.named_parameters()) + [
                    (n, b) for n, b in self.named_buffers()
                    if n.endswith(("mean", "var"))]:
                t.copy_(_t(arrays[name]))


def _toy_arrays(seed):
    rng = np.random.default_rng(seed)
    shapes = {"lin.weight": (3, 5), "lin.bias": (3,), "bn.weight": (3,),
              "bn.bias": (3,), "bn.running_mean": (3,),
              "bn.running_var": (3,)}
    return {n: rng.normal(size=s).astype(np.float32) for n, s in
            shapes.items()}


def _jax_vars(arrays):
    stats = ("bn.running_mean", "bn.running_var")
    return {"params": {n: jnp.asarray(a) for n, a in arrays.items()
                       if n not in stats},
            "batch_stats": {n: jnp.asarray(arrays[n]) for n in stats}}


def _jax_adam(opt_state):
    inner = getattr(opt_state, "inner_state", opt_state)
    return next(s for s in inner if hasattr(s, "mu"))


@pytest.mark.parametrize("masked", [False, True])
def test_train_state_matches_jax(masked):
    """Clip -> +wd*p -> Adam(0.5, 0.999) -> -lr*decay**epoch, over steps
    with clipped gradients, an epoch step, a NaN and an inf loss (no change
    at all) and a masked parameter (no update, no moments). Elementwise
    float32 arithmetic in the same order: ~1 ulp."""
    arrays = _toy_arrays(0)
    tc = TrainConfig()
    mask = {"lin.weight": True, "lin.bias": False, "bn.weight": True,
            "bn.bias": True} if masked else None
    ours = TrainState.create(_Toy(arrays), tc, lr=3e-2, trainable_mask=mask)
    theirs = JTrainState.create(_jax_vars(arrays), JTrainConfig(), lr=3e-2,
                                trainable_mask=mask)
    rng = np.random.default_rng(2)
    for i, loss in enumerate([1.0, 0.5, np.nan, np.inf, 0.25]):
        grads = {n: (2.0 * rng.normal(size=a.shape)).astype(np.float32)
                 for n, a in arrays.items() if "running" not in n}
        ours.apply_gradients({n: _t(g) for n, g in grads.items()},
                             torch.tensor(loss, dtype=torch.float32))
        theirs = theirs.apply_gradients(
            {n: jnp.asarray(g) for n, g in grads.items()},
            jnp.asarray(loss, jnp.float32))
        if i == 1:
            ours.scheduler_step()
            theirs = theirs.scheduler_step()
        for n, p in ours.params.items():
            _close(p, theirs.params[n], atol=1e-7, rtol=1e-6, err_msg=n)
        adam = _jax_adam(theirs.opt_state)
        assert int(ours.count) == int(adam.count) == min(i + 1, 2) + (i == 4)
        assert set(ours.mu) == {n for n in ours.params
                                if mask is None or mask[n]}
        for n in ours.mu:
            _close(ours.mu[n], adam.mu[n], atol=1e-7, rtol=1e-6)
            _close(ours.nu[n], adam.nu[n], atol=1e-7, rtol=1e-6)
    if masked:
        _close(ours.params["lin.bias"], arrays["lin.bias"], atol=0)
    _close(ours.lr, theirs.lr, rtol=1e-7)


def test_ema_update_matches_jax():
    """t <- decay*t + (1-decay)*s on params and BatchNorm statistics, the
    same float32 operations on both sides: bit for bit."""
    t_arr, s_arr = _toy_arrays(3), _toy_arrays(4)
    ours_t = TrainState.create(_Toy(t_arr), TrainConfig())
    ours_s = TrainState.create(_Toy(s_arr), TrainConfig())
    jt = JTrainState.create(_jax_vars(t_arr), JTrainConfig())
    js = JTrainState.create(_jax_vars(s_arr), JTrainConfig())
    ema_update(ours_t, ours_s, 0.9)
    jt = jax_ema_update(jt, js, jnp.asarray(0.9, jnp.float32))
    for n, p in ours_t.params.items():
        _close(p, jt.params[n], atol=0, rtol=0)
    for n, b in ours_t.batch_stats.items():
        _close(b, jt.batch_stats[n], atol=0, rtol=0)


# ---- model gradients ----------------------------------------------------

@pytest.mark.parametrize("case", ["shared_prompts_cls",
                                  "per_layer_prompts_cls"])
def test_gradients_match_jax_value_and_grad(case):
    """The EMA step's student loss (0.8 dice to GT + 0.2 dice to a teacher
    mask) on the tiny config with prompt tokens and a CLS token at every
    stage, both sides under full remat: logits, loss and every parameter
    gradient. float32 sums in another order through 6 layers, forward and
    back: gradients agree to 1e-5 of the largest gradient."""
    jcfg = JCfg(**TINY, **CASES[case])
    cfg = MiTConfig(**TINY, **CASES[case])
    v = jax_variables(jcfg, seed=1)
    rng = np.random.default_rng(2)
    x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(2, SIZE, SIZE)) > 0.6).astype(np.float32)
    tm = (rng.uniform(size=(2, SIZE, SIZE)) > 0.4).astype(np.float32)

    def loss_fn(params):
        logits, _ = JSegFormer(jcfg).apply(
            {"params": params, "batch_stats": v["batch_stats"]}, x)
        m = jax_predict_masks(logits, (SIZE, SIZE))
        return (0.8 * jlosses.dice_loss(m, gt)
                + 0.2 * jlosses.dice_loss(m, tm)), logits

    (jloss, jlogits), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(v["params"])

    model = SegFormer(cfg)
    model.load_state_dict(state_dict_from_flax(cfg, v["params"],
                                               v["batch_stats"]))
    logits, _ = model(torch.from_numpy(x))
    m = predict_masks(logits, (SIZE, SIZE))
    loss = 0.8 * losses.dice_loss(m, _t(gt)) + \
        0.2 * losses.dice_loss(m, _t(tm))
    params = dict(model.named_parameters())
    grads = grads_of(loss, params)
    _close(logits, jlogits, atol=1e-4, rtol=1e-4)
    _close(loss, jloss, atol=1e-6)
    ref = state_dict_from_flax(cfg, jax.tree.map(np.asarray, jgrads))
    scale = max(float(np.abs(ref[n].numpy()).max()) for n in params)
    assert set(grads) == set(params)
    for n, g in grads.items():
        _close(g, ref[n], atol=1e-5 * scale, rtol=1e-3, err_msg=n)


# ---- the EMA step -------------------------------------------------------

EMA_TINY = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
                num_heads=(1, 2, 4, 8), decoder_hidden=32)


@pytest.mark.parametrize("accum", [1, 2])
def test_ema_trajectory_matches_jax(accum):
    """3 float32 steps of `ema_semi_step` from one state, with fresh inputs
    each step, against the JAX step (attn_impl "xla", its default). The
    classifier bias is set to 2 so the teacher's soft masks sit near 0.88:
    every unlabeled sample passes the pseudo-label gate and every denoised
    pixel is far from its threshold, so no binary decision hangs on a
    rounding. Losses agree to ~1e-6. Adam moves each parameter by about
    lr*sign(g) on these first steps, so an element whose gradient is at
    rounding level can move the other way: parameters agree to 2e-6 (the
    student's lr is 3e-5) and the teacher, 0.1% of the student's move, far
    closer."""
    jcfg = JCfg(**EMA_TINY)
    cfg = MiTConfig(**EMA_TINY)
    v = jax_variables(jcfg, seed=3)
    v["params"]["decode_head"]["classifier"]["bias"][:] = 2.0
    tc = JTrainConfig()
    jt = JTrainState.create(v, tc, lr=5e-7)
    js = JTrainState.create(v, tc, lr=3e-5)
    teacher = train_state_from_flax(cfg, jt)
    student = train_state_from_flax(cfg, js)
    assert float(student.base_lr) == pytest.approx(3e-5)
    rng = np.random.default_rng(4)
    for step in range(3):
        unl, imgs = (rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
                     for _ in "ui")
        gt = (rng.uniform(size=(2, SIZE, SIZE)) > 0.6).astype(np.float32)
        jout = jema.ema_semi_step(jt, js, jnp.asarray(unl),
                                  jnp.asarray(imgs), jnp.asarray(gt),
                                  jnp.asarray(0.8), jnp.asarray(0.999),
                                  jcfg, accum=accum)
        jt, js = jout.teacher_state, jout.student_state
        out = ema_semi_step(teacher, student, _t(unl), _t(imgs), _t(gt),
                            0.8, 0.999, accum=accum)
        for a, b in zip(out[2:6], jout[2:6]):
            _close(a, b, atol=2e-6, rtol=1e-5)
        assert float(out.n_kept) == float(jout.n_kept) == 2.0
        _close(out.pseudo_mask, jout.pseudo_mask, atol=0)
    for ours, theirs, atol in ((student, js, 2e-6), (teacher, jt, 1e-8)):
        ref = state_dict_from_flax(cfg, jax.tree.map(np.asarray,
                                                     theirs.params),
                                   jax.tree.map(np.asarray,
                                                theirs.batch_stats))
        for n, p in ours.params.items():
            _close(p, ref[n], atol=atol, rtol=1e-6, err_msg=n)
        for n, b in ours.batch_stats.items():
            _close(b, ref[n], atol=1e-7, rtol=1e-6, err_msg=n)
    assert int(student.count) == 3


def test_ema_step_changes_only_what_it_should():
    """On the CPU: the student moves, the teacher moves by exactly the EMA
    of the updated student, and a NaN supervision target skips the
    student's update entirely (and the teacher still takes its EMA)."""
    cfg = MiTConfig(**EMA_TINY)
    w = bench.make_workload(cfg, 2, SIZE, 1, torch.device("cpu"))
    t0 = {n: p.detach().clone() for n, p in w.teacher.params.items()}
    s0 = {n: p.detach().clone() for n, p in w.student.params.items()}
    out = w.step()
    assert torch.isfinite(out.student_loss_total)
    s1 = w.student.params
    assert any(not torch.equal(s0[n], s1[n]) for n in s0)
    decay = torch.tensor(0.999)
    for n, p in w.teacher.params.items():
        assert torch.equal(p, decay * t0[n] + (1.0 - decay) * s1[n]), n
    s1 = {n: p.detach().clone() for n, p in s1.items()}
    nan_gt = torch.full_like(w.masks, float("nan"))
    out = ema_semi_step(w.teacher, w.student, w.unlabeled, w.images, nan_gt,
                        0.8, 0.999)
    assert torch.isnan(out.student_loss_total)
    assert int(w.student.count) == 1
    for n, p in w.student.params.items():
        assert torch.equal(p, s1[n]), n


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="remat"):
        MiTConfig(remat="dots")
    with pytest.raises(NotImplementedError, match="remat"):
        MiTConfig(remat="save:ln1+q")
    with pytest.raises(ValueError, match="remat"):
        MiTConfig(remat="some")
    # train mode is ported; attention dropout in train mode is not
    model = SegFormer(MiTConfig(**EMA_TINY, attention_dropout=0.1))
    with pytest.raises(NotImplementedError, match="attention_dropout"):
        forward_masks(model, torch.zeros(1, SIZE, SIZE, 3), train_mode=True,
                      generator=torch.Generator())


def test_remat_does_not_change_gradients():
    """`remat="full"` (a checkpoint per layer) and `"none"` give the same
    gradients: the recompute repeats the same float32 operations."""
    cfg = MiTConfig(**TINY, **CASES["per_layer_prompts_cls"])
    full = SegFormer(cfg)
    none = SegFormer(cfg.replace(remat="none"))
    none.load_state_dict(full.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(2, SIZE, SIZE, 3)).astype(np.float32))
    g_full = grads_of(full(x)[0].square().mean(),
                      dict(full.named_parameters()))
    g_none = grads_of(none(x)[0].square().mean(),
                      dict(none.named_parameters()))
    for n in g_full:
        torch.testing.assert_close(g_full[n], g_none[n], rtol=0, atol=0)


def test_bench_quick_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        bench.main(["--quick", "--device", "cpu", "--grad-accum", "2"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["unit"] == "images/sec/chip"
    assert "quick/cpu" in line["metric"] and line["value"] > 0
    assert line["vs_baseline"] == pytest.approx(line["value"] / 17.2,
                                                abs=1e-3)


def test_bf16_model_keeps_float32_masters():
    """In bfloat16 the parameters stay float32 and their gradients arrive
    in float32 (the dense and conv weights are cast at use)."""
    cfg = MiTConfig(**EMA_TINY, dtype="bfloat16")
    model = SegFormer(cfg)
    x = torch.rand(1, SIZE, SIZE, 3)
    logits, _ = model(x)
    grads = grads_of(logits.float().mean(), dict(model.named_parameters()))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert grads["segformer.encoder.block.0.0.attention.self.query.weight"] \
        .abs().sum() > 0
    served = copy.deepcopy(model)
    from semisupervisedobjectdetection_torch.models.segformer import (
        cast_to_compute_dtype,
    )
    cast_to_compute_dtype(served)
    with torch.no_grad():
        torch.testing.assert_close(served(x)[0], logits.detach(), rtol=0,
                                   atol=0)
