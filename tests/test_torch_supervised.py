"""The port's supervised steps (`semisupervisedobjectdetection_torch/train/
supervised.py`) and trainable masks (`train/state.py`) against the JAX
package on the CPU, with the same weights (`jax_variables` carried over by
`state_dict_from_flax`) and the same numpy inputs:

- a 3-step float32 `train_step` trajectory at accum 1 and 2, in eval mode
  and in train mode at rates 0: losses, predictions, final parameters and
  BatchNorm statistics (the JAX side in a fresh interpreter,
  tests/_sup_trajectory_main.py);
- `predict_step`;
- the trainable mask of frozen stages (0, 1) with shared and per-layer
  prompt tokens and CLS tokens, reference quirks on and off, against the JAX
  mask mapped through the weight bridge;
- a 2-step frozen-stages-plus-prompts trajectory from states built with
  that mask, frozen parameters bit-equal to their start on both sides.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from semisupervisedobjectdetection_tpu.core.config import (
    MiTConfig as JCfg,
    TrainConfig as JTrainConfig,
)
from semisupervisedobjectdetection_tpu.train import state as jstate
from semisupervisedobjectdetection_tpu.train import supervised as jsup
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
)
from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import SegFormer
from semisupervisedobjectdetection_torch.train.state import (
    TrainState,
    frozen_stage_predicate,
    trainable_mask_from,
)
from semisupervisedobjectdetection_torch.train.supervised import (
    predict_step,
    train_step,
)
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    CASES,
    SIZE,
    TINY,
    jax_variables,
    one_torch_thread,
)

NO_RANDOM = dict(drop_path_rate=0.0, classifier_dropout=0.0)
SMALL = dict(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
             num_heads=(1, 2, 4, 8), decoder_hidden=32, **NO_RANDOM)
LR = 3e-5
# the decode head's per-stage projection biases add a per-channel constant
# that BatchNorm on batch statistics removes: in train mode their gradient
# is 0 in exact arithmetic, rounding noise on both sides, which Adam turns
# into a move of about lr per step either way (test_torch_train_mode.py)
SHIFT_ONLY = {f"decode_head.linear_c.{i}.proj.bias" for i in range(4)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **kw)


def _batch(rng, n=2):
    x = rng.uniform(size=(n, SIZE, SIZE, 3)).astype(np.float32)
    gt = (rng.uniform(size=(n, SIZE, SIZE)) > 0.6).astype(np.float32)
    return x, gt


def _jax_state_dict(cfg, js):
    return state_dict_from_flax(cfg, jax.tree.map(np.asarray, js.params),
                                jax.tree.map(np.asarray, js.batch_stats))


def _jax_mu(cfg, js):
    """The JAX state's first Adam moments by port name (zeros where the
    trainable mask leaves a parameter without them)."""
    (adam,) = [s for s in jax.tree.leaves(
        js.opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return state_dict_from_flax(cfg, jax.tree.map(
        lambda p, m: np.zeros(p.shape, np.float32)
        if isinstance(m, optax.MaskedNode) else np.array(m),
        js.params, adam.mu))


class _Gradients:
    """Each step's gradient as both optimizers took it (clipped, plus weight
    decay), by port name, for the trained parameters: recovered from the
    first Adam moments, g_t = (mu_t - b1 mu_{t-1}) / (1 - b1)."""

    def __init__(self, cfg, state):
        self.cfg, self.state, self.b1 = cfg, state, state.tc.adam_b1
        self.mu = {n: (torch.zeros_like(m), torch.zeros_like(m))
                   for n, m in state.mu.items()}
        self.steps = []

    def record(self, ref):
        """`ref`: the JAX step's first moments by port name (`_jax_mu`)."""
        step = ({}, {})
        for n, (last_port, last_ref) in self.mu.items():
            now = (self.state.mu[n].clone(), ref[n])
            for g, m, last in zip(step, now, (last_port, last_ref)):
                g[n] = (m - self.b1 * last) / (1.0 - self.b1)
            self.mu[n] = now
        self.steps.append(step)


def _check_params(cfg, state, ref, train_mode, steps, grads):
    """Parameters to 2e-6, `test_torch_train.py`'s trajectory bound at lr
    3e-5, except where the cause below is seen element by element.

    Each step's gradients (`_Gradients`) agree to 1e-5 of the step's largest
    gradient (float32 sums in another order; 1e-6 seen). Adam moves an
    element by about lr*g/|g|, so two sides whose gradients differ by dg
    move it lr*|dg|/|g| apart: within 2e-6 while |g| >= lr/2e-6 * |dg|
    (15 |dg|). An element below that on some step has a gradient at
    rounding level (the summed gradient cancels); it is held to 0.5 lr per
    step (0.3 lr over 3 steps seen: such gradients are near Adam's eps,
    1e-8, which damps the move). In train mode the shift-only biases'
    gradients are rounding noise in every element, and each step may move
    them lr the other way: 2 lr per step.
    BatchNorm statistics to 1e-7 in eval mode (untouched). In train mode
    the running means take, at momentum 0.1 per step, the mean of the
    fuse's output, to which those biases' difference passes through the
    fuse's rows: 1e-5 plus 0.1 x steps x each row's L1 norm x the largest
    bias difference; the running variances to 1e-5. `ref` is the JAX
    state's parameters and statistics by port name."""
    near_zero = {}
    for port, theirs in grads.steps:
        top = max(g.abs().max().item() for g in theirs.values())
        for n, g in theirs.items():
            dg = (port[n] - g).abs()
            assert dg.max().item() <= 1e-5 * top, (n, dg.max().item(), top)
            near = g.abs() < LR / 2e-6 * dg
            near_zero[n] = near_zero[n] | near if n in near_zero else near
    shift = 0.0
    for n, p in state.params.items():
        diff = (p.detach() - ref[n]).abs()
        if train_mode and n in SHIFT_ONLY:
            assert diff.max().item() <= 2 * LR * steps, n
            shift = max(shift, diff.max().item())
            continue
        ok = diff <= 2e-6 + 1e-6 * ref[n].abs()
        if n in near_zero:
            ok |= near_zero[n] & (diff <= 0.5 * LR * steps)
        assert torch.all(ok), (n, diff.max().item())
    bn = "decode_head.batch_norm."
    tol = {bn + "running_mean": 1e-7, bn + "running_var": 1e-7}
    if train_mode:
        rows = ref["decode_head.linear_fuse.weight"].abs().sum((1, 2, 3))
        tol = {bn + "running_mean": 1e-5 + 0.1 * steps * shift * rows,
               bn + "running_var": 1e-5}
    for n, b in state.batch_stats.items():
        assert torch.all((b - ref[n]).abs() <= tol[n] + 1e-5 * ref[n].abs()
                         ), n


def jax_train_step_trajectory(accum: int, train_mode: bool) -> dict:
    """The JAX side of `test_train_step_trajectory_matches_jax`, run by
    tests/_sup_trajectory_main.py in a fresh interpreter (the jit of a
    train step is a large new executable, which the XLA:CPU compile cache
    can abort on in a long-lived worker): the initial weights, then per
    step the loss, the predicted masks and the first Adam moments, then
    the final parameters and statistics, by port name, as numpy arrays."""
    jcfg, cfg = JCfg(**SMALL), MiTConfig(**SMALL)
    v = jax_variables(jcfg, seed=21)
    out = {f"init/{n}": t.numpy() for n, t in state_dict_from_flax(
        cfg, v["params"], v["batch_stats"]).items()}
    js = jstate.TrainState.create(v, JTrainConfig(), lr=LR)
    rng = np.random.default_rng(22)
    for step in range(3):
        x, gt = _batch(rng)
        js, jloss, jpred = jsup.train_step(
            js, jnp.asarray(x), jnp.asarray(gt), jax.random.PRNGKey(step),
            jcfg, train_mode=train_mode, accum=accum)
        out[f"step{step}/loss"] = np.asarray(jloss, np.float32)
        out[f"step{step}/pred"] = np.asarray(jpred, np.float32)
        for n, m in _jax_mu(cfg, js).items():
            out[f"step{step}/mu/{n}"] = m.numpy()
    for n, t in _jax_state_dict(cfg, js).items():
        out[f"final/{n}"] = t.numpy()
    return out


def _by_prefix(arrays, prefix):
    return {n[len(prefix):]: torch.from_numpy(a) for n, a in arrays.items()
            if n.startswith(prefix)}


@pytest.mark.parametrize("train_mode", [False, True],
                         ids=["eval_mode", "train_mode"])
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_trajectory_matches_jax(accum, train_mode, tmp_path):
    """3 float32 `train_step`s from one state, fresh inputs each step,
    against the JAX `train_step` (its default XLA attention): the dice
    losses to 2e-6 and the predicted masks to 1e-5 (float32 sums in another
    order through 4 layers), the parameters and BatchNorm statistics as
    `_check_params` says. In train mode at rates 0 both sides normalise with
    batch statistics and keep their running averages, threaded through the
    microbatches. The JAX side (`jax_train_step_trajectory`) runs in a
    fresh interpreter and hands its arrays over in a file; the port starts
    from its initial weights with fresh Adam state, as
    `jstate.TrainState.create` starts the JAX side."""
    path = tmp_path / "jax_trajectory.npz"
    script = os.path.join(os.path.dirname(__file__),
                          "_sup_trajectory_main.py")
    proc = subprocess.run([sys.executable, script, str(accum),
                           str(int(train_mode)), str(path)],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0 and "sup-trajectory-jax-ok" in proc.stdout, (
        f"the JAX side failed:\n{proc.stdout[-3000:]}\n"
        f"{proc.stderr[-3000:]}")
    with np.load(path) as f:
        ref = dict(f)
    cfg = MiTConfig(**SMALL)
    model = SegFormer(cfg)
    init = _by_prefix(ref, "init/")
    model.load_state_dict(init, strict=True)
    state = TrainState.create(model, TrainConfig(), lr=LR)
    grads = _Gradients(cfg, state)
    rng = np.random.default_rng(22)
    for step in range(3):
        x, gt = _batch(rng)
        _, loss, pred = train_step(
            state, _t(x), _t(gt), train_mode=train_mode, accum=accum,
            generator=torch.Generator().manual_seed(step))
        grads.record(_by_prefix(ref, f"step{step}/mu/"))
        _close(loss, ref[f"step{step}/loss"], atol=2e-6, rtol=1e-5)
        _close(pred, ref[f"step{step}/pred"], atol=1e-5)
    assert int(state.count) == 3
    _check_params(cfg, state, _by_prefix(ref, "final/"), train_mode, 3,
                  grads)
    if train_mode:
        bn = "decode_head.batch_norm.running_mean"
        assert not np.allclose(state.batch_stats[bn].numpy(),
                               init[bn].numpy())


def test_predict_step_matches_jax():
    """The eval-mode masks of the tiny config with shared prompt and CLS
    tokens: float32 sums in another order through 6 layers, 1e-5."""
    extra = CASES["shared_prompts_cls"]
    jcfg, cfg = JCfg(**TINY, **extra), MiTConfig(**TINY, **extra)
    v = jax_variables(jcfg, seed=23)
    js = jstate.TrainState.create(v, JTrainConfig())
    model = SegFormer(cfg)
    model.load_state_dict(state_dict_from_flax(cfg, v["params"],
                                               v["batch_stats"]))
    x, _ = _batch(np.random.default_rng(24), 3)
    jpred = jsup.predict_step(js, jnp.asarray(x), jcfg)
    pred = predict_step(TrainState.create(model, TrainConfig()), _t(x))
    assert pred.shape == (3, SIZE, SIZE) and not pred.requires_grad
    _close(pred, jpred, atol=1e-5)


def _mapped_jax_mask(cfg, params, predicate):
    """The JAX trainable mask carried through the weight bridge: name ->
    trained."""
    mask = jstate.trainable_mask_from(params, predicate)
    ones = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                        mask, params)
    sd = state_dict_from_flax(cfg, ones)
    names = dict(SegFormer(cfg).named_parameters())
    out = {}
    for n in names:
        vals = np.unique(sd[n].numpy())
        assert len(vals) == 1, n
        out[n] = bool(vals[0])
    return out


@pytest.mark.parametrize("quirks", [True, False], ids=["quirks", "no_quirks"])
@pytest.mark.parametrize("case", ["shared_prompts_cls",
                                  "per_layer_prompts_cls"])
def test_trainable_mask_matches_jax(case, quirks):
    """Frozen stages (0, 1): their layers freeze, their patch embeddings and
    final norms do not; under the reference's quirks the prompt and CLS
    tokens freeze too. The port's mask over its parameter names equals the
    JAX mask mapped through the weight bridge."""
    jcfg, cfg = JCfg(**TINY, **CASES[case]), MiTConfig(**TINY, **CASES[case])
    params = jax_variables(jcfg, seed=25)["params"]
    want = _mapped_jax_mask(cfg, params, jstate.frozen_stage_predicate(
        (0, 1), freeze_prompts=quirks, freeze_cls=quirks))
    got = trainable_mask_from(SegFormer(cfg), frozen_stage_predicate(
        (0, 1), freeze_prompts=quirks, freeze_cls=quirks))
    assert got == want
    frozen = {n for n, m in got.items() if not m}
    assert any(n.startswith("segformer.encoder.block.1.") for n in frozen)
    assert not any(n.startswith("segformer.encoder.block.2.")
                   or "patch_embeddings" in n for n in frozen)
    tokens = {n for n in got if "prompt_tokens" in n or "cls_token" in n}
    assert tokens and (tokens <= frozen) == quirks


def test_frozen_prompt_trajectory_matches_jax():
    """2 float32 steps with stages 0 and 1 frozen and shared prompt tokens
    and CLS tokens trained (quirks off), from states built with the mask on
    both sides: the frozen parameters stay bit-equal to their start and have
    no moments, everything else follows the JAX step as in the trajectory
    test, and gradients reach the stage-0 patch embedding through the frozen
    layers above it."""
    extra = CASES["shared_prompts_cls"]
    jcfg, cfg = JCfg(**SMALL, **extra), MiTConfig(**SMALL, **extra)
    v = jax_variables(jcfg, seed=26)
    jmask = jstate.trainable_mask_from(v["params"],
                                       jstate.frozen_stage_predicate((0, 1)))
    js = jstate.TrainState.create(v, JTrainConfig(), lr=LR,
                                  trainable_mask=jmask)
    model = SegFormer(cfg)
    model.load_state_dict(state_dict_from_flax(cfg, v["params"],
                                               v["batch_stats"]))
    mask = trainable_mask_from(model, frozen_stage_predicate((0, 1)))
    state = TrainState.create(model, TrainConfig(), lr=LR,
                              trainable_mask=mask)
    start = {n: p.detach().clone() for n, p in state.params.items()}
    frozen = {n for n, m in mask.items() if not m}
    assert frozen and frozen.isdisjoint(state.mu)
    assert all(not state.params[n].requires_grad for n in frozen)
    grads = _Gradients(cfg, state)
    rng = np.random.default_rng(27)
    for step in range(2):
        x, gt = _batch(rng)
        js, jloss, _ = jsup.train_step(js, jnp.asarray(x), jnp.asarray(gt),
                                       jax.random.PRNGKey(step), jcfg)
        _, loss, _ = train_step(state, _t(x), _t(gt))
        grads.record(_jax_mu(cfg, js))
        _close(loss, jloss, atol=2e-6, rtol=1e-5)
    _check_params(cfg, state, _jax_state_dict(cfg, js), False, 2, grads)
    for n in frozen:
        assert torch.equal(state.params[n], start[n]), n
    for n in ("segformer.encoder.patch_embeddings.0.proj.weight",
              "segformer.encoder.prompt_tokens.0"):
        assert not torch.equal(state.params[n], start[n]), n



def test_dice_argmax_step_is_a_weight_decay_step():
    """The binarised dice is piecewise constant: its gradient is 0 (as
    `jax.grad` of the JAX loss gives), so a "dice_argmax" step is Adam on
    the weight decay alone, the same as `apply_gradients` with zero
    gradients, and its loss is 1 - the mean dice of the binarised masks
    (per sample, so the microbatches' mean is the batch's)."""
    cfg = MiTConfig(**SMALL)
    a, b = SegFormer(cfg), SegFormer(cfg)
    b.load_state_dict(a.state_dict())
    start = {n: t.clone() for n, t in a.state_dict().items()}
    sa = TrainState.create(a, TrainConfig(), lr=LR)
    sb = TrainState.create(b, TrainConfig(), lr=LR)
    x, gt = _batch(np.random.default_rng(28))
    _, loss, pred = train_step(sa, _t(x), _t(gt), loss_type="dice_argmax",
                               accum=2)
    sb.apply_gradients({n: torch.zeros_like(p)
                        for n, p in sb.trainable_params.items()}, loss)
    for n, p in sa.params.items():
        assert torch.equal(p, sb.params[n]), n
    w = "decode_head.classifier.weight"
    assert not torch.equal(sa.params[w], start[w])
    hard, y = (pred >= 0.5).float(), _t(gt)
    dice = (2 * (hard * y).sum((1, 2)) + 1) / (hard.sum((1, 2))
                                               + y.sum((1, 2)) + 1)
    _close(loss, 1.0 - dice.mean(), atol=1e-6)
