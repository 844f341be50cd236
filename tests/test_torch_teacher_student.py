"""The port's gradient teacher-student steps (`semisupervisedobjectdetection_
torch/train/teacher_student.py`) against the JAX package's on the CPU, with
the same weights (`jax_variables` carried over by `train_state_from_flax`)
and the same numpy inputs, float32, on a tiny config (two stages of one
layer):

- `pseudo_label_step` over 4 steps at accum 1 and 2, the update gate True,
  False, True and True again on a step in which no sample is kept (the NaN
  loss skips the update);
- `pseudo_label_infer_step` in train mode (drop rates 0): pseudo-labels and
  the BatchNorm statistics it moves;
- `labeled_step` over 3 steps at accum 1 and 2 with label denoising, at
  accum 1 without it, and in train mode at accum 2: all four losses, both
  models' parameters and BatchNorm statistics;

and, without JAX, that `TrainState.apply_gradients(enable=False)` leaves
the state bit-equal and that `copy_student_to_teacher` copies without
aliasing and keeps the teacher's Adam state.
"""

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
from semisupervisedobjectdetection_tpu.train import teacher_student as jts
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
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
    init_weights,
)
from semisupervisedobjectdetection_torch.train import teacher_student as ts
from semisupervisedobjectdetection_torch.train.state import TrainState
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    SIZE,
    jax_variables,
    one_torch_thread,
)

# two stages of one layer (sr ratios 8 and 4), drop rates 0: the JAX
# compile of a two-model step takes about half of a four-stage one's
SMALL = dict(depths=(1, 1), hidden_sizes=(8, 16), num_heads=(1, 2),
             patch_sizes=(7, 3), strides=(4, 2), sr_ratios=(8, 4),
             prompt_tokens=(0, 0), cls_tokens=(0, 0), decoder_hidden=32,
             drop_path_rate=0.0, classifier_dropout=0.0)
T_LR, S_LR = 5e-7, 3e-5
# per parameter element, as tests/test_torch_train.py holds the EMA step:
# the student at lr 3e-5 to 2e-6, a teacher at lr 5e-7 to 1e-8
ATOL = {T_LR: 1e-8, S_LR: 2e-6}
CLS_BIAS = "decode_head.classifier.bias"
BN = "decode_head.batch_norm."
# the decode head's per-stage projection biases add a per-channel constant
# that BatchNorm on batch statistics removes: in train mode their gradient
# is rounding noise on both sides (tests/test_torch_train_mode.py)
SHIFT_ONLY = {f"decode_head.linear_c.{i}.proj.bias" for i in range(2)}


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(port, ref, **kw):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **kw)


def _states(seed, lrs):
    """JAX and port states of one seeded tiny model per lr. The classifier
    bias is 2, so the soft masks sit near 0.88: every sample passes the
    pseudo-label gate and every denoised pixel is far from its threshold,
    so no binary decision hangs on a rounding."""
    jcfg, cfg = JCfg(**SMALL), MiTConfig(**SMALL)
    v = jax_variables(jcfg, seed=seed)
    v["params"]["decode_head"]["classifier"]["bias"][:] = 2.0
    js = [JTrainState.create(v, JTrainConfig(), lr=lr) for lr in lrs]
    return jcfg, cfg, js, [train_state_from_flax(cfg, j) for j in js]


def _check_state(cfg, ours, theirs, lr, train_mode):
    """Parameters to ATOL[lr] (the shift-only biases in train mode to 3 lr
    of the student's scaled by the bound, as test_torch_train_mode.py
    holds them), BatchNorm statistics to 1e-7 (eval mode: untouched) or
    1e-5 (train mode), and Adam's count equal."""
    atol = ATOL[lr]
    ref = state_dict_from_flax(cfg, jax.tree.map(np.asarray, theirs.params),
                               jax.tree.map(np.asarray, theirs.batch_stats))
    for n, p in ours.params.items():
        tol = 3 * S_LR * (atol / 2e-6) if train_mode and n in SHIFT_ONLY \
            else atol
        _close(p, ref[n], atol=tol, rtol=1e-6, err_msg=n)
    bn_tol = 1e-5 if train_mode else 1e-7
    for n, b in ours.batch_stats.items():
        _close(b, ref[n], atol=bn_tol, rtol=1e-5, err_msg=n)
    (adam,) = [s for s in jax.tree.leaves(
        theirs.opt_state,
        is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert int(ours.count) == int(adam.count)


def _set_cls_bias(jstate, state, value):
    """The same classifier bias on both sides (the JAX state rebuilt, the
    port's written in place)."""
    params = jax.tree.map(lambda x: x, jstate.params)
    head = params["decode_head"]["classifier"]
    params["decode_head"]["classifier"] = {
        **head, "bias": jnp.full_like(head["bias"], value)}
    with torch.no_grad():
        state.params[CLS_BIAS].fill_(value)
    return jstate.replace(params=params)


@pytest.mark.parametrize("accum", [1, 2])
def test_pseudo_label_step_matches_jax(accum):
    """4 phase-A steps of one teacher (lr 3e-5, a self-training update seen
    at the student's bound) with the gate True, False, True, then True on a
    batch the gate rejects whole (classifier bias -3 on both sides: soft
    masks near 0.05, under 1000 soft foreground pixels): the NaN loss skips
    the update, so only steps 0 and 2 move the teacher. The pseudo loss to
    2e-6 (NaN on both sides at step 3), the kept counts, masks and gates
    exactly, the final parameters to 2e-6."""
    jcfg, cfg, (jt,), (teacher,) = _states(31, (S_LR,))
    rng = np.random.default_rng(32)
    for step, update in enumerate((True, False, True, True)):
        if step == 3:
            jt = _set_cls_bias(jt, teacher, -3.0)
        u = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
        jout = jts.pseudo_label_step(jt, jnp.asarray(u), jnp.asarray(update),
                                     jcfg, accum=accum)
        jt = jout.teacher_state
        out = ts.pseudo_label_step(teacher, _t(u), torch.tensor(update),
                                   accum=accum)
        _close(out.loss, jout.loss, atol=2e-6, rtol=1e-5, equal_nan=True)
        assert float(out.n_kept) == float(jout.n_kept) == \
            (0.0 if step == 3 else 2.0)
        _close(out.pseudo_mask, jout.pseudo_mask, atol=0)
        _close(out.keep, jout.keep, atol=0)
    assert np.isnan(float(out.loss))
    assert int(teacher.count) == 2
    _check_state(cfg, teacher, jt, S_LR, train_mode=False)


def test_pseudo_label_infer_step_matches_jax_in_train_mode():
    """3 train-mode phase-A forwards without an update (drop rates 0):
    pseudo-labels as the JAX step gives them, and the BatchNorm statistics
    each forward moves (1e-5) while the parameters stay bit-equal."""
    jcfg, cfg, (jt,), (teacher,) = _states(33, (T_LR,))
    before = {n: p.detach().clone() for n, p in teacher.params.items()}
    bn0 = teacher.batch_stats[BN + "running_mean"].clone()
    rng = np.random.default_rng(34)
    for step in range(3):
        u = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
        jout = jts.pseudo_label_infer_step(jt, jnp.asarray(u), jcfg,
                                           train_mode=True,
                                           rng=jax.random.PRNGKey(step))
        jt = jout.teacher_state
        out = ts.pseudo_label_infer_step(
            teacher, _t(u), train_mode=True,
            generator=torch.Generator().manual_seed(step))
        _close(out.loss, jout.loss, atol=2e-6, rtol=1e-5)
        assert float(out.n_kept) == float(jout.n_kept) == 2.0
        _close(out.pseudo_mask, jout.pseudo_mask, atol=0)
    for n, p in teacher.params.items():
        assert torch.equal(p, before[n]), n
    assert not torch.equal(teacher.batch_stats[BN + "running_mean"], bn0)
    _check_state(cfg, teacher, jt, T_LR, train_mode=True)
    assert int(teacher.count) == 0


@pytest.mark.parametrize("accum,denoise,train_mode", [
    (1, True, False), (2, True, False), (1, False, False), (2, True, True)],
    ids=["accum1", "accum2", "accum1_no_denoise", "accum2_train_mode"])
def test_labeled_step_matches_jax(accum, denoise, train_mode):
    """3 phase-B steps from one teacher (lr 5e-7) and one student (lr 3e-5)
    of the same weights, fresh inputs each step, against the JAX
    `labeled_step`: the student's total, the teacher's loss, the
    supervised and self-supervised losses to 2e-6; both models'
    parameters (student 2e-6, teacher 1e-8) and BatchNorm statistics. In
    train mode (drop rates 0) both models normalise with batch statistics
    and keep their running averages, threaded through the microbatches."""
    jcfg, cfg, (jt, js), (teacher, student) = _states(35, (T_LR, S_LR))
    rng = np.random.default_rng(36)
    for step in range(3):
        x = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
        gt = (rng.uniform(size=(2, SIZE, SIZE)) > 0.6).astype(np.float32)
        jout = jts.labeled_step(jt, js, jnp.asarray(x), jnp.asarray(gt),
                                jnp.asarray(0.8), jcfg,
                                denoise_label=denoise, train_mode=train_mode,
                                rng=jax.random.PRNGKey(step), accum=accum)
        jt, js = jout.teacher_state, jout.student_state
        out = ts.labeled_step(teacher, student, _t(x), _t(gt), 0.8,
                              denoise_label=denoise, train_mode=train_mode,
                              accum=accum,
                              generator=torch.Generator().manual_seed(step))
        for a, b in zip(out[2:], jout[2:]):
            _close(a, b, atol=2e-6, rtol=1e-5)
    assert int(teacher.count) == int(student.count) == 3
    _check_state(cfg, student, js, S_LR, train_mode)
    _check_state(cfg, teacher, jt, T_LR, train_mode)
    if train_mode:
        for state in (teacher, student):
            assert not np.allclose(
                state.batch_stats[BN + "running_mean"].numpy(),
                np.asarray(jax_variables(jcfg, seed=35)["batch_stats"]
                           ["decode_head"]["batch_norm"]["mean"]))


# ---- without JAX ----------------------------------------------------------

def _tiny_state(seed, lr=1e-3):
    return TrainState.create(
        init_weights(SegFormer(MiTConfig(**SMALL)),
                     torch.Generator().manual_seed(seed)),
        TrainConfig(), lr=lr)


def _snapshot(state):
    return {**{"p." + n: p.detach().clone()
               for n, p in state.params.items()},
            **{"b." + n: b.clone() for n, b in state.batch_stats.items()},
            **{"mu." + n: m.clone() for n, m in state.mu.items()},
            **{"nu." + n: v.clone() for n, v in state.nu.items()},
            "count": state.count.clone()}


def test_disabled_update_leaves_the_state_bit_equal():
    """`apply_gradients(enable=False)` on a finite loss changes nothing (the
    gate is a tensor: no host read); `enable=True` updates as without it.
    A disabled train-mode `pseudo_label_step` still moves the BatchNorm
    statistics and nothing else."""
    state = _tiny_state(1)
    grads = {n: torch.randn(p.shape, generator=torch.Generator()
                            .manual_seed(2)) for n, p in state.mu.items()}
    loss = torch.tensor(0.5)
    state.apply_gradients(grads, loss)          # non-zero moments
    before = _snapshot(state)
    state.apply_gradients(grads, loss, enable=torch.tensor(False))
    after = _snapshot(state)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    twin = _tiny_state(1)
    twin.apply_gradients(grads, loss)
    twin.apply_gradients(grads, loss, enable=torch.tensor(True))
    state.apply_gradients(grads, loss)
    for k, v in _snapshot(twin).items():
        assert torch.equal(_snapshot(state)[k], v), k
    assert int(state.count) == 2

    before = _snapshot(state)
    x = torch.rand(2, SIZE, SIZE, 3, generator=torch.Generator()
                   .manual_seed(3))
    ts.pseudo_label_step(state, x, torch.tensor(False), train_mode=True,
                         accum=2)
    after = _snapshot(state)
    moved = {k for k, v in before.items() if not torch.equal(after[k], v)}
    assert moved == {"b." + BN + "running_mean", "b." + BN + "running_var"}


def test_copy_student_to_teacher_copies_without_aliasing():
    teacher, student = _tiny_state(4), _tiny_state(5)
    for state in (teacher, student):
        g = {n: torch.ones_like(p) for n, p in state.mu.items()}
        state.apply_gradients(g, torch.tensor(1.0))
    with torch.no_grad():
        student.batch_stats[BN + "running_mean"].fill_(0.25)
    moments = {n: (m.clone(), teacher.nu[n].clone())
               for n, m in teacher.mu.items()}
    ts.copy_student_to_teacher(teacher, student)
    s_params = student.params
    for n, p in teacher.params.items():
        assert torch.equal(p, s_params[n]), n
        assert p.data_ptr() != s_params[n].data_ptr(), n
    for n, b in teacher.batch_stats.items():
        assert torch.equal(b, student.batch_stats[n]), n
        assert b.data_ptr() != student.batch_stats[n].data_ptr(), n
    for n, (m, v) in moments.items():
        assert torch.equal(teacher.mu[n], m) and torch.equal(teacher.nu[n], v)
    assert int(teacher.count) == 1
    # the two models stay apart: a write to the student leaves the teacher
    with torch.no_grad():
        s_params[CLS_BIAS].add_(1.0)
    assert not torch.equal(teacher.params[CLS_BIAS], s_params[CLS_BIAS])
