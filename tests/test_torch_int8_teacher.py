"""The port's int8 EMA teacher (`train/ema.py::ema_semi_step_int8`,
`make_teacher_int8_snapshot`) on the CPU:

- the snapshot equals the JAX package's (`make_teacher_int8_snapshot`)
  through the weight bridge, bit for bit, and one float32 step from one
  state at accum 1 and at accum 2 (the microbatch path) follows the JAX
  step at the tolerances of
  `tests/test_torch_train.py::test_ema_trajectory_matches_jax` (the JAX side
  in a fresh interpreter, tests/_int8_teacher_main.py);
- the snapshot stays as it was through steps that move the teacher, and
  shares no storage with it;
- `cli/teacher_student.py --ema-mode --int8-teacher` takes a snapshot an
  epoch and runs its steps on it; the gradient loop refuses the flag.
"""

import contextlib
import copy
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from semisupervisedobjectdetection_tpu.core.config import (
    MiTConfig as JCfg,
    TrainConfig as JTrainConfig,
)
from semisupervisedobjectdetection_tpu.train import ema as jema
from semisupervisedobjectdetection_tpu.train.state import (
    TrainState as JTrainState,
)
from semisupervisedobjectdetection_torch import bench
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    state_dict_from_flax,
)
from semisupervisedobjectdetection_torch.cli import teacher_student
from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import SegFormer
from semisupervisedobjectdetection_torch.train import ema
from semisupervisedobjectdetection_torch.train.state import TrainState
from test_torch_segformer import (  # noqa: F401 (autouse fixture)
    SIZE,
    jax_variables,
    one_torch_thread,
)

# Two stages of one layer (the JAX compile of the step takes about half of
# a four-stage one's) and one width in both (the eager JAX quantization
# compiles each of its ops once per distinct kernel shape).
ITINY = dict(depths=(1, 1), hidden_sizes=(32, 32), num_heads=(1, 2),
             patch_sizes=(7, 3), strides=(4, 2), sr_ratios=(8, 4),
             prompt_tokens=(0, 0), cls_tokens=(0, 0), decoder_hidden=32)
ACCUMS = (1, 2)


def _inputs():
    rng = np.random.default_rng(22)
    unl, imgs = (rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
                 for _ in "ui")
    gt = (rng.uniform(size=(2, SIZE, SIZE)) > 0.6).astype(np.float32)
    return unl, imgs, gt


def _flat(cfg, params, stats):
    return {n: t.numpy() for n, t in state_dict_from_flax(
        cfg, jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, stats)).items()}


def jax_int8_teacher_steps() -> dict:
    """The JAX side, run by tests/_int8_teacher_main.py: the initial
    weights (classifier bias 2, so the teacher's soft masks sit near 0.88:
    every unlabeled sample passes the gate and no denoised pixel is near
    its threshold), the int8 snapshot as the port's state dict (its int8
    weights as their bytes), and per accum the step's outputs and both
    models' parameters and statistics after it, as numpy arrays."""
    jcfg = JCfg(**ITINY)
    cfg = MiTConfig(**ITINY)
    v = jax_variables(jcfg, seed=21)
    v["params"]["decode_head"]["classifier"]["bias"][:] = 2.0
    out = {f"init/{n}": a for n, a in
           _flat(cfg, v["params"], v["batch_stats"]).items()}
    unl, imgs, gt = (jnp.asarray(a) for a in _inputs())
    tc = JTrainConfig()
    for accum in ACCUMS:
        jt = JTrainState.create(v, tc, lr=5e-7)
        js = JTrainState.create(v, tc, lr=3e-5)
        qvars, qcfg = jema.make_teacher_int8_snapshot(jt, jcfg)
        if accum == ACCUMS[0]:
            snap = _flat(cfg.replace(quant="int8"), qvars["params"],
                         qvars["batch_stats"])
            out.update({f"snapshot/{n}": (a.view(np.uint8) if a.dtype ==
                                          np.int8 else a)
                        for n, a in snap.items()})
        jout = jema.ema_semi_step_int8(
            qvars, jt, js, unl, imgs, gt, jnp.asarray(0.8),
            jnp.asarray(0.999), jcfg, qcfg, accum=accum)
        for i, a in enumerate(jout[2:8]):
            out[f"accum{accum}/out{i}"] = np.asarray(a, np.float32)
        for name, st in (("student", jout.student_state),
                         ("teacher", jout.teacher_state)):
            for n, a in _flat(cfg, st.params, st.batch_stats).items():
                out[f"accum{accum}/{name}/{n}"] = a
    return out


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    path = tmp_path_factory.mktemp("int8_teacher") / "jax.npz"
    script = os.path.join(os.path.dirname(__file__), "_int8_teacher_main.py")
    proc = subprocess.run([sys.executable, script, str(path)],
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0 and "int8-teacher-jax-ok" in proc.stdout, (
        f"the JAX side failed:\n{proc.stdout[-3000:]}\n"
        f"{proc.stderr[-3000:]}")
    with np.load(path) as f:
        return dict(f)


def _states(ref):
    """Teacher and student TrainStates of the port from the JAX side's
    initial weights, with fresh Adam state (as `TrainState.create` on both
    sides)."""
    cfg = MiTConfig(**ITINY)
    model = SegFormer(cfg)
    model.load_state_dict({n[5:]: torch.from_numpy(a) for n, a in
                           ref.items() if n.startswith("init/")},
                          strict=True)
    tc = TrainConfig()
    teacher = TrainState.create(copy.deepcopy(model), tc, lr=5e-7)
    student = TrainState.create(model, tc, lr=3e-5)
    return teacher, student


def _close(port, ref, **kw):
    np.testing.assert_allclose(np.asarray(port.detach(), np.float32),
                               np.asarray(ref, np.float32), **kw)


@pytest.mark.parametrize("accum", ACCUMS)
def test_int8_teacher_step_matches_jax(accum, jax_steps):
    """One float32 step of `ema_semi_step_int8` from one state against the
    JAX step: the snapshots are the same bits, so the teacher's int8
    forwards differ only where an activation an ulp apart rounds to the
    next int8 step; losses to 2e-6, the pseudo-mask exact, the student's
    parameters to 2e-6 and the teacher's (0.1% of the student's move) to
    1e-8, as the float32 EMA trajectory test holds them."""
    teacher, student = _states(jax_steps)
    snap = ema.make_teacher_int8_snapshot(teacher)
    for n, t in snap.state_dict().items():
        want = jax_steps[f"snapshot/{n}"]
        got = t.view(torch.uint8) if t.dtype == torch.int8 else t
        np.testing.assert_array_equal(got.numpy(), want, err_msg=n)
    unl, imgs, gt = (torch.from_numpy(a) for a in _inputs())
    out = ema.ema_semi_step_int8(snap, teacher, student, unl, imgs, gt,
                                 0.8, 0.999, accum=accum)
    ref = [jax_steps[f"accum{accum}/out{i}"] for i in range(6)]
    for a, b in zip(out[2:6], ref[:4]):
        _close(a, b, atol=2e-6, rtol=1e-5)
    assert float(out.n_kept) == float(ref[4]) == 2.0
    _close(out.pseudo_mask, ref[5], atol=0)
    for name, state, atol in (("student", student, 2e-6),
                              ("teacher", teacher, 1e-8)):
        for n, p in state.params.items():
            _close(p, jax_steps[f"accum{accum}/{name}/{n}"], atol=atol,
                   rtol=1e-6, err_msg=n)
        for n, b in state.batch_stats.items():
            _close(b, jax_steps[f"accum{accum}/{name}/{n}"], atol=1e-7,
                   rtol=1e-6, err_msg=n)
    assert int(student.count) == 1


def test_snapshot_stays_frozen_while_the_teacher_moves():
    """Two train-mode steps (accum 2) on one snapshot: every snapshot
    tensor keeps its bits (the LayerNorm weights, convs, biases and
    BatchNorm statistics too, which the in-place EMA moves in the teacher),
    and no snapshot tensor shares storage with the teacher."""
    w = bench.make_workload(MiTConfig(**ITINY), 2, SIZE, 2,
                            torch.device("cpu"))
    snap = ema.make_teacher_int8_snapshot(w.teacher)
    assert snap.cfg.quant == "int8" and not snap.training
    before = {n: t.clone() for n, t in snap.state_dict().items()}
    teacher0 = {n: t.clone() for n, t in
                w.teacher.model.state_dict().items()}
    ptrs = {t.untyped_storage().data_ptr()
            for t in w.teacher.model.state_dict().values()}
    assert not ptrs & {t.untyped_storage().data_ptr()
                       for t in snap.state_dict().values()}
    for _ in range(2):
        out = ema.ema_semi_step_int8(
            snap, w.teacher, w.student, w.unlabeled, w.images, w.masks,
            0.8, 0.999, accum=2, train_mode=True,
            generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(out.student_loss_total)
    for n, t in snap.state_dict().items():
        assert torch.equal(t.view(torch.uint8) if t.dtype == torch.int8
                           else t, before[n].view(torch.uint8)
                           if t.dtype == torch.int8 else before[n]), n
    moved = [n for n, t in w.teacher.model.state_dict().items()
             if not torch.equal(t, teacher0[n])]
    assert any(n.endswith("layer_norm_1.weight") for n in moved)
    assert any(n.endswith("running_mean") for n in moved)


def test_ema_cli_int8_teacher(tmp_path, monkeypatch):
    """`--ema-mode --int8-teacher`, 2 epochs of one step: a snapshot of the
    teacher at the start of each epoch, every step on the int8 path (the
    training mode's default quirks: the student in train mode)."""
    calls = {"snapshots": [], "steps": 0}
    real_snap, real_step = (teacher_student.make_teacher_int8_snapshot,
                            teacher_student.ema_semi_step_int8)

    def snapshot(state):
        calls["snapshots"].append(
            state.model.state_dict()["decode_head.batch_norm.running_mean"]
            .clone())
        return real_snap(state)

    def step(*a, **kw):
        calls["steps"] += 1
        return real_step(*a, **kw)

    monkeypatch.setattr(teacher_student, "make_teacher_int8_snapshot",
                        snapshot)
    monkeypatch.setattr(teacher_student, "ema_semi_step_int8", step)
    monkeypatch.setattr(teacher_student, "ema_semi_step",
                        lambda *a, **k: pytest.fail("float teacher step"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        reports = teacher_student.main(
            ["--ema-mode", "--int8-teacher", "--synthetic", "--device",
             "cpu", "--variant", "b0", "--img-size", "64", "--synthetic-n",
             "4", "--batch-size", "4", "--grad-accum", "2", "--epochs", "2",
             "--checkpoint-dir", str(tmp_path)])
    assert [r["train_steps"] for r in reports] == [1, 1]
    # the second epoch's snapshot is of the teacher the first epoch moved
    first, second = calls["snapshots"]
    assert calls["steps"] == 2 and not torch.equal(first, second)
    assert all(np.isfinite(r["best_student"]) for r in reports)
