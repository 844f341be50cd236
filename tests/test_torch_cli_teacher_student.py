"""The port's gradient teacher-student loop (`cli/teacher_student.py`
without `--ema-mode`) on the CPU at MiT-B0 64x64, synthetic tiles:

- a run warm-started by --pretrain-weight updates the teacher in phase A on
  update epochs only (epoch 0 of every 4, without the reference's quirks),
  trains both models in phase B, writes its CSV, both models' best and
  `_last` checkpoints and `epoch_report` lines with each phase's launches,
  and a --resume run continues from the saved Adam state at the next
  epoch;
- --reset-teacher copies the student into the teacher after epoch 5
  (resumed from `_last` checkpoints of epoch 4), keeping the teacher's Adam
  state, and --ema pulls the teacher towards the student once per epoch;
- --pretrain-weight and --hf-weights warm-start both models, in both loops,
  with fresh Adam state at epoch 0;
- the flags still unported are refused naming ROADMAP.md, and without
  --device the loop needs a card.
"""

import contextlib
import csv
import io
import os
import tempfile

import pytest
import torch

from semisupervisedobjectdetection_torch.checkpoint.io import (
    save_last,
    save_state,
)
from semisupervisedobjectdetection_torch.cli import teacher_student
from semisupervisedobjectdetection_torch.core.config import (
    MIT_VARIANTS,
    TrainConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    init_weights,
)
from semisupervisedobjectdetection_torch.train.state import TrainState
from test_torch_segformer import one_torch_thread  # noqa: F401

ARGS = ["--synthetic", "--device", "cpu", "--variant", "b0", "--img-size",
        "64", "--synthetic-n", "8", "--batch-size", "4", "--grad-accum", "2",
        "--no-quirks"]
CLS_BIAS = "decode_head.classifier.bias"


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        reports = teacher_student.main(argv)
    return reports, out.getvalue()


def _state(seed, cls_bias=None, lr=1e-3):
    """A state of the CLI's model (MiT-B0, bf16 compute) from a seed; with
    `cls_bias` the classifier bias set to it (2: soft masks near 0.88, so
    the pseudo-label gate keeps every unlabeled tile)."""
    model = init_weights(SegFormer(MIT_VARIANTS["b0"](dtype="bfloat16")),
                         torch.Generator().manual_seed(seed))
    if cls_bias is not None:
        with torch.no_grad():
            dict(model.named_parameters())[CLS_BIAS].fill_(cls_bias)
    return TrainState.create(model, TrainConfig(), lr=lr)


def _trained(state, steps=3):
    """Give `state` non-zero moments, a count and an epoch."""
    g = {n: torch.full_like(p, 0.01) for n, p in state.mu.items()}
    for _ in range(steps):
        state.apply_gradients(g, torch.tensor(0.5))
    state.scheduler_step()
    return state


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_gradient_loop_updates_resumes_and_reports(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the tiles
    warm = str(tmp_path / "warm.pt")
    save_state(warm, _trained(_state(3, cls_bias=2.0)))
    ck = str(tmp_path / "ck")
    reports, out = _main(ARGS + [
        "--epochs", "2", "--resume", "--pretrain-weight", warm,
        "--checkpoint-dir", ck, "--metrics-csv", str(tmp_path / "a.csv")])
    assert "warm-started teacher+student" in out
    with open(tmp_path / "a.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["step", "wall_s", "train_loss", "eval_loss",
                             "teacher_train", "teacher_eval", "images_used",
                             "miou", "miou_per_image", "fps"]
    assert [r["step"] for r in rows] == ["0", "1"]
    # 8 unlabeled and 8 labeled tiles in batches of 4: 2 + 2 steps an epoch;
    # the fresh teacher's Adam count after phase A: 2 self-training updates
    # on epoch 0, then only phase B's 2 per epoch
    assert [(r["epoch"], r["phase_a"]["update"], r["phase_a"]["steps"],
             r["phase_b"]["steps"], r["phase_a"]["teacher_adam_count"],
             r["train_images"]) for r in reports] == [
        (0, True, 2, 2, 2, 16), (1, False, 2, 2, 4, 16)]
    assert [float(r["images_used"]) for r in rows] == [8.0, 8.0]
    for r in reports:
        assert r["launches_train"] == [0, 0]      # the CPU's plain path
        assert set(r) >= {"phase_a", "phase_b", "eval_s", "peak_bytes",
                          "launches_eval_k1", "checkpoint_s"}
    names = os.listdir(ck)
    for prefix in ("ts_teacher", "ts_student"):
        assert f"{prefix}_last.pt" in names
        assert any(n.startswith(prefix + "_epoch_0_") for n in names)
    teacher, student = (_load(os.path.join(ck, p + "_last.pt"))
                        for p in ("ts_teacher", "ts_student"))
    # fresh Adam and epoch 0 at the warm start (the file held count 3,
    # epoch 1): 6 teacher and 4 student updates, 2 schedule steps
    assert (int(teacher["count"]), int(student["count"])) == (6, 4)
    assert float(teacher["epoch"]) == float(student["epoch"]) == 2.0

    reports, out = _main(ARGS + ["--epochs", "3", "--resume",
                                 "--checkpoint-dir", ck])
    assert "resumed teacher+student from epoch 2" in out
    assert [(r["epoch"], r["phase_a"]["update"],
             r["phase_a"]["teacher_adam_count"]) for r in reports] == \
        [(2, False, 6)]
    assert int(_load(os.path.join(ck, "ts_teacher_last.pt"))["count"]) == 8


def test_reset_teacher_and_ema_at_epoch_5(tmp_path, monkeypatch):
    """Resumed from `_last` checkpoints of epoch 4, epoch 5 trains, pulls
    the teacher towards the student once (--ema 0.5) and then, epoch 5
    being a multiple of 5, copies the student into the teacher: the
    teacher's `_last` holds the student's weights and BatchNorm statistics
    beside its own Adam state."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ck = str(tmp_path / "ck")
    save_last(ck, "ts_teacher", _trained(_state(4, lr=5e-7)), 4, 0.9)
    save_last(ck, "ts_student", _trained(_state(5, lr=3e-5), 2), 4, 0.9)
    calls = []
    ema_update = teacher_student.ts.ema_update

    def spy(teacher, student, decay):
        calls.append(decay)
        return ema_update(teacher, student, decay)

    monkeypatch.setattr(teacher_student.ts, "ema_update", spy)
    reports, out = _main(ARGS + ["--epochs", "6", "--resume",
                                 "--reset-teacher", "--ema", "0.5",
                                 "--checkpoint-dir", ck])
    assert [(r["epoch"], r["teacher_reset"]) for r in reports] == [(5, True)]
    assert "teacher reset" in out and calls == [0.5]
    teacher, student = (_load(os.path.join(ck, p + "_last.pt"))
                        for p in ("ts_teacher", "ts_student"))
    for n, t in student["model"].items():
        assert torch.equal(teacher["model"][n], t), n
    # the teacher's moments are its own: 3 + 2 updates, against 2 + 2
    assert (int(teacher["count"]), int(student["count"])) == (5, 4)
    assert any(not torch.equal(teacher["mu"][n], student["mu"][n])
               for n in teacher["mu"])


@pytest.mark.parametrize("flag,loop", [
    ("--pretrain-weight", "_grad_train_loop"),
    ("--hf-weights", "_grad_train_loop"),
    ("--pretrain-weight", "_ema_train_loop")],
    ids=["pretrain", "hf", "pretrain_ema_mode"])
def test_warm_start_of_both_models(tmp_path, monkeypatch, flag, loop):
    """Both models start from the file's weights and BatchNorm statistics
    with zero moments, count 0 and epoch 0, whatever Adam state the file
    holds; an HF-layout file (a bare state_dict) too."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    src = _trained(_state(6))
    with torch.no_grad():
        src.model.decode_head.batch_norm.running_mean.fill_(0.5)
    path = str(tmp_path / "w.pt")
    if flag == "--hf-weights":
        torch.save(src.model.state_dict(), path)
    else:
        save_state(path, src)
    seen = {}

    def capture(*args, teacher, student, **kw):
        seen.update(teacher=teacher, student=student, start=kw["start_epoch"])
        return []

    monkeypatch.setattr(teacher_student, loop, capture)
    argv = ARGS + [flag, path, "--checkpoint-dir", str(tmp_path / "ck")]
    _main(argv + (["--ema-mode"] if loop == "_ema_train_loop" else []))
    want = src.model.state_dict()
    for name in ("teacher", "student"):
        state = seen[name]
        for n, t in state.model.state_dict().items():
            assert torch.equal(t, want[n]), (name, n)
        assert all(not m.any() for m in state.mu.values())
        assert (int(state.count), float(state.epoch)) == (0, 0.0)
    assert seen["start"] == 0
    assert seen["teacher"].model is not seen["student"].model


@pytest.mark.parametrize("flags", [
    ["--tune"], ["--int8-teacher"], ["--async-checkpoint"]],
    ids=lambda f: " ".join(f))
def test_unported_flags_are_refused_in_the_gradient_loop(flags):
    with pytest.raises(SystemExit, match="ROADMAP"):
        teacher_student.main(["--device", "cpu", "--synthetic"] + flags)


def test_gradient_loop_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teacher_student.main(["--synthetic"])
