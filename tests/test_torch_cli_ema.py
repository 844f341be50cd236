"""The port's `--ema-mode` teacher-student CLI on the CPU at MiT-B0 64x64:
a run writes its CSV and both models' best and `_last` checkpoints, a
`--resume` run continues at the next epoch from them, the full-state
checkpoint round trip is exact, the flags whose paths are not ported are
refused, and without `--device` it needs a card."""

import contextlib
import csv
import io
import math
import os
import tempfile

import pytest
import torch

from semisupervisedobjectdetection_torch.checkpoint.io import (
    BestCheckpointer,
    load_last,
    restore_state,
    save_last,
    save_state,
)
from semisupervisedobjectdetection_torch.cli import teacher_student
from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    init_weights,
)
from semisupervisedobjectdetection_torch.train.state import TrainState
from test_torch_segformer import one_torch_thread  # noqa: F401

ARGS = ["--ema-mode", "--synthetic", "--device", "cpu", "--variant", "b0",
        "--img-size", "64", "--synthetic-n", "8", "--batch-size", "4",
        "--grad-accum", "2", "--resume", "--prefetch", "1"]


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        reports = teacher_student.main(argv)
    return reports, out.getvalue()


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_ema_cli_runs_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the tiles
    ck = str(tmp_path / "ck")
    reports, out = _main(ARGS + ["--epochs", "2", "--checkpoint-dir", ck,
                                 "--metrics-csv", str(tmp_path / "a.csv")])
    rows = _rows(tmp_path / "a.csv")
    assert [r["step"] for r in rows] == ["0", "1"]
    assert list(rows[0]) == ["step", "wall_s", "train_loss", "eval_loss",
                             "teacher_eval", "images_used", "pseudo_loss",
                             "miou", "miou_per_image", "fps"]
    for r in rows:
        assert math.isfinite(float(r["train_loss"]))
        assert math.isfinite(float(r["eval_loss"]))
        assert 0.0 <= float(r["miou"]) <= 1.0
    # 8 labeled tiles in batches of 4: 2 steps of 8 images per epoch
    assert [(r["epoch"], r["train_steps"], r["train_images"])
            for r in reports] == [(0, 2, 16), (1, 2, 16)]
    names = os.listdir(ck)
    for prefix in ("ts_teacher", "ts_student"):
        assert f"{prefix}_last.pt" in names
        assert f"{prefix}_last.meta.json" in names
        assert any(n.startswith(prefix + "_epoch_0_") for n in names)
    assert "resumed" not in out

    reports, out = _main(ARGS + ["--epochs", "3", "--checkpoint-dir", ck,
                                 "--metrics-csv", str(tmp_path / "b.csv")])
    assert "resumed teacher+student from epoch 2" in out
    assert [r["epoch"] for r in reports] == [2]
    assert [r["step"] for r in _rows(tmp_path / "b.csv")] == ["2"]


def _state(seed, lr=1e-3):
    cfg = MiTConfig(depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
                    num_heads=(1, 2, 4, 8), decoder_hidden=32)
    return TrainState.create(
        init_weights(SegFormer(cfg), torch.Generator().manual_seed(seed)),
        TrainConfig(), lr=lr)


def _tensors(state):
    return {**{"model." + k: v for k, v in state.model.state_dict().items()},
            **{"mu." + k: v for k, v in state.mu.items()},
            **{"nu." + k: v for k, v in state.nu.items()},
            "count": state.count, "epoch": state.epoch}


def test_last_checkpoint_round_trip_is_exact(tmp_path):
    a = _state(1)
    with torch.no_grad():
        for n in a.mu:
            a.mu[n].normal_()
            a.nu[n].uniform_()
        a.model.decode_head.batch_norm.running_mean.normal_()
    a.count.fill_(7)
    a.scheduler_step().scheduler_step()
    save_last(str(tmp_path), "m", a, epoch=4, best_loss=0.25)
    b = _state(2)
    state, next_epoch, best = load_last(str(tmp_path), "m", b)
    assert state is b and (next_epoch, best) == (5, 0.25)
    want, got = _tensors(a), _tensors(b)
    assert set(want) == set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert load_last(str(tmp_path), "absent", b) is None
    # another model is refused, not loaded in part
    other = TrainState.create(SegFormer(MiTConfig(
        depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
        num_heads=(1, 2, 4, 8), decoder_hidden=16)), TrainConfig())
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_state(os.path.join(str(tmp_path), "m_last.pt"), other)


def test_restore_state_options(tmp_path):
    """`load_opt_state=False` loads the weights by the partial-load rule
    (another decoder width keeps the template's decoder) and keeps the
    template's Adam state; `load_epoch=False` keeps its epoch."""
    a = _state(1)
    with torch.no_grad():
        for n in a.mu:
            a.mu[n].normal_()
    a.count.fill_(3)
    a.scheduler_step()
    path = os.path.join(str(tmp_path), "a.pt")
    save_state(path, a)
    b = _state(2)
    restore_state(path, b, load_opt_state=True, load_epoch=False)
    assert all(torch.equal(b.mu[n], a.mu[n]) for n in a.mu)
    assert (int(b.count), float(b.epoch)) == (3, 0.0)
    c = _state(3)
    restore_state(path, c, load_opt_state=False, load_epoch=False)
    for k, v in a.model.state_dict().items():
        assert torch.equal(c.model.state_dict()[k], v), k
    assert all(not m.any() for m in c.mu.values())
    assert (int(c.count), float(c.epoch)) == (0, 0.0)
    other = TrainState.create(SegFormer(MiTConfig(
        depths=(1, 1, 1, 1), hidden_sizes=(8, 16, 32, 64),
        num_heads=(1, 2, 4, 8), decoder_hidden=16)), TrainConfig())
    fuse = other.model.decode_head.linear_fuse.weight.detach().clone()
    restore_state(path, other, load_opt_state=False, load_epoch=False)
    assert torch.equal(other.model.decode_head.linear_fuse.weight, fuse)
    key = "segformer.encoder.block.0.0.mlp.dense1.weight"
    assert torch.equal(other.model.state_dict()[key],
                       a.model.state_dict()[key])


def test_best_checkpointer_gate(tmp_path):
    ck = BestCheckpointer(str(tmp_path), "ts_student")
    s = _state(4)
    assert ck.maybe_save(s, 0, 0.9, float("nan")) is None
    p = ck.maybe_save(s, 1, 0.9, 0.5, fps=2.0)
    assert os.path.basename(p) == \
        "ts_student_epoch_1_train_0.900_eval_0.500_fps_2.00.pt"
    assert ck.maybe_save(s, 2, 0.9, 0.5) is None
    assert ck.maybe_save(s, 3, 0.9, float("nan")) is None
    assert ck.maybe_save(s, 4, 0.9, 0.4) is not None


@pytest.mark.parametrize("flags", [
    ["--async-checkpoint"],
    ["--parallel", "dp"], ["--parallel", "pp"],
    ["--profile-dir", "p"], ["--plot-curves"], ["--ffn-impl", "xla"],
], ids=lambda f: " ".join(f))
def test_unported_flags_are_refused(flags):
    argv = ["--device", "cpu", "--synthetic", "--ema-mode"] + flags
    with pytest.raises(SystemExit, match="ROADMAP"):
        teacher_student.main(argv)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teacher_student.main(["--ema-mode", "--synthetic"])
