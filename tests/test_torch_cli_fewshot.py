"""The port's few-shot CLI (`semisupervisedobjectdetection_torch/cli/
fewshot.py`) on the CPU at MiT-B0 64x64 with synthetic domains:

- `--mode ae`: 2 epochs with --resume (CSV rows, best and `_last`
  checkpoints, `epoch_report` lines), then a resumed third epoch;
- `--mode seg` at --grad-accum 2: an epoch, then `--predict` from its best
  checkpoint;
- the domain pairs and batches of 2 epochs in both modes equal the JAX
  CLI's, with the steps and the model stubbed out on both sides (no model
  is compiled for it);
- the `--grad-accum` refusals in the JAX CLI's words, `--tune` and its
  flags refused naming ROADMAP.md, and no run without a card unless
  `--device cpu` is given.
"""

import contextlib
import csv
import io
import math
import os
import tempfile
from types import SimpleNamespace

import pytest
import torch

from semisupervisedobjectdetection_tpu.cli import fewshot as jcli
from semisupervisedobjectdetection_torch.cli import fewshot
from test_torch_segformer import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
ARGS = ["--synthetic", "--variant", "b0", "--img-size", "64",
        "--synthetic-n", "6", "--iterations", "2"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_ae_cli_runs_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the tiles
    ck = str(tmp_path / "ck")
    argv = CPU + ARGS + ["--mode", "ae", "--resume", "--checkpoint-dir", ck,
                         "--metrics-csv", str(tmp_path / "m.csv")]
    reports, out = _run(fewshot.main, argv + ["--epochs", "2"])
    assert "3 labeled domains, 3 unlabeled domains" in out
    assert out.count("epoch_report ") == 2 and "resumed" not in out
    # 2 iterations of 4 batches of 2 images an epoch
    assert [(r["epoch"], r["mode"], r["train_steps"], r["train_images"])
            for r in reports] == [(0, "ae", 2, 16), (1, "ae", 2, 16)]
    rows = _rows(tmp_path / "m.csv")
    assert [r["step"] for r in rows] == ["0", "1"]
    assert all(math.isfinite(float(r[k])) for r in rows
               for k in ("train_loss", "eval_loss"))
    names = set(os.listdir(ck))
    assert {"fewshot_ae_last.pt", "fewshot_ae_last.meta.json"} <= names
    best = reports[-1]["best_path"]
    assert os.path.basename(best) in names
    assert os.path.basename(best).startswith("fewshot_ae_epoch_")
    # the CPU launches no kernel
    assert all(r["launches_train"] == [0, 0] and r["peak_bytes"] is None
               for r in reports)
    saved = torch.load(best, map_location="cpu", weights_only=True)
    assert saved["model"]["decode_head.classifier.weight"].shape[0] == 3
    assert {f"segformer.encoder.cls_token.{i}" for i in range(4)} <= \
        set(saved["mu"])
    again, out = _run(fewshot.main, argv + ["--epochs", "3"])
    assert "resumed from epoch 2" in out
    assert [r["epoch"] for r in again] == [2]
    assert [r["step"] for r in _rows(tmp_path / "m.csv")] == ["2"]


def test_seg_cli_trains_then_predicts(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    ck = str(tmp_path / "ck")
    reports, out = _run(fewshot.main, CPU + ARGS + [
        "--mode", "seg", "--grad-accum", "2", "--epochs", "1",
        "--checkpoint-dir", ck])
    assert [(r["train_steps"], r["train_images"]) for r in reports] == \
        [(2, 8)]
    assert math.isfinite(reports[0]["train_loss"])
    assert 0.0 <= reports[0]["eval_loss"] <= 1.0
    best = reports[0]["best_path"]
    assert os.path.basename(best).startswith("fewshot_seg_epoch_0_")
    assert os.listdir(ck) == [os.path.basename(best)]   # no --resume
    got, out = _run(fewshot.main, CPU + ARGS + [
        "--mode", "seg", "--predict", "--pretrain-weight", best])
    assert "Pretrained model loaded" in out and "eval loss: " in out
    assert got["eval_loss"] == pytest.approx(reports[0]["eval_loss"],
                                             abs=1e-6)


class _Recorder:
    """Each `RoundRobin.next_from` of a CLI: the domain directory and the
    bytes of the batch it gave."""

    def __init__(self, monkeypatch, cls):
        self.calls = []
        real = cls.next_from

        def next_from(rr, idx):
            images_u8, masks_u8 = real(rr, idx)
            d = rr.loaders[idx].dataset.data_dir
            self.calls.append((os.path.basename(os.path.dirname(d)),
                               os.path.basename(d), images_u8.tobytes(),
                               None if masks_u8 is None
                               else masks_u8.tobytes()))
            return images_u8, masks_u8

        monkeypatch.setattr(cls, "next_from", next_from)


class _State:
    params = batch_stats = None

    def scheduler_step(self):
        return self


@pytest.mark.parametrize("mode", ["ae", "seg"])
def test_pair_schedule_matches_jax_cli(tmp_path, monkeypatch, mode):
    """2 epochs of 3 iterations: the same domains drawn in the same order,
    and the same tile bytes in every batch. The steps, the state and the
    evaluation are stubbed on both sides; the tiles are real."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--synthetic", "--variant", "b0", "--img-size", "64",
            "--synthetic-n", "12", "--iterations", "3", "--epochs", "2",
            "--mode", mode, "--checkpoint-dir", "", "--seed", "5"]
    jrec = _Recorder(monkeypatch, jcli.RoundRobin)
    monkeypatch.setattr(jcli, "_build_state", lambda *a: _State())
    monkeypatch.setattr(jcli.common, "device_train_batch",
                        lambda rng, i, m, dcfg: (i, m))
    monkeypatch.setattr(jcli.common, "device_eval_batch",
                        lambda i, m, dcfg: (i, m))
    monkeypatch.setattr(jcli.common, "host_floats",
                        lambda xs: [float(x) for x in xs])
    monkeypatch.setattr(jcli, "eval_step", lambda *a: (0.5, None))
    monkeypatch.setattr(jcli, "_eval_ae_recon", lambda *a: 0.5)
    step = "fewshot_ae_step" if mode == "ae" else "fewshot_seg_step"
    monkeypatch.setattr(jcli.fw, step, lambda state, *a, **k:
                        SimpleNamespace(state=state, loss=0.0))
    _run(jcli.main, argv)

    rec = _Recorder(monkeypatch, fewshot.RoundRobin)
    monkeypatch.setattr(fewshot, "build_state", lambda *a: _State())
    monkeypatch.setattr(fewshot, "_eval_losses", lambda *a, **k: [0.5])
    monkeypatch.setattr(fewshot.fw, step, lambda state, *a, **k:
                        SimpleNamespace(loss=torch.zeros(())))
    reports, _ = _run(fewshot.main, CPU + argv)
    per_iter = 4 if mode == "ae" else 2
    assert len(rec.calls) == len(jrec.calls) == 2 * 3 * per_iter
    assert [c[:2] for c in rec.calls] == [c[:2] for c in jrec.calls]
    assert rec.calls == jrec.calls
    groups = {c[0] for c in rec.calls}
    assert groups == ({"labeled", "unlabeled"} if mode == "ae"
                      else {"labeled"})
    assert all((c[3] is None) == (c[0] == "unlabeled") for c in rec.calls)
    assert [r["train_steps"] for r in reports] == [3, 3]


@pytest.mark.parametrize("flags", [
    ["--mode", "ae", "--grad-accum", "2"],
    ["--mode", "seg", "--grad-accum", "3"],
    ["--mode", "seg", "--grad-accum", "2", "--cls-loss-weight", "1.0"],
], ids=["ae_micro_of_1", "seg_indivisible", "seg_cls_micro_of_1"])
def test_grad_accum_refusals_match_jax_cli(flags):
    """Before any data or model: the JAX CLI's SystemExit, word for word."""
    with pytest.raises(SystemExit) as jerr:
        jcli.main(["--synthetic"] + flags)
    with pytest.raises(SystemExit) as err:
        fewshot.main(CPU + ["--synthetic"] + flags)
    assert str(err.value) == str(jerr.value) != ""
    assert "few-shot" in str(err.value) or "microbatches" in str(err.value)


@pytest.mark.parametrize("flags", [["--tune"], ["--tune-lrs", "1e-4"],
                                   ["--tune-max", "2"]],
                         ids=["tune", "tune_lrs", "tune_max"])
def test_tune_is_refused(flags):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        fewshot.main(CPU + ["--synthetic"] + flags)


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fewshot.main(["--synthetic", "--variant", "b0", "--img-size", "64"])
