"""The port's supervised and transfer CLIs on the CPU at MiT-B0 64x64:

- `cli.supervised` writes its CSV, the best and `_last` checkpoints,
  resumes at the next epoch, and `--predict --dump-masks` evaluates the best
  checkpoint and writes the overlays;
- `cli.transfer` warm-starts from a checkpoint, keeps the frozen stages'
  layers bit-equal to it and trains the prompt tokens (--no-quirks);
- the flags whose paths are not ported are refused naming ROADMAP.md, the
  ported --async-checkpoint, --plot-curves and --profile-dir are taken,
  --loss bce is refused for the JAX package's reason (the
  quantized predict and the sliding raster are held in
  tests/test_torch_quant_serving.py and tests/test_torch_sliding_window.py),
  without `--device` both need a card, and on the card a prompt prefix that
  takes SR-attention past 288 keys is taken by the kernel check (the bf16
  kernels stream K/V there);
- the teacher-student CLI takes the 0.999 EMA default only under
  `--ema-mode`.
"""

import contextlib
import csv
import io
import math
import os
import tempfile

import pytest
import torch

from semisupervisedobjectdetection_torch.api import SegFormerModel
from semisupervisedobjectdetection_torch.cli import (
    autoencoder,
    common,
    supervised,
    teacher_student,
    transfer,
)
from semisupervisedobjectdetection_torch.core.config import mit_b0, mit_b5
from semisupervisedobjectdetection_torch.models.segformer import (
    attention_shapes,
    check_attention_kernels,
)
from test_torch_segformer import one_torch_thread  # noqa: F401

ARGS = ["--synthetic", "--device", "cpu", "--variant", "b0", "--img-size",
        "64", "--synthetic-n", "8", "--batch-size", "4", "--grad-accum", "2"]
FROZEN = ("segformer.encoder.block.0.", "segformer.encoder.block.1.")


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_supervised_cli_runs_resumes_and_predicts(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # the tiles
    ck = str(tmp_path / "ck")
    reports, out = _run(supervised.main, ARGS + [
        "--epochs", "2", "--resume", "--checkpoint-dir", ck,
        "--metrics-csv", str(tmp_path / "a.csv")])
    rows = _rows(tmp_path / "a.csv")
    assert [r["step"] for r in rows] == ["0", "1"]
    assert list(rows[0]) == ["step", "wall_s", "train_loss", "eval_loss",
                             "dice", "miou", "miou_per_image", "fps", "lr"]
    for r in rows:
        assert math.isfinite(float(r["train_loss"]))
        assert 0.0 <= float(r["eval_loss"]) <= 1.0
        assert 0.0 <= float(r["miou"]) <= 1.0
    # the schedule steps once an epoch: lr = 1e-5 * 0.97**(epoch + 1)
    assert float(rows[1]["lr"]) == pytest.approx(1e-5 * 0.97 ** 2)
    # 8 tiles in batches of 4: 2 steps of 4 images per epoch
    assert [(r["epoch"], r["train_steps"], r["train_images"])
            for r in reports] == [(0, 2, 8), (1, 2, 8)]
    names = os.listdir(ck)
    assert {"segformer_last.pt", "segformer_last.meta.json"} <= set(names)
    best = reports[-1]["best_path"]
    assert best and os.path.basename(best) in names
    assert "resumed" not in out

    reports, out = _run(supervised.main, ARGS + [
        "--epochs", "3", "--resume", "--checkpoint-dir", ck,
        "--metrics-csv", str(tmp_path / "b.csv")])
    assert "resumed from epoch 2" in out
    assert [r["epoch"] for r in reports] == [2]
    assert [r["step"] for r in _rows(tmp_path / "b.csv")] == ["2"]

    dump = str(tmp_path / "dump")
    result, out = _run(supervised.main, ARGS + [
        "--predict", "--pretrain-weight", best, "--dump-masks", dump])
    # 8 // 3 -> 4 eval tiles, one overlay pair each
    assert result["dumped"] == 4 and 0.0 <= result["eval_loss"] <= 1.0
    assert len([n for n in os.listdir(dump) if n.endswith("_pred.png")]) == 4


def test_transfer_cli_keeps_frozen_stages_and_trains_prompts(tmp_path,
                                                            monkeypatch):
    """A warm start from a supervised-shaped checkpoint, stages 0 and 1
    frozen, 2 prompt tokens per stage trained (--no-quirks): after two
    epochs the frozen layers equal the warm start bit for bit, the prompt
    tokens and the other stages have moved."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    warm = SegFormerModel(config=mit_b0(), device="cpu", seed=11)
    start = str(tmp_path / "warm.pt")
    warm.save(start)
    ck = str(tmp_path / "ck")
    _run(transfer.main, ARGS + [
        "--epochs", "2", "--frozen", "0,1", "--prompt-tokens", "2,2,2,2",
        "--no-quirks", "--pretrain-weight", start, "--resume",
        "--checkpoint-dir", ck])
    before = torch.load(start, weights_only=True)["model"]
    after = torch.load(os.path.join(ck, "segformer_last.pt"),
                       weights_only=True)
    moved = {n for n, t in before.items() if not torch.equal(after["model"][n],
                                                             t)}
    assert not any(n.startswith(FROZEN) for n in moved)
    assert any(n.startswith("segformer.encoder.block.2.") for n in moved)
    assert "segformer.encoder.patch_embeddings.0.proj.weight" in moved
    assert not any(n.startswith(FROZEN) for n in after["mu"])
    seeded = SegFormerModel(config=mit_b0(prompt_tokens=(2,) * 4),
                            device="cpu", seed=0).state.model.state_dict()
    for i in range(4):
        name = f"segformer.encoder.prompt_tokens.{i}"
        assert name in after["mu"]
        assert not torch.equal(after["model"][name], seeded[name]), name


@pytest.mark.parametrize("cli,flags", [
    (supervised, ["--loss", "bce"]),
    (supervised, ["--async-checkpoint"]),
    (supervised, ["--parallel", "pp"]), (supervised, ["--parallel", "dp_pp"]),
    (supervised, ["--plot-curves"]), (supervised, ["--profile-dir", "p"]),
    (supervised, ["--ffn-impl", "xla"]),
    (transfer, ["--parallel", "dp"]),
], ids=lambda v: v.__name__.rsplit(".", 1)[-1] if hasattr(v, "__name__")
    else " ".join(v))
def test_unported_flags_are_refused(cli, flags, monkeypatch, tmp_path):
    """--parallel other than none and --ffn-impl are refused naming
    ROADMAP.md; --loss bce for the JAX package's reason (its CLI cannot
    train with it); --async-checkpoint, --plot-curves and --profile-dir,
    ported since, get past the refusals to the training loop (stubbed
    here)."""
    monkeypatch.chdir(tmp_path)         # --profile-dir p writes there
    argv = ["--device", "cpu", "--synthetic", "--img-size", "32",
            "--synthetic-n", "4"] + flags
    if flags[0] in ("--async-checkpoint", "--plot-curves", "--profile-dir"):
        ran = []
        monkeypatch.setattr(cli, "train_loop",
                            lambda *a, **k: ran.append(1) or [])
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(argv) == []
        assert ran == [1]
        return
    match = "no 'bce' branch" if flags == ["--loss", "bce"] else "ROADMAP"
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


@pytest.mark.parametrize("cli", [supervised, transfer, autoencoder],
                         ids=["supervised", "transfer", "autoencoder"])
def test_default_device_needs_a_card(cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic"])


def test_prefix_past_the_kernels_is_refused_before_a_model(monkeypatch):
    """MiT-B5 at 512x512 reduces every stage to 256 keys: 10 prompt tokens
    give Nk = 266, 40 give 296, past the 288 keys the bfloat16 kernels hold
    on chip. The card path takes both in bfloat16 (the CLIs' default
    dtype; past 288 keys the streaming kernels run) and in float32, so the
    CLIs go on to make their data (nothing falls back to the plain
    attention). The CPU runs the plain attention and takes any prefix."""
    cuda = torch.device("cuda")
    bf16 = {"dtype": "bfloat16"}
    assert [nk for _, nk, _ in attention_shapes(
        mit_b5(prompt_tokens=(40,) * 4), 512, 512)] == [296] * 4
    check_attention_kernels(mit_b5(prompt_tokens=(32,) * 4, **bf16), 512,
                            512, cuda)
    check_attention_kernels(mit_b5(prompt_tokens=(40,) * 4, **bf16), 512,
                            512, cuda)
    check_attention_kernels(mit_b5(prompt_tokens=(40,) * 4), 512, 512, cuda)
    check_attention_kernels(mit_b5(prompt_tokens=(40,) * 4, **bf16), 512,
                            512, torch.device("cpu"))
    check_attention_kernels(mit_b5(prompt_tokens=(40,) * 4,
                                   attn_impl="plain", **bf16), 512, 512, cuda)

    def built(*a, **k):
        raise AssertionError("a model or data was built")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(transfer, "SegFormerModel", built)
    monkeypatch.setattr(common, "ensure_data", built)
    with pytest.raises(AssertionError, match="a model or data was built"):
        transfer.main(["--synthetic", "--variant", "b5", "--img-size", "512",
                       "--prompt-tokens", "40,40,40,40"])
    with pytest.raises(AssertionError, match="a model or data was built"):
        supervised.main(["--synthetic", "--variant", "b5", "--img-size",
                         "1024"])


def test_ema_default_only_under_ema_mode():
    """--ema 0 becomes the mean-teacher decay 0.999 under --ema-mode only:
    the gradient loop keeps 0 (no EMA of the teacher)."""
    assert teacher_student.parse_args(["--synthetic"]).ema == 0.0
    assert teacher_student.parse_args(["--ema-mode"]).ema == 0.999
    assert teacher_student.parse_args(["--ema-mode", "--ema", "0.9"]).ema \
        == 0.9
