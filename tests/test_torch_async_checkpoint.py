"""`--async-checkpoint`, `--profile-dir` and `--plot-curves` of the port on
the CPU: `checkpoint/io.py::save_last_async` writes the same `_last`
checkpoint as `save_last` (a copy taken at submit, so later in-place
updates of the state do not reach the file), coalesces a queued write that
has not started with a newer one per (directory, prefix), reports a failed
write without raising, and `wait_pending_saves` blocks until the write has
landed; `utils/logging.py::profile_trace` writes a Chrome trace;
`utils/plot_metrics.py` draws a metrics CSV to a PNG; and the supervised
CLI with all three flags writes, resumes and draws."""

import contextlib
import io
import json
import os
import threading

import torch

from semisupervisedobjectdetection_torch.checkpoint import io as ckpt_io
from semisupervisedobjectdetection_torch.cli import supervised
from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    init_weights,
)
from semisupervisedobjectdetection_torch.train.state import TrainState
from semisupervisedobjectdetection_torch.utils.logging import profile_trace
from semisupervisedobjectdetection_torch.utils.plot_metrics import (
    plot_metrics,
)
from test_torch_segformer import TINY, one_torch_thread  # noqa: F401

WAIT_S = 60


def _state(seed=0):
    model = init_weights(SegFormer(MiTConfig(**TINY)),
                         torch.Generator().manual_seed(seed))
    state = TrainState.create(model, TrainConfig())
    with torch.no_grad():
        for n in state.mu:
            state.mu[n].fill_(0.5)
        state.count.fill_(3)
    return state


def _payload(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_async_last_equals_the_synchronous_write(tmp_path):
    """The file and its sidecar equal `save_last`'s; the state changed in
    place after the submit (as the next train step does) is not in it."""
    state = _state()
    ckpt_io.save_last(str(tmp_path / "sync"), "p", state, 4, 0.25)
    ckpt_io.save_last_async(str(tmp_path / "async"), "p", state, 4, 0.25)
    with torch.no_grad():
        for t in state.model.parameters():
            t.add_(1.0)
    ckpt_io.wait_pending_saves()
    want = _payload(tmp_path / "sync" / "p_last.pt")
    got = _payload(tmp_path / "async" / "p_last.pt")
    assert _equal(got, want)
    for d in ("sync", "async"):
        with open(tmp_path / d / "p_last.meta.json") as f:
            assert json.load(f) == {"epoch": 4, "best_loss": 0.25}


def test_async_write_records_its_timings(tmp_path):
    """Each landed write adds (host copy s, pickle-and-write s) to
    `async_save_timings`."""
    before = len(ckpt_io.async_save_timings())
    ckpt_io.save_last_async(str(tmp_path), "p", _state(), 1)
    ckpt_io.wait_pending_saves()
    got = ckpt_io.async_save_timings()
    assert len(got) == min(before + 1, 64)
    copy_s, write_s = got[-1]
    assert 0.0 <= copy_s and 0.0 < write_s


def test_queued_writes_coalesce_and_wait_blocks(tmp_path, monkeypatch):
    """While the first write runs, two more submits for the same prefix
    leave one queued write, the newest; `wait` returns only after both
    writes have landed. A failed write is printed, not raised."""
    saver = ckpt_io._AsyncSaver()
    started, release = threading.Event(), threading.Event()
    written = []
    real = ckpt_io._write_last

    def slow_write(directory, prefix, payload, epoch, best):
        if not written:
            started.set()
            assert release.wait(WAIT_S)
        written.append(epoch)
        return real(directory, prefix, payload, epoch, best)

    monkeypatch.setattr(ckpt_io, "_write_last", slow_write)
    state = _state()
    d = str(tmp_path)
    saver.submit(d, "p", state, 0)
    assert started.wait(WAIT_S)
    saver.submit(d, "p", state, 1)
    saver.submit(d, "p", state, 2)
    done = threading.Event()
    waiter = threading.Thread(target=lambda: (saver.wait(), done.set()))
    waiter.start()
    assert not done.wait(0.3)          # the first write is still held
    release.set()
    waiter.join(WAIT_S)
    assert not waiter.is_alive() and done.is_set()
    assert written == [0, 2]
    with open(tmp_path / "p_last.meta.json") as f:
        assert json.load(f)["epoch"] == 2

    def fail(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_io, "_write_last", fail)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        saver.submit(d, "q", state, 0)
        saver.wait()
    assert "async checkpoint save of q_last failed: OSError" in \
        out.getvalue()


def test_profile_trace_and_plot_metrics(tmp_path):
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    csv_path = tmp_path / "m.csv"
    csv_path.write_text("step,wall_s,train_loss,eval_loss,dice\n"
                        "0,1.0,0.5,0.6,0.3\n1,2.0,0.4,0.5,0.4\n")
    png = plot_metrics(str(csv_path))
    assert png == str(tmp_path / "m.png") and os.path.getsize(png) > 0
    assert plot_metrics(str(tmp_path / "missing.csv")) is None


def test_supervised_cli_with_async_profile_and_plot(tmp_path):
    """2 epochs with --resume --async-checkpoint --profile-dir
    --plot-curves, then a resumed third epoch from the `_last` written in
    the background."""
    ck, prof = str(tmp_path / "ck"), str(tmp_path / "prof")
    base = ["--synthetic", "--device", "cpu", "--variant", "b0",
            "--img-size", "32", "--synthetic-n", "4", "--batch-size", "2",
            "--resume", "--async-checkpoint", "--checkpoint-dir", ck]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        first = supervised.main(base + [
            "--epochs", "2", "--profile-dir", prof, "--plot-curves",
            "--metrics-csv", str(tmp_path / "m.csv")])
        second = supervised.main(base + ["--epochs", "3"])
    assert [r["epoch"] for r in first] == [0, 1]
    assert [r["epoch"] for r in second] == [2]
    assert "resumed from epoch 2" in out.getvalue()
    assert os.path.exists(os.path.join(prof, "trace.json"))
    assert os.path.exists(tmp_path / "m.png")
    with open(os.path.join(ck, "segformer_last.meta.json")) as f:
        assert json.load(f)["epoch"] == 2


def test_async_checkpoint_accepted_by_the_teacher_student_cli(tmp_path):
    """The gradient teacher-student loop writes both `_last` checkpoints in
    the background and waits for them before it returns."""
    from semisupervisedobjectdetection_torch.cli import teacher_student

    ck = str(tmp_path / "ck")
    with contextlib.redirect_stdout(io.StringIO()):
        teacher_student.main([
            "--synthetic", "--device", "cpu", "--variant", "b0",
            "--img-size", "32", "--synthetic-n", "4", "--batch-size", "2",
            "--epochs", "1", "--resume", "--async-checkpoint",
            "--checkpoint-dir", ck])
    for prefix in ("ts_teacher", "ts_student"):
        assert os.path.exists(os.path.join(ck, f"{prefix}_last.pt"))
