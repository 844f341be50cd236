"""The port's install self-test (`python -m
semisupervisedobjectdetection_torch`, `__main__.py`) on the CPU: with
`--device cpu --quick` every check passes and the exit code is 0; without
`--quick` the multi-device check, which needs the port's parallelism (not
ported), is refused with a message that names ROADMAP.md; a check that fails
is reported and gives exit code 1."""

import contextlib
import io

import pytest

from semisupervisedobjectdetection_torch import __main__ as selftest
from test_torch_segformer import one_torch_thread  # noqa: F401 (autouse)


def test_quick_self_test_passes_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = selftest.main(["--quick", "--device", "cpu", "--size", "32"])
    lines = out.getvalue().splitlines()
    assert rc == 0, out.getvalue()
    assert lines[-1] == "self-test: 5 passed, 0 failed"
    assert sum(ln.startswith("  ok    ") for ln in lines) == 5


def test_multi_device_check_is_refused_without_quick():
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        selftest.main(["--device", "cpu"])


def test_a_failed_check_gives_exit_code_1(monkeypatch):
    """No card and the default device: device discovery fails and is
    reported; nothing falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = selftest.main(["--quick"])
    assert rc == 1
    assert "FAIL  device discovery: RuntimeError: no CUDA device" in \
        out.getvalue()
