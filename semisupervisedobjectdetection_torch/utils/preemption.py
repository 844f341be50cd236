"""Graceful-stop handling for the port's long-running entry points.

A serving host is stopped with SIGTERM (spot preemption, maintenance) or
Ctrl-C (SIGINT). The first signal flips a cooperative stop flag that the
serving loop polls; the server then drains: the listener closes, queued
requests are answered, and the process exits 0. A second signal restores
the previous disposition and re-raises itself, the escape hatch if the
drain wedges.

The flag lives at module level so loops can poll `stop_requested()` with
no plumbing, and tests can simulate a stop with `request_stop()` without
installing a handler. Signal handlers can only be installed from the main
thread; `install()` returns False and installs nothing elsewhere.

CPython runs signal handlers between bytecodes, so a signal that lands
inside a long native call is seen when that call returns.

(The port's own copy of the JAX package's stdlib-only `utils/preemption.py`.)
"""

from __future__ import annotations

import os
import signal
import threading

_STOP = threading.Event()
_INFO = {"signal": None, "signals_seen": 0}
_PREV: dict = {}


def _handler(signum, frame):
    # Escalation counts REAL signals only: a programmatic request_stop()
    # must not make the first actual SIGTERM take the hard-kill path and
    # skip the drain.
    _INFO["signals_seen"] += 1
    if _INFO["signals_seen"] > 1:
        # Second signal: restore the previous disposition and re-deliver,
        # so a wedged drain can still be killed. A SIG_IGN
        # previous disposition falls back to SIG_DFL — re-delivering an
        # ignored signal would make the escape hatch a permanent no-op.
        prev = _PREV.get(signum, signal.SIG_DFL)
        if prev in (signal.SIG_IGN, None):
            prev = signal.SIG_DFL
        try:
            signal.signal(signum, prev)
        except (TypeError, ValueError):
            signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
        return
    _INFO["signal"] = signal.Signals(signum).name
    _STOP.set()
    # os.write is async-signal-safe; print() into the buffered stdout the
    # interrupted main thread may be mid-write in can raise
    # "RuntimeError: reentrant call" and crash the run before the save.
    os.write(1, (f"\n{_INFO['signal']} received: finishing the work in "
                 "flight, then exiting cleanly — signal again to kill "
                 "immediately\n").encode())


def install(signals=(signal.SIGTERM, signal.SIGINT)) -> bool:
    """Install the graceful-stop handler (CLI `__main__` blocks only —
    in-process callers like tests keep their host's signal handling).
    Returns False (and installs nothing) off the main thread."""
    try:
        for s in signals:
            if s not in _PREV:
                _PREV[s] = signal.signal(s, _handler)
        return True
    except ValueError:  # not the main thread
        return False


def uninstall() -> None:
    """Restore the pre-install handlers and clear the stop flag (tests)."""
    while _PREV:
        s, prev = _PREV.popitem()
        try:
            signal.signal(s, prev)
        except (TypeError, ValueError):
            pass
    reset()


def reset() -> None:
    """Clear the stop flag (tests / multi-run callers)."""
    _STOP.clear()
    _INFO["signal"] = None
    _INFO["signals_seen"] = 0


def stop_requested() -> bool:
    """True once a stop signal (or `request_stop`) arrived."""
    return _STOP.is_set()


def request_stop(name: str = "request") -> None:
    """Programmatic stop — same effect as the first signal (tests, or an
    embedding application draining a server)."""
    _INFO["signal"] = name
    _STOP.set()


def signal_name() -> str:
    """Name of the signal that requested the stop ('stop' if none)."""
    return _INFO["signal"] or "stop"
