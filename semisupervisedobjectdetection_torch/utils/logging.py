"""Structured metrics: an append-only CSV of one row per step or epoch,
echoed to stdout, the JAX package's `utils/logging.py::MetricLogger` with
the same columns (`step`, `wall_s`, then the metrics in the order of the
first row)."""

from __future__ import annotations

import csv
import os
import time
from typing import Optional


class MetricLogger:
    """Append-only CSV metric log, one row per (step/epoch, metrics...)."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._writer = None
        self._file = None
        self._fields = None
        self.start = time.time()

    def log(self, step: int, **metrics: float) -> None:
        row = {"step": step, "wall_s": round(time.time() - self.start, 2),
               **{k: (float(v) if hasattr(v, "item") or
                      isinstance(v, (int, float)) else v)
                  for k, v in metrics.items()}}
        if self.path:
            if self._writer is None:
                os.makedirs(os.path.dirname(self.path) or ".",
                            exist_ok=True)
                self._file = open(self.path, "w", newline="")
                self._fields = list(row.keys())
                self._writer = csv.DictWriter(self._file,
                                              fieldnames=self._fields)
                self._writer.writeheader()
            self._writer.writerow({k: row.get(k, "") for k in self._fields})
            self._file.flush()
        if self.echo:
            parts = " ".join(f"{k}={v:.6g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in row.items())
            print(parts, flush=True)

    def close(self) -> None:
        if self._file:
            self._file.close()
