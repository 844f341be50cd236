"""Loss-curve figures for `--plot-curves`: render a MetricLogger CSV to a
PNG. The port's own copy of the JAX package's `utils/plot_metrics.py`
(which imports no JAX), so the port depends on nothing of that package.

It replaces the reference's inline matplotlib loss-curve dump
(`main_segformer/segFormer_main.py:88-98`) by a picture drawn from the CSV
the training CLIs already write (`utils/logging.MetricLogger`), after the
run. matplotlib is imported only here, when the figure is drawn; where it
is missing the caller gets a message and no figure, never a failed run.
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence

#: CSV columns drawn on the loss axis when present (reference plots train
#: and eval loss; the semi loops add teacher curves).
LOSS_COLUMNS = ("train_loss", "eval_loss", "teacher_train", "teacher_eval",
                "pseudo_loss", "recon_loss")
#: Quality metrics drawn on a twin right-hand axis when present.
METRIC_COLUMNS = ("dice", "miou", "miou_per_image")


def _read_csv(csv_path: str):
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    return rows


def _series(rows, col: str) -> List[float]:
    out = []
    for r in rows:
        v = r.get(col, "")
        try:
            out.append(float(v))
        except (TypeError, ValueError):
            out.append(float("nan"))
    return out


def plot_metrics(csv_path: str, out_png: Optional[str] = None,
                 title: Optional[str] = None,
                 loss_columns: Sequence[str] = LOSS_COLUMNS,
                 metric_columns: Sequence[str] = METRIC_COLUMNS,
                 ) -> Optional[str]:
    """Render train/eval curves from a MetricLogger CSV to a PNG.

    Returns the written path, or None when there was nothing to plot
    (missing/empty CSV or matplotlib unavailable — both reported, not
    raised, so --plot-curves can never fail a finished training run).
    """
    if not csv_path or not os.path.exists(csv_path):
        print(f"plot-curves: no CSV at {csv_path!r}, skipping")
        return None
    rows = _read_csv(csv_path)
    if not rows:
        print(f"plot-curves: {csv_path} is empty, skipping")
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception as e:  # pragma: no cover - env without matplotlib
        print(f"plot-curves: matplotlib unavailable ({e}), skipping")
        return None

    steps = _series(rows, "step")
    have = set(rows[0].keys())
    losses = [c for c in loss_columns if c in have]
    metrics = [c for c in metric_columns if c in have]

    fig, ax = plt.subplots(figsize=(8, 5))
    for col in losses:
        ax.plot(steps, _series(rows, col), label=col)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.grid(True, alpha=0.3)
    handles, labels = ax.get_legend_handles_labels()
    if metrics:
        ax2 = ax.twinx()
        for col in metrics:
            ax2.plot(steps, _series(rows, col), linestyle="--", label=col)
        ax2.set_ylabel("metric")
        h2, l2 = ax2.get_legend_handles_labels()
        handles += h2
        labels += l2
    if handles:
        ax.legend(handles, labels, loc="best", fontsize=8)
    ax.set_title(title or os.path.basename(csv_path))

    out_png = out_png or os.path.splitext(csv_path)[0] + ".png"
    os.makedirs(os.path.dirname(out_png) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    print(f"loss curves written: {out_png}")
    return out_png
