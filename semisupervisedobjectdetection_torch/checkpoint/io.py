"""Full train-state checkpoints, the JAX package's `checkpoint/orbax_io.py`
in PyTorch: `torch.save` of one file per state instead of an Orbax
directory.

A checkpoint holds the whole `TrainState`: the model's parameters and
BatchNorm statistics (its `state_dict`), Adam's moments and step count, and
the schedule's epoch, so a resumed run continues the optimisation instead
of restarting it (the reference saves parameters only). The `_last`
checkpoint also has a JSON sidecar with the epoch it ended and the best
eval loss so far, which `--resume` reads. Files are written to a temporary
name and renamed, so a crash mid-write leaves the previous file whole.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from semisupervisedobjectdetection_torch.train.state import TrainState

SUFFIX = ".pt"


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_state(path: str, state: TrainState) -> None:
    """Write (parameters and BatchNorm statistics, Adam moments and count,
    epoch) of `state` to the file `path`."""
    payload = {
        "model": {k: _host(v) for k, v in state.model.state_dict().items()},
        "mu": {k: _host(v) for k, v in state.mu.items()},
        "nu": {k: _host(v) for k, v in state.nu.items()},
        "count": _host(state.count),
        "epoch": _host(state.epoch),
    }
    _atomic_save(payload, os.path.abspath(path))


@torch.no_grad()
def restore_state(path: str, template: TrainState) -> TrainState:
    """Load the file `path` into `template` (the same model and trainable
    parameters), in place, and return it: the `--resume` semantics, with
    Adam's state and the epoch (which drives the learning-rate decay).
    Raises when the file holds another model. (The JAX package's warm start
    from a checkpoint, `--pretrain-weight`, is not ported yet.)"""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    template.model.load_state_dict(saved["model"], strict=True)
    if set(saved["mu"]) != set(template.mu):
        raise ValueError(f"{path}: Adam's state covers other parameters")
    for n in template.mu:
        template.mu[n].copy_(saved["mu"][n])
        template.nu[n].copy_(saved["nu"][n])
    template.count.copy_(saved["count"])
    template.epoch.copy_(saved["epoch"])
    return template


def best_checkpoint_name(prefix: str, epoch: int, train_loss: float,
                         eval_loss: float, fps: float) -> str:
    """Metric-bearing checkpoint names, like the reference's
    'segFormer_epoch_{e}_train_{t:.3f}_eval_{v:.3f}_fps_{f:.2f}'
    (`segFormer_main.py:85-86`)."""
    return (f"{prefix}_epoch_{epoch}_train_{train_loss:.3f}"
            f"_eval_{eval_loss:.3f}_fps_{fps:.2f}")


class BestCheckpointer:
    """Keep the best-eval-loss checkpoint (ref `segFormer_main.py:79-86`)."""

    def __init__(self, directory: str, prefix: str = "segformer"):
        self.directory = directory
        self.prefix = prefix
        self.best_loss = float(np.inf)
        self.best_path: Optional[str] = None

    def maybe_save(self, state: TrainState, epoch: int, train_loss: float,
                   eval_loss: float, fps: float = 0.0) -> Optional[str]:
        # NaN-robust: `not (x < best)` rejects NaN, where `x >= best` would
        # save a NaN epoch as the best and poison every later comparison
        if not (eval_loss < self.best_loss):
            return None
        self.best_loss = eval_loss
        name = best_checkpoint_name(self.prefix, epoch, train_loss,
                                    eval_loss, fps)
        path = os.path.join(self.directory, name + SUFFIX)
        save_state(path, state)
        self.best_path = path
        return path


def _last_paths(directory: str, prefix: str):
    base = os.path.join(os.path.abspath(directory), f"{prefix}_last")
    return base + SUFFIX, base + ".meta.json"


def save_last(directory: str, prefix: str, state: TrainState, epoch: int,
              best_loss: float = float("inf")) -> str:
    """Overwrite `{directory}/{prefix}_last.pt` with the full train state
    and its sidecar `{prefix}_last.meta.json` with (epoch, best_loss): the
    crash and preemption resume point."""
    path, meta = _last_paths(directory, prefix)
    save_state(path, state)
    tmp = meta + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": int(epoch), "best_loss": float(best_loss)}, f)
    os.replace(tmp, meta)
    return path


def has_last(directory: str, prefix: str) -> bool:
    return os.path.isfile(_last_paths(directory, prefix)[0])


def load_last(directory: str, prefix: str, template: TrainState):
    """Restore `{prefix}_last` into `template` if it exists: returns
    (state, next_epoch, best_loss) or None. `next_epoch` is the epoch to
    start at (the saved one + 1); `best_loss` re-arms the best-checkpoint
    gate, so a resumed run cannot overwrite a better earlier best."""
    if not has_last(directory, prefix):
        return None
    path, meta_path = _last_paths(directory, prefix)
    state = restore_state(path, template)
    meta = {"epoch": -1, "best_loss": float("inf")}
    try:
        with open(meta_path) as f:
            meta.update(json.load(f))
    except (OSError, ValueError):
        pass
    return state, int(meta["epoch"]) + 1, float(meta["best_loss"])
