"""Teacher-student helpers of the JAX package's `train/teacher_student.py`.
Only the mean-teacher EMA is ported so far; the gradient teacher-student
steps come with their own slice (ROADMAP.md Queue 1)."""

from __future__ import annotations

import torch

from semisupervisedobjectdetection_torch.train.state import TrainState


@torch.no_grad()
def ema_update(teacher_state: TrainState, student_state: TrainState,
               decay=0.999) -> TrainState:
    """Mean-teacher EMA, in place: t <- decay*t + (1-decay)*s on every
    parameter and every BatchNorm statistic, in float32 (`decay` a float or
    a float32 scalar tensor)."""
    names = list(teacher_state.params)
    stats = list(teacher_state.batch_stats)
    t = [teacher_state.params[n] for n in names] + \
        [teacher_state.batch_stats[n] for n in stats]
    s_params, s_stats = student_state.params, student_state.batch_stats
    s = [s_params[n] for n in names] + [s_stats[n] for n in stats]
    decay = torch.as_tensor(decay, dtype=torch.float32, device=t[0].device)
    torch._foreach_mul_(t, decay)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - decay))
    return teacher_state
