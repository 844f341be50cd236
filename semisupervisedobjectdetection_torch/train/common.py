"""Forward and gradient-accumulation helpers shared by the train steps, the
JAX package's `train/common.py` in PyTorch."""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from semisupervisedobjectdetection_torch.models import segformer


def forward_masks(model: segformer.SegFormer, images: torch.Tensor, *,
                  train_mode: bool = False
                  ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]],
                             None]:
    """Sigmoid masks at the image size, the per-stage CLS tokens and the new
    BatchNorm statistics (None: the running statistics are used and kept).

    This is the JAX `train_mode=False` forward (dropout and drop-path off,
    BatchNorm on its running statistics), differentiable when gradients are
    recorded. `train_mode=True` is not ported yet."""
    if train_mode:
        raise NotImplementedError(
            "train_mode=True (dropout, drop-path and BatchNorm batch "
            "statistics) is not ported yet; ROADMAP.md Queue 1 names it")
    masks, cls_list = segformer.forward_masks(model, images)
    return masks, cls_list, None


def grads_of(loss: torch.Tensor, params: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """d loss / d params as name -> tensor (zeros where a parameter does not
    reach the loss)."""
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


def accumulate_microbatches(micro_fn: Callable, params: Mapping,
                            init_stats, sums_zero: Mapping, xs):
    """Run ``micro_fn(stats, *x) -> (grads, new_stats, sums, out)`` over the
    leading (microbatch) axis of the tensors in ``xs``, in order, one
    microbatch's activations at a time.

    ``grads`` (name -> tensor, ``params``' names) and ``sums`` (name ->
    scalar, ``sums_zero``'s names) are summed; BatchNorm statistics thread
    through as sequential forwards would (``new_stats=None`` keeps the
    carried ones); ``out`` is stacked. Returns ``(summed_grads, final_stats,
    summed_sums, stacked_out)``, as the JAX `lax.scan` does."""
    names = list(params)
    gsum = [torch.zeros_like(params[n]) for n in names]
    stats, ssum, outs = init_stats, dict(sums_zero), []
    for x in zip(*xs):
        grads, new_stats, sums, out = micro_fn(stats, *x)
        stats = new_stats if new_stats is not None else stats
        torch._foreach_add_(gsum, [grads[n] for n in names])
        ssum = {k: ssum[k] + sums[k] for k in ssum}
        outs.append(out)
    return dict(zip(names, gsum)), stats, ssum, torch.stack(outs)
