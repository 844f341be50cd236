"""Forward and gradient-accumulation helpers shared by the train steps, the
JAX package's `train/common.py` in PyTorch."""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from semisupervisedobjectdetection_torch.models import segformer


def forward_masks(model: segformer.SegFormer, images: torch.Tensor, *,
                  train_mode: bool = False,
                  generator: Optional[torch.Generator] = None,
                  stats: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]],
                             Optional[Dict[str, torch.Tensor]]]:
    """Sigmoid masks at the image size, the per-stage CLS tokens and the new
    BatchNorm statistics (None in eval mode: the running statistics are used
    and kept). Differentiable when gradients are recorded.

    `train_mode=False` is the eval forward: no dropout or drop-path,
    BatchNorm on its running statistics. `train_mode=True` draws the
    drop-path and classifier-dropout masks from `generator` (on the images'
    device) and normalises with the batch statistics; the new running
    statistics are `0.9 * carried + 0.1 * batch` (biased variance), as flax
    counts them, where `carried` is `stats` (name -> tensor, the model's
    BatchNorm buffer names) or, when None, the model's own buffers, which
    are left as they are."""
    if not train_mode:
        masks, cls_list = segformer.forward_masks(model, images)
        return masks, cls_list, None
    draws = segformer.TrainDraws.draw(model.cfg, images.shape[0], generator,
                                      images.device)
    masks, cls_list, (mean, var) = segformer.forward_masks(model, images,
                                                           draws)
    prefix = "decode_head.batch_norm."
    bn = model.decode_head.batch_norm
    carried = {prefix + "running_mean": bn.running_mean,
               prefix + "running_var": bn.running_var}
    if stats is not None:
        carried = {n: stats[n] for n in carried}
    m = segformer.BN_MOMENTUM
    new_stats = {n: m * carried[n] + (1.0 - m) * batch
                 for n, batch in zip(carried, (mean, var))}
    return masks, cls_list, new_stats


def grads_of(loss: torch.Tensor, params: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """d loss / d params as name -> tensor (zeros where a parameter does not
    reach the loss, and everywhere when the loss is piecewise constant, as
    the binarised dice is)."""
    if not loss.requires_grad:
        return {n: torch.zeros_like(p) for n, p in params.items()}
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
    carried ones); ``out`` (a tensor or a tuple of tensors) is stacked.
    Returns ``(summed_grads, final_stats, summed_sums, stacked_out)``, as
    the JAX `lax.scan` does."""
    names = list(params)
    gsum = [torch.zeros_like(params[n]) for n in names]
    stats, ssum, outs = init_stats, dict(sums_zero), []
    for x in zip(*xs):
        grads, new_stats, sums, out = micro_fn(stats, *x)
        stats = new_stats if new_stats is not None else stats
        torch._foreach_add_(gsum, [grads[n] for n in names])
        ssum = {k: ssum[k] + sums[k] for k in ssum}
        outs.append(out)
    stacked = (tuple(torch.stack(o) for o in zip(*outs))
               if isinstance(outs[0], tuple) else torch.stack(outs))
    return dict(zip(names, gsum)), stats, ssum, stacked
