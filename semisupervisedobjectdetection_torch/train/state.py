"""Train state and optimizer of the JAX package's `train/state.py`, in
PyTorch.

The update is the optax chain of the JAX package, in its order:
gradient-value clip -> g + weight_decay*p (torch Adam's L2) -> Adam with
bias correction -> times -lr, where lr = base_lr * lr_decay**epoch. A step
whose loss is not finite changes nothing: the params, the moments and Adam's
count keep their values, chosen on the device with `torch.where` so no
step waits on the host. Parameters masked out by `trainable_mask` take no
update and carry no moments, and are marked `requires_grad=False`, so
autograd builds no gradient for them; `trainable_mask_from` and
`frozen_stage_predicate` build the masks of frozen encoder stages and of
the reference's untrained prompt/CLS tokens.

Unlike the JAX state, this one is updated in place: it holds the model
whose float32 parameters it trains, and `apply_gradients` writes them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

from semisupervisedobjectdetection_torch.core.config import TrainConfig

_STATS = ("running_mean", "running_var")


@dataclasses.dataclass
class TrainState:
    """One model's params, BatchNorm statistics and Adam state."""

    model: nn.Module
    tc: TrainConfig
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor                  # int32 scalar, Adam's step count
    epoch: torch.Tensor                  # float32 scalar, drives lr decay
    base_lr: torch.Tensor
    lr_decay: torch.Tensor
    trainable_mask: Optional[Dict[str, bool]] = None

    @classmethod
    def create(cls, model: nn.Module, tc: TrainConfig,
               lr: Optional[float] = None,
               trainable_mask: Optional[Mapping[str, bool]] = None
               ) -> "TrainState":
        """A fresh state for `model` (its parameters float32, on their
        device): zero moments for every trainable parameter. A parameter
        that `trainable_mask` masks out gets `requires_grad=False`: no
        gradient is built for it, while gradients still flow through it to
        the trainable parameters below (a frozen encoder stage passes them
        on to the patch embeddings under it)."""
        params = dict(model.named_parameters())
        mask = dict(trainable_mask) if trainable_mask is not None else None
        if mask is not None and set(mask) != set(params):
            raise ValueError("trainable_mask must name every parameter")
        dev = next(iter(params.values())).device
        trained = [n for n in params if mask is None or mask[n]]
        for n, p in params.items():
            p.requires_grad_(mask is None or bool(mask[n]))

        def scalar(x, dtype=torch.float32):
            return torch.tensor(x, dtype=dtype, device=dev)

        return cls(model=model, tc=tc,
                   mu={n: torch.zeros_like(params[n]) for n in trained},
                   nu={n: torch.zeros_like(params[n]) for n in trained},
                   count=scalar(0, torch.int32), epoch=scalar(0.0),
                   base_lr=scalar(tc.lr if lr is None else lr),
                   lr_decay=scalar(tc.lr_decay), trainable_mask=mask)

    @property
    def params(self) -> Dict[str, nn.Parameter]:
        return dict(self.model.named_parameters())

    @property
    def trainable_params(self) -> Dict[str, nn.Parameter]:
        """The parameters the optimizer updates (those with moments)."""
        params = self.params
        return {n: params[n] for n in self.mu}

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The BatchNorm running statistics (the JAX `batch_stats`)."""
        return {n: b for n, b in self.model.named_buffers()
                if n.endswith(_STATS)}

    @torch.no_grad()
    def set_batch_stats(self, stats: Optional[Mapping[str, torch.Tensor]]
                        ) -> None:
        """Copy new BatchNorm running statistics (name -> tensor) into the
        model; None keeps them."""
        if stats is not None:
            live = self.batch_stats
            for n, t in stats.items():
                live[n].copy_(t)

    @property
    def lr(self) -> torch.Tensor:
        return self.base_lr * torch.pow(self.lr_decay, self.epoch)

    @torch.no_grad()
    def apply_gradients(self, grads: Mapping[str, torch.Tensor],
                        loss: torch.Tensor,
                        enable: Optional[torch.Tensor] = None
                        ) -> "TrainState":
        """One optimizer step from `grads` (name -> gradient), skipped
        entirely when `loss` is not finite or when `enable` (a bool tensor
        on the state's device, the teacher's update gate) is False."""
        tc = self.tc
        params = self.params
        names = list(self.mu)
        ps = [params[n] for n in names]
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        g = torch._foreach_clamp_min([grads[n] for n in names],
                                     -tc.grad_clip_value)
        torch._foreach_clamp_max_(g, tc.grad_clip_value)
        torch._foreach_add_(g, torch._foreach_mul(ps, tc.weight_decay))
        count = self.count + 1
        mu_new = torch._foreach_mul(g, 1.0 - tc.adam_b1)
        torch._foreach_add_(mu_new, torch._foreach_mul(mu, tc.adam_b1))
        nu_new = torch._foreach_mul(torch._foreach_mul(g, g),
                                    1.0 - tc.adam_b2)
        torch._foreach_add_(nu_new, torch._foreach_mul(nu, tc.adam_b2))
        del g
        bc1 = 1.0 - torch.pow(tc.adam_b1, count)
        bc2 = 1.0 - torch.pow(tc.adam_b2, count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu_new, bc2))
        torch._foreach_add_(denom, tc.adam_eps)
        update = torch._foreach_div(torch._foreach_div(mu_new, bc1), denom)
        del denom
        torch._foreach_mul_(update, -1.0)
        torch._foreach_mul_(update, self.lr)
        ok = torch.isfinite(loss)
        if enable is not None:
            ok = ok & enable
        for p, m, v, u, m1, v1 in zip(ps, mu, nu, update, mu_new, nu_new):
            p.copy_(torch.where(ok, p + u, p))
            m.copy_(torch.where(ok, m1, m))
            v.copy_(torch.where(ok, v1, v))
        self.count = torch.where(ok, count, self.count)
        return self

    def scheduler_step(self) -> "TrainState":
        """The per-epoch exponential learning-rate step."""
        self.epoch = self.epoch + 1.0
        return self


def trainable_mask_from(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                        frozen_predicate: Callable[[str], bool]
                        ) -> Dict[str, bool]:
    """name -> trainable, False where `frozen_predicate(name)` is True, over
    the parameters of a model (or a name -> tensor mapping), for
    `TrainState.create(trainable_mask=...)`."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {n: not frozen_predicate(n) for n in params}


_BLOCK = "segformer.encoder.block."
_PROMPT = "segformer.encoder.prompt_tokens."
_CLS = "segformer.encoder.cls_token."


def frozen_stage_predicate(frozen_stages, freeze_prompts: bool = False,
                           freeze_cls: bool = False
                           ) -> Callable[[str], bool]:
    """A predicate for `trainable_mask_from` that freezes the layers of the
    encoder stages in `frozen_stages` (`segformer.encoder.block.<i>.*`, the
    reference's `frozen_encoder(layers=[...])`). As in the reference, only
    `encoder.block[i]` freezes: the stage's patch embedding and final
    LayerNorm stay trainable. `freeze_prompts` / `freeze_cls` also freeze
    the prompt tokens (`segformer.encoder.prompt_tokens.<i>`) / CLS tokens
    (`segformer.encoder.cls_token.<i>`), the reference's quirk of tokens
    the optimizer never sees."""
    frozen = {int(i) for i in frozen_stages}

    def predicate(name: str) -> bool:
        if name.startswith(_PROMPT):
            return freeze_prompts
        if name.startswith(_CLS):
            return freeze_cls
        if name.startswith(_BLOCK):
            return int(name[len(_BLOCK):].split(".", 1)[0]) in frozen
        return False

    return predicate
