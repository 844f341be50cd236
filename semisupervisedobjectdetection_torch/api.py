"""`SegFormerModel`: the JAX package's `api.py` on PyTorch, the reference's
`models/SegFormerModel.py` surface over the port's steps.

The class holds the float32 model on `device` (masters cast at use) and,
from the first training use on, its `TrainState` (Adam's state, the
trainable mask); it serves from a copy of the model:

- training: `train_one_epoch` (one supervised step, the name of the
  reference's method), `eval_one_epoch`, the autoencoder's
  `train_one_epoch_without_mask` and `eval_one_epoch_without_mask`,
  `scheduler_step`, and the structural changes `frozen_encoder`,
  `unfroze_encoder`, `add_prompt_token` and `add_cls_token`, which rebuild
  the state with fresh Adam moments and keep the old weights wherever the
  name and shape match (new tokens come from the seeded init, as in the
  JAX package);
- serving: `predict` runs a bfloat16 (or float32) copy of the state's model
  whose dense and conv weights are cast once; SR-attention runs the
  forward kernel of the copy's dtype, as training does, and chip_smoke's
  serve gate holds the bfloat16 masks to the float32 model (PERF.md). The
  copy is built at the first `predict` after the weights changed, so
  serving casts no weight per forward, and a model that only serves holds
  no Adam moments;
- checkpoints: `save`, `load` (a warm start, or the full state with
  `full_state=True`), `resume` (the `_last` checkpoint of a training run),
  `load_hf` and `load_state_dict`; `show_mask` writes a PNG overlay in
  place of the reference's visdom panel.

Every write to the weights goes through these methods, which mark the
serving copy stale; code that writes into `state` itself must not expect
`predict` to see it.

With `TrainConfig.reference_quirks` (the default) the prompt and CLS tokens
are frozen, the reference's untrained-token quirk, and `train_one_epoch`
runs the forward in eval mode; `reference_quirks=False` trains the tokens
and runs it in train mode, its drop-path and dropout masks drawn from
`generator`.

The autoencoder's methods (`train_one_epoch_without_mask`,
`eval_one_epoch_without_mask`, and `predict(use_loss="mse")`) serve a
`num_labels=3` model: its train step always runs in train mode, as the
reference's does.

`predict(output_cls_token=True)` also returns sigmoid of the last stage's
carried CLS token, the domain token the few-shot loop trains
(`cli/fewshot.py`); `train_one_epoch(output_cls_token=True)` returns None in
its place, as the JAX package does.

Not ported yet, each raising NotImplementedError that names ROADMAP.md:
the "bce" loss, the quantized serving snapshot
(`quantize`, `dequantize`, `save_quantized`, `load_quantized`),
`export_serving` and `export_hf`.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from semisupervisedobjectdetection_torch import losses
from semisupervisedobjectdetection_torch.checkpoint.convert import (
    load_torch_checkpoint,
)
from semisupervisedobjectdetection_torch.checkpoint.io import (
    load_last,
    merge_restore,
    restore_state,
    restore_weights,
    save_state,
)
from semisupervisedobjectdetection_torch.core.config import (
    MiTConfig,
    TrainConfig,
    mit_b5,
)
from semisupervisedobjectdetection_torch.models.segformer import (
    SegFormer,
    cast_to_compute_dtype,
    forward_logits,
    forward_masks,
    init_weights,
)
from semisupervisedobjectdetection_torch.train import autoencoder
from semisupervisedobjectdetection_torch.train import state as state_lib
from semisupervisedobjectdetection_torch.train import supervised
from semisupervisedobjectdetection_torch.train.fewshot import cls_activation
from semisupervisedobjectdetection_torch.train.state import TrainState
from semisupervisedobjectdetection_torch.utils.device import resolve_device


def _to_nhwc(img) -> np.ndarray:
    """Accept NHWC or NCHW float batches."""
    img = np.asarray(img, np.float32)
    if img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
        img = img.transpose(0, 2, 3, 1)
    return img


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to the PyTorch package yet; ROADMAP.md "
        "Queue 1 lists what waits")


class SegFormerModel:
    """SegFormer to train and serve on `device` (the CUDA card unless
    device="cpu").

    Weights are drawn from a `torch.Generator` seeded with `seed` on the CPU
    (so one seed gives the same weights on every device), then replaced by
    `hf_weights` and then `pretrain_weight` (a port checkpoint, loaded as a
    warm start) when those are given. `grad_accum` splits each
    `train_one_epoch` batch into that many microbatches before the one
    update.
    """

    def __init__(self, pretrain_weight: Optional[str] = None,
                 lr: Optional[float] = None,
                 weight_decay: Optional[float] = None,
                 scheduler: Optional[float] = None,
                 num_labels: int = 1,
                 config: Optional[MiTConfig] = None,
                 train_config: Optional[TrainConfig] = None,
                 hf_weights: Optional[str] = None,
                 seed: int = 0,
                 grad_accum: int = 1,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        tc = train_config or TrainConfig()
        if lr is not None:
            tc = tc.replace(lr=lr)
        if weight_decay is not None:
            tc = tc.replace(weight_decay=weight_decay)
        if scheduler is not None:
            tc = tc.replace(lr_decay=scheduler)
        self.tc = tc
        self.cfg = (config or mit_b5()).replace(num_labels=num_labels)
        self.num_labels = num_labels
        self.seed = seed
        self.grad_accum = max(1, int(grad_accum))
        # the train-mode drop-path and dropout draws (the JAX `_rng`); the
        # training CLIs reseed it per epoch
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._frozen_stages: List[int] = []
        self._net: Optional[SegFormer] = None
        self._state: Optional[TrainState] = None
        self._served: Optional[SegFormer] = None
        self._init_state()
        if hf_weights:
            self.load_hf(hf_weights)
        if pretrain_weight:
            self.load(pretrain_weight)

    # ------------------------------------------------------------------ init
    def _trainable_mask(self, model: SegFormer) -> Optional[Dict[str, bool]]:
        quirks = self.tc.reference_quirks
        predicate = state_lib.frozen_stage_predicate(
            self._frozen_stages, freeze_prompts=quirks, freeze_cls=quirks)
        mask = state_lib.trainable_mask_from(model, predicate)
        return None if all(mask.values()) else mask

    def _init_state(self, keep: bool = False) -> None:
        """A fresh float32 model for `self.cfg`: seeded weights on the CPU,
        with the current model's weights and BatchNorm statistics over them
        wherever the name and shape match when `keep`; the old model, its
        train state and serving copy are let go before the new one moves to
        the card, so two models never sit there at once. The train state
        is made anew at its first use (`state`), its moments at zero."""
        model = init_weights(SegFormer(self.cfg),
                             torch.Generator().manual_seed(self.seed))
        if keep and self._net is not None:
            old = {n: t.detach().cpu()
                   for n, t in self._net.state_dict().items()}
            model.load_state_dict(merge_restore(model.state_dict(), old),
                                  strict=True)
            del old
        self._net = self._state = self._served = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self._net = model.to(self.device)

    @property
    def state(self) -> TrainState:
        """The float32 model's train state: Adam's moments of the trainable
        parameters (the frozen stages and, under the reference's quirks,
        the prompt and CLS tokens get none), made at the first use."""
        if self._state is None:
            self._state = TrainState.create(
                self._net, self.tc,
                trainable_mask=self._trainable_mask(self._net))
        return self._state

    def _changed(self) -> None:
        """The weights changed: the serving copy is stale."""
        self._served = None

    # ------------------------------------------------- structural changes
    def frozen_encoder(self, layers_num: Optional[int] = None,
                       layers: Optional[Sequence[int]] = None) -> None:
        """Freeze encoder stages (ref `SegFormerModel.py:46-63`):
        `layers_num=k` the first k stages, `layers=[...]` the listed ones
        (their layers only; patch embeddings and final norms train)."""
        if layers is not None:
            self._frozen_stages = [int(i) for i in layers]
        else:
            k = layers_num if layers_num is not None else self.cfg.num_stages
            self._frozen_stages = list(range(k))
        self._init_state(keep=True)

    def unfroze_encoder(self) -> None:
        self._frozen_stages = []
        self._init_state(keep=True)

    def add_prompt_token(self, token_num_per_block=(10, 10, 10, 10),
                         isSamePerLayer: bool = True) -> None:
        """Learnable prompt tokens per stage (ref `:69-91`), one set shared
        by a stage's layers or, with `isSamePerLayer=False`, one per
        layer."""
        self.cfg = self.cfg.replace(
            prompt_tokens=tuple(token_num_per_block),
            prompt_per_layer=not isSamePerLayer)
        self._init_state(keep=True)

    def add_cls_token(self, token_num_per_block=(1, 1, 1, 1)) -> None:
        """Per-stage domain CLS tokens (ref `:93-101`)."""
        self.cfg = self.cfg.replace(cls_tokens=tuple(token_num_per_block))
        self._init_state(keep=True)

    # ----------------------------------------------------------- serving
    @property
    def model(self) -> SegFormer:
        """The serving copy of the float32 model: dense and conv weights in
        the compute dtype, SR-attention on the forward kernel of that dtype.
        Built when first asked for after the weights changed."""
        if self._served is None:
            # ordinary tensors, whether `predict`'s inference mode is on
            with torch.inference_mode(False), torch.no_grad():
                served = cast_to_compute_dtype(
                    copy.deepcopy(self._net)).eval()
            served.requires_grad_(False)
            self._served = served
        return self._served

    def _images(self, img) -> torch.Tensor:
        """A float NHWC batch on the device, from a tensor (taken as NHWC)
        or an NHWC/NCHW array."""
        if isinstance(img, torch.Tensor):
            return img.to(self.device, torch.float32)
        return torch.from_numpy(_to_nhwc(img)).to(self.device)

    def _targets(self, mask) -> torch.Tensor:
        if isinstance(mask, torch.Tensor):
            return mask.to(self.device, torch.float32)
        return torch.from_numpy(np.asarray(mask, np.float32)).to(self.device)

    @torch.inference_mode()
    def predict(self, img, mask=None, use_loss: str = "dice",
                output_cls_token: bool = False):
        """Sigmoid masks (B, H, W) float32 of an NHWC or NCHW float batch
        (num_labels as a last axis when it is above 1); with a target
        `mask`, (loss, masks), the loss "dice" or "dice_argmax" (ref
        `:103-139`). `use_loss="mse"` (the autoencoder's) returns (loss,
        masks) without a target: the reference's MSE of the images against
        the raw logits upsampled to their size, divisor B*3 (ref `:133`).

        `output_cls_token=True` adds a third value where a loss is
        returned: sigmoid of the last stage's carried CLS token, (B, 1, C)
        float32 (the reference forward's, `modeling_segformer.py:848-850`),
        from the same forward, or None for a model without CLS tokens."""
        if use_loss == "bce":
            _not_ported(f"predict(use_loss={use_loss!r})")
        images = self._images(img)
        if use_loss == "mse" or (output_cls_token and self.cfg.use_cls):
            # one forward gives the raw logits and the tokens; the masks
            # are their sigmoid
            logits, cls_list = forward_logits(self.model, images)
            masks = torch.sigmoid(logits)
            if masks.shape[-1] == 1:
                masks = masks[..., 0]
            token = cls_activation(cls_list) if self.cfg.use_cls else None
        else:
            masks, _ = forward_masks(self.model, images)
            token = None
        if mask is None and use_loss != "mse":
            return masks.cpu().numpy()
        if use_loss == "mse":
            loss = losses.mse_loss(images, logits,
                                   divisor=images.shape[0] * 3)
        else:
            loss = losses.segmentation_loss(masks, self._targets(mask),
                                            use_loss)
        if output_cls_token:
            return loss, masks.cpu().numpy(), \
                (None if token is None else token.cpu().numpy())
        return loss, masks.cpu().numpy()

    # ---------------------------------------------------------- training
    def train_one_epoch(self, imgs, masks, use_loss: str = "dice",
                        output_cls_token: bool = False, lazy: bool = False):
        """One supervised step on a batch (ref `:146-156`; the reference's
        name, which also steps per batch): (loss, predicted masks). `lazy`
        keeps the masks on the device (no host copy per step; the loops
        read their metrics once per epoch). `output_cls_token=True` returns
        (loss, masks, None), as the JAX package does: the few-shot loop,
        which needs the token, has its own step (`train/fewshot.py`)."""
        _, loss, pred = supervised.train_step(
            self.state, self._images(imgs), self._targets(masks),
            loss_type=use_loss, train_mode=not self.tc.reference_quirks,
            accum=self.grad_accum, generator=self.generator)
        self._changed()
        pred = pred if lazy else pred.cpu().numpy()
        if output_cls_token:
            return loss, pred, None
        return loss, pred

    def eval_one_epoch(self, imgs, masks, lazy: bool = False):
        """The binarised-dice eval step (ref `:141-144`): (loss, predicted
        masks), the masks left on the device with `lazy`."""
        loss, pred = supervised.eval_step(self.state, self._images(imgs),
                                          self._targets(masks))
        return loss, (pred if lazy else pred.cpu().numpy())

    def train_one_epoch_without_mask(self, imgs, lazy: bool = False):
        """One autoencoder step, reconstructing the input in train mode
        (ref `:198-219`): (loss, (B, H, W, 3) reconstruction), left on the
        device with `lazy`."""
        _, loss, recon = autoencoder.ae_train_step(
            self.state, self._images(imgs), self.generator,
            accum=self.grad_accum)
        self._changed()
        return loss, (recon if lazy else recon.cpu().numpy())

    def eval_one_epoch_without_mask(self, imgs, lazy: bool = False):
        """The autoencoder's eval step (ref `:177-196`): (MSE loss,
        reconstruction) in eval mode."""
        loss, recon = autoencoder.ae_eval_step(self.state,
                                               self._images(imgs))
        return loss, (recon if lazy else recon.cpu().numpy())

    def scheduler_step(self) -> None:
        """The per-epoch ExponentialLR step (ref `:164-165`)."""
        self.state.scheduler_step()

    def show_mask(self, out_path: str, img, mask=None) -> str:
        """Write `img` (HWC or CHW, floats in [0, 1]) with its red channel
        replaced by `mask` as a PNG, in place of the reference's visdom
        overlay (ref `:167-175`)."""
        from PIL import Image

        if isinstance(img, torch.Tensor):
            img = img.detach().cpu().numpy()
        if isinstance(mask, torch.Tensor):
            mask = mask.detach().cpu().numpy()
        arr = _to_nhwc(np.asarray(img)[None])[0].copy()
        if mask is not None:
            arr[..., 0] = np.asarray(mask, np.float32)
        arr = np.clip(arr * 255, 0, 255).astype(np.uint8)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        Image.fromarray(arr).save(out_path)
        return out_path

    # ------------------------------------------------------- checkpoints
    def save(self, path: str) -> None:
        """The full state (weights, BatchNorm statistics, Adam, epoch)."""
        save_state(path, self.state)

    def load(self, path: str, *, full_state: bool = False) -> None:
        """A warm start from a port checkpoint (the reference ctor's
        `.pth` load, `SegFormerModel.py:21-30`): weights and BatchNorm
        statistics where name and shape match, Adam's state and the
        schedule's epoch kept (fresh in a new model). `full_state=True`
        restores Adam and the epoch too (the file must hold this model)."""
        if full_state:
            restore_state(path, self.state)
        else:
            restore_weights(path, self._net)
        self._changed()
        print("Pretrained model loaded")

    def resume(self, directory: str, prefix: str):
        """Restore the full state from `{directory}/{prefix}_last` if it is
        there (`checkpoint/io.py::load_last`): (the epoch to start at, the
        best eval loss so far), or None."""
        got = load_last(directory, prefix, self.state)
        if got is None:
            return None
        self._changed()
        return got[1], got[2]

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]
                        ) -> None:
        """Load a full state_dict of the port's key layout (strict)."""
        self._net.load_state_dict(state_dict, strict=True)
        self._changed()

    def load_hf(self, path_or_state_dict) -> None:
        """Load HF-layout SegFormer weights from a `.safetensors`/`.pth`
        file or a state_dict mapping. The classifier follows the reference:
        channel 0 of a wider head when num_labels is 1, else a head whose
        shape differs keeps its fresh init."""
        if isinstance(path_or_state_dict, str):
            sd = load_torch_checkpoint(path_or_state_dict, self.cfg)
        else:
            sd = dict(path_or_state_dict)
        own = self._net.state_dict()
        for key in ("decode_head.classifier.weight",
                    "decode_head.classifier.bias"):
            if key in sd and sd[key].shape != own[key].shape:
                sd[key] = own[key]
        self.load_state_dict(sd)
        print("Pretrained model loaded")

    # ---------------------------------------------------- not ported yet
    def quantize(self, kind: str = "int8") -> None:
        _not_ported("quantized serving (quantize)")

    def dequantize(self) -> None:
        _not_ported("quantized serving (dequantize)")

    def save_quantized(self, path: str) -> None:
        _not_ported("quantized serving (save_quantized)")

    def load_quantized(self, path: str) -> None:
        _not_ported("quantized serving (load_quantized)")

    def export_serving(self, path: str, batch_size: int, img_size=None,
                       platforms=()) -> dict:
        _not_ported("the serving artifact (export_serving)")

    def export_hf(self, path: str) -> None:
        _not_ported("export_hf")
