"""`SegFormerModel`: the serving surface of the JAX package's `api.py` on
PyTorch - construction with a config, HF-layout weights and a seed, weight
loading (`load_hf`) and `predict` without a target. The training methods
come with the training slices of the port.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from semisupervisedobjectdetection_torch.checkpoint.convert import (
    load_torch_checkpoint,
)
from semisupervisedobjectdetection_torch.core.config import MiTConfig, mit_b5
from semisupervisedobjectdetection_torch.models.segformer import (
    EfficientSelfAttention,
    SegFormer,
    cast_to_compute_dtype,
    forward_masks,
    init_weights,
)
from semisupervisedobjectdetection_torch.utils.device import resolve_device


def _to_nhwc(img) -> np.ndarray:
    """Accept NHWC or NCHW float batches."""
    img = np.asarray(img, np.float32)
    if img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
        img = img.transpose(0, 2, 3, 1)
    return img


class SegFormerModel:
    """SegFormer ready to serve on `device` (the CUDA card unless
    device="cpu").

    Weights are drawn from a `torch.Generator` seeded with `seed` on the CPU
    (so one seed gives the same weights on every device), then replaced by
    `hf_weights` when that is given.
    """

    def __init__(self, num_labels: int = 1,
                 config: Optional[MiTConfig] = None,
                 hf_weights: Optional[str] = None,
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = (config or mit_b5()).replace(num_labels=num_labels)
        self.num_labels = num_labels
        self.seed = seed
        model = SegFormer(self.cfg)
        init_weights(model, torch.Generator().manual_seed(seed))
        # Served masks are held to the plain attention path's: the scalar
        # bfloat16 SR-attention forward gives its bits, the tensor-core one
        # (the training default) differs by an ulp in ~0.07% of outputs,
        # which flipped 0.8% of a random-weight MiT-B5's pixels (PERF.md).
        for layer in model.modules():
            if isinstance(layer, EfficientSelfAttention):
                layer.attn_fwd_mma = False
        self.model = model.eval()
        if hf_weights:
            self.load_hf(hf_weights)
        else:
            self._place()

    def _place(self) -> None:
        cast_to_compute_dtype(self.model.to(self.device))

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]
                        ) -> None:
        """Load a full state_dict of the port's key layout (strict)."""
        self.model.load_state_dict(state_dict, strict=True)
        self._place()

    def load_hf(self, path_or_state_dict) -> None:
        """Load HF-layout SegFormer weights from a `.safetensors`/`.pth`
        file or a state_dict mapping. The classifier follows the reference:
        channel 0 of a wider head when num_labels is 1, else a head whose
        shape differs keeps its fresh init."""
        if isinstance(path_or_state_dict, str):
            sd = load_torch_checkpoint(path_or_state_dict, self.cfg)
        else:
            sd = dict(path_or_state_dict)
        own = self.model.state_dict()
        for key in ("decode_head.classifier.weight",
                    "decode_head.classifier.bias"):
            if key in sd and sd[key].shape != own[key].shape:
                sd[key] = own[key]
        self.load_state_dict(sd)
        print("Pretrained model loaded")

    @torch.inference_mode()
    def predict(self, img) -> np.ndarray:
        """Sigmoid masks (B, H, W) float32 of an NHWC or NCHW float batch
        (B, num_labels as a last axis when num_labels > 1)."""
        images = torch.from_numpy(_to_nhwc(img)).to(self.device)
        masks, _ = forward_masks(self.model, images)
        return masks.cpu().numpy()
