"""Export the port's model as a torch/HF-layout SegFormer checkpoint, the
JAX package's `checkpoint/hf_export.py` in PyTorch.

The port's parameters already carry the HF SegFormer keys, so the state
dict is the model's own, in the layout of the JAX package's
`export_torch_state_dict`: float32 tensors on the CPU, the decode head's
BatchNorm with its running statistics and a zero `num_batches_tracked`,
and no prompt or CLS tokens. Those have no home in a torch SegFormer's
state dict (the reference keeps them in encoder-owned lists,
`models/SegFormerModel.py:69-101`): `export_prompt_tokens` returns them per
stage for hand-assignment. `save_torch_checkpoint` writes `.pth`/`.bin`
(`torch.save`, the reference's format) or `.safetensors` (which needs the
`safetensors` package, imported only then).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

_TOKENS = ("segformer.encoder.prompt_tokens.", "segformer.encoder.cls_token.")
_BN_COUNT = "decode_head.batch_norm.num_batches_tracked"


def export_torch_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The float model's HF-layout state dict: {key: float32 CPU tensor},
    the tokens left out, `num_batches_tracked` zero (int64)."""
    sd = {k: v.detach().to("cpu", torch.float32, copy=True).contiguous()
          for k, v in model.state_dict().items()
          if not k.startswith(_TOKENS) and k != _BN_COUNT}
    sd[_BN_COUNT] = torch.zeros((), dtype=torch.int64)
    return sd


def export_prompt_tokens(model: nn.Module
                         ) -> Tuple[List[Optional[np.ndarray]],
                                    List[Optional[np.ndarray]]]:
    """(prompt tokens, CLS tokens): a float32 numpy array or None per
    stage, for the reference's `encoder.prompt_tokens[i]` and
    `encoder.cls_token[i]`."""
    enc = model.segformer.encoder
    n = model.cfg.num_stages

    def per_stage(params):
        return [params[str(i)].detach().float().cpu().numpy()
                if str(i) in params else None for i in range(n)]

    return per_stage(enc.prompt_tokens), per_stage(enc.cls_token)


def save_torch_checkpoint(path: str, sd: Dict[str, torch.Tensor]) -> None:
    """Write `sd` as `.safetensors` or, for any other name, `torch.save` of
    CPU tensors (`.pth`/`.bin`)."""
    if path.endswith(".safetensors"):
        from safetensors.torch import save_file

        save_file(sd, path)
        return
    torch.save(sd, path)
