"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`device` or, when it is None, "cuda". Raises when a CUDA device is
    asked for and there is none: the entry points do not carry on on the
    CPU unless the caller passes device="cpu" (--device cpu)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    return dev


def device_name(device: torch.device) -> str:
    """The card's name for a CUDA device, else the device type."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
