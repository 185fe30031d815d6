"""Device rule of the port: ``device=None`` means the CUDA card.

Without CUDA an entry point raises instead of running quietly on the CPU;
a caller that wants the CPU (the tests) asks for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def as_tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """numpy array, sequence or tensor -> contiguous tensor on ``device``."""
    return torch.as_tensor(a).to(device=device, dtype=dtype).contiguous()
