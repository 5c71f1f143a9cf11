"""Device resolution shared by the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: ``None``
means ``cuda``, and a CUDA request without a card raises instead of
quietly running the plain PyTorch versions on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev
