"""The comparison that decides ``correct``.

The number compared is ``max_rel_err``: the largest absolute gap between
an output of the program and the reference's, over every element, as a
share of the reference's largest absolute value; the worst over the
checked outputs.  A missing output, a wrong shape, or a value that is not
finite reads infinity.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def max_rel_err(out: Optional[torch.Tensor], ref: torch.Tensor) -> float:
    if out is None or tuple(out.shape) != tuple(ref.shape):
        return math.inf
    gap = float((out.to(ref.device, torch.float32) - ref).abs().max())
    scale = float(ref.abs().max())
    err = gap / scale if scale > 0 else gap
    return err if math.isfinite(err) else math.inf
