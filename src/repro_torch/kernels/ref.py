"""Plain oracle shared by the block primitives (port of
``repro.kernels.ref.ref_matmul``)."""
from __future__ import annotations

import torch


def ref_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """GEMM, SpDMM and SPMM differ only in which zeros they skip, never in
    the value they compute: float32 ``x @ y`` in the promoted dtype."""
    out = torch.matmul(x.float(), y.float())
    return out.to(torch.promote_types(x.dtype, y.dtype))
