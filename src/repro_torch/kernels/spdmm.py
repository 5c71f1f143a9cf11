"""SpDMM primitive: block-sparse x dense matmul (paper's "SpDMM mode").

Port of ``repro.kernels.spdmm`` (the Pallas kernel at
``src/repro/kernels/spdmm.py:50``).  The sparse operand is Block-CSR
(``core.formats.BlockCSRMatrix``); for each tile-row the kernel walks only
its ``counts[i]`` nonzero tiles, taking the dense operand's matching tile
from ``col_idx[i, s]``.  The CUDA kernel is ``csrc/spdmm.cu``;
:func:`spdmm_plain` is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import BlockCSRMatrix
from repro_torch.kernels import build

launches = 0


def _check_shapes(x: BlockCSRMatrix, y: torch.Tensor) -> None:
    kb, tk = x.grid[1], x.tile[1]
    if y.shape[0] != kb * tk:
        raise ValueError(f"spdmm: y has {y.shape[0]} rows, the Block-CSR "
                         f"operand needs {kb * tk}")


def spdmm_plain(x: BlockCSRMatrix, y: torch.Tensor) -> torch.Tensor:
    """Tile-row i of the result is sum_{s < counts[i]} blocks[i, s] @
    y[col_idx[i, s]], accumulated in float32 slot by slot."""
    _check_shapes(x, y)
    tm, tk = x.tile
    mb, smax = x.col_idx.shape
    n = y.shape[1]
    yt = y.float().reshape(-1, tk, n)                    # (Kb, tk, n)
    out = torch.zeros((mb, tm, n), dtype=torch.float32, device=y.device)
    for s in range(smax):
        valid = (s < x.counts)[:, None, None]
        step = torch.matmul(x.blocks[:, s].float(), yt[x.col_idx[:, s].long()])
        out = torch.where(valid, out + step, out)
    return out.reshape(mb * tm, n).to(
        torch.promote_types(x.blocks.dtype, y.dtype))


def spdmm(x: BlockCSRMatrix, y: torch.Tensor) -> torch.Tensor:
    """``dense(x) @ y`` for a Block-CSR ``x`` and ``y`` of ``(Kb*tk, n)``;
    returns the tile-padded ``(Mb*tm, n)`` product.  On CUDA the tile edges
    and ``n`` must be multiples of 16 and the tensors float32."""
    if not y.is_cuda:
        return spdmm_plain(x, y)
    global launches
    _check_shapes(x, y)
    tm, tk = x.tile
    mb, smax = x.col_idx.shape
    n = y.shape[1]
    if tm % 16 or tk % 16 or n % 16:
        raise ValueError(f"spdmm: tile {x.tile} and width {n} must be "
                         "multiples of 16")
    build.require("spdmm col_idx", x.col_idx, torch.int32)
    build.require("spdmm counts", x.counts, torch.int32)
    build.require("spdmm blocks", x.blocks, torch.float32)
    build.require("spdmm y", y, torch.float32)
    out = torch.empty((mb * tm, n), dtype=torch.float32, device=y.device)
    if out.numel() == 0:
        return out
    fn = build.function("spdmm", "rt_spdmm", [ctypes.c_void_p] * 5
                        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    build.check(fn(x.col_idx.data_ptr(), x.counts.data_ptr(),
                   x.blocks.data_ptr(), y.data_ptr(), out.data_ptr(),
                   mb, smax, tm, tk, n, build.stream(y)), "spdmm")
    launches += 1
    return out
