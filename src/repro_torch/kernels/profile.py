"""Sparsity Profiler kernel (paper Section V-B2): per-tile nonzero counts.

Port of ``repro.kernels.profile`` (the Pallas kernel at
``src/repro/kernels/profile.py:25``).  The CUDA kernel is
``csrc/tile_nnz.cu``: each thread counts one column of a tile row's strip,
shared-memory and global integer atomics sum the tiles, so the counts are
exact whatever the schedule.  It takes any shape and tile (ragged edge
tiles count only the elements inside the matrix) and float32 or bfloat16.
``tile_nnz_plain`` (``ref.ref_tile_nnz``) is the plain PyTorch
version.  ``core.profiler.block_counts`` and ``dispatch.tile_occupancy``
count through it.

:func:`tile_nnz_batched` is its batched route, a stack (B, M, N) counted
in one launch with the stack on the grid's z axis: the serving wave's
request inputs (``core.profiler.batched_block_counts``, port of the
reference's fused reduction at ``src/repro/core/profiler.py:60``).  Its
launches count apart, in ``batched_launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_tile_nnz as tile_nnz_plain  # noqa: F401

launches = 0
batched_launches = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535
MAX_GRID_Z = 65535


def _launch(x: torch.Tensor, tile: Tuple[int, int], name: str
            ) -> torch.Tensor:
    """Count a CUDA stack (B, M, N) in one launch of ``rt_tile_nnz``, or
    raise ``ValueError`` for what the kernel does not take."""
    tm, tn = tile
    b, m, n = x.shape
    if tm <= 0 or tn <= 0:
        raise ValueError(f"{name}: tile {tile} must be positive")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not supported by the "
                         f"kernel ({sorted(map(str, DTYPES))})")
    mb, nb = -(-m // tm), -(-n // tn)
    if mb * -(-tm // 64) > MAX_GRID_Y or b > MAX_GRID_Z:
        raise ValueError(f"{name}: {b} x {m} rows at tile {tile} exceed the "
                         "kernel's grid")
    if x.stride(2) != 1 and n > 1:
        x = x.contiguous()
    out = torch.zeros((b, mb, nb), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("tile_nnz", "rt_tile_nnz",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                        + [ctypes.c_int] * 3 + [ctypes.c_long] * 2
                        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    build.check(fn(x.data_ptr(), DTYPES[x.dtype], out.data_ptr(), b, m, n,
                   x.stride(1), x.stride(0) if b > 1 else 0, *tile,
                   build.stream(x)), name)
    return out


def tile_nnz(x: torch.Tensor, tile: Tuple[int, int] = (128, 128)
             ) -> torch.Tensor:
    """Per-tile nonzero counts: (M, N) -> (ceil(M/tm), ceil(N/tn)) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (float32 or bfloat16) or raises.
    """
    if not x.is_cuda:
        return tile_nnz_plain(x, tile)
    global launches
    if x.dim() != 2:
        raise ValueError(f"tile_nnz: expected a 2-D tensor, got {x.dim()}-D")
    out = _launch(x[None], tile, "tile_nnz")[0]
    launches += 1
    return out


def tile_nnz_batched(x: torch.Tensor, tile: Tuple[int, int] = (128, 128)
                     ) -> torch.Tensor:
    """Per-tile nonzero counts of each matrix of a stack in one launch:
    (B, M, N) -> (B, ceil(M/tm), ceil(N/tn)) int32, slice b bitwise
    ``tile_nnz(x[b], tile)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (float32 or bfloat16, any batch and row strides; at most
    ``MAX_GRID_Z`` matrices) or raises.
    """
    if x.dim() != 3:
        raise ValueError(f"tile_nnz_batched: expected a 3-D stack, got "
                         f"{x.dim()}-D")
    if not x.is_cuda:
        return tile_nnz_plain(x, tile)
    global batched_launches
    out = _launch(x, tile, "tile_nnz_batched")
    batched_launches += 1
    return out
