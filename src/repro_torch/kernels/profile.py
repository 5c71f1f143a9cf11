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
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_tile_nnz as tile_nnz_plain  # noqa: F401

launches = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GRID_Y = 65535


def tile_nnz(x: torch.Tensor, tile: Tuple[int, int] = (128, 128)
             ) -> torch.Tensor:
    """Per-tile nonzero counts: (M, N) -> (ceil(M/tm), ceil(N/tn)) int32.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (float32 or bfloat16, unit column stride) or raises.
    """
    if not x.is_cuda:
        return tile_nnz_plain(x, tile)
    global launches
    if x.dim() != 2:
        raise ValueError(f"tile_nnz: expected a 2-D tensor, got {x.dim()}-D")
    tm, tn = tile
    m, n = x.shape
    if tm <= 0 or tn <= 0:
        raise ValueError(f"tile_nnz: tile {tile} must be positive")
    if x.dtype not in DTYPES:
        raise ValueError(f"tile_nnz: dtype {x.dtype} not supported by the "
                         f"kernel ({sorted(map(str, DTYPES))})")
    if x.stride(1) != 1 and n > 1:
        x = x.contiguous()
    mb, nb = -(-m // tm), -(-n // tn)
    if mb * -(-tm // 64) > MAX_GRID_Y:
        raise ValueError(f"tile_nnz: {m} rows at tile {tile} exceed the "
                         "kernel's grid")
    out = torch.zeros((mb, nb), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("tile_nnz", "rt_tile_nnz",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int, ctypes.c_long,
                         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    build.check(fn(x.data_ptr(), DTYPES[x.dtype], out.data_ptr(), m, n,
                   x.stride(0), tm, tn, build.stream(x)), "tile_nnz")
    launches += 1
    return out
