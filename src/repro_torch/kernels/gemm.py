"""GEMM primitive: dense tiled matmul (paper's "GEMM mode").

Port of ``repro.kernels.gemm`` (the Pallas kernel at
``src/repro/kernels/gemm.py:37``).  The CUDA kernel is ``csrc/gemm.cu``:
one CTA per 16x16 output tile, a k loop through shared memory, and a
float32 FMA accumulator.  ``gemm_plain`` (``ref.ref_matmul``) is the plain
PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_matmul as gemm_plain  # noqa: F401

launches = 0


def gemm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` for shapes that are multiples of 16 (``ops.gemm`` pads).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (float32 only) or raises.
    """
    if not x.is_cuda:
        return gemm_plain(x, y)
    global launches
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2 or m % 16 or k % 16 or n % 16:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} x {tuple(y.shape)} "
                         "must agree and be multiples of 16")
    build.require("gemm x", x, torch.float32)
    build.require("gemm y", y, torch.float32)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("gemm", "rt_gemm", [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, k, n,
                   build.stream(x)), "gemm")
    launches += 1
    return out
