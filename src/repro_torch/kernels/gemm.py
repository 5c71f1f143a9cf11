"""GEMM primitive: dense tiled matmul (paper's "GEMM mode").

Port of ``repro.kernels.gemm`` (the Pallas kernel at
``src/repro/kernels/gemm.py:37``).  The CUDA kernel is ``csrc/gemm.cu``:
one CTA per output tile (128 x 128 or 16 x 16, picked from the shape by
:func:`gemm_launch`), register microtiles on the FP32 FMA units,
operands staged through double buffers or a ``cp.async`` ring, and the
whole k loop in one CTA, so every output is one FMA chain over k ascending
whatever the tile.
``gemm_plain`` (``ref.ref_matmul``) is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ref_matmul as gemm_plain  # noqa: F401

launches = 0
TILES = (128, 16)         # square CTA tiles of csrc/gemm.cu


@functools.lru_cache(maxsize=256)
def gemm_launch(m: int, n: int, sms: int = build.H100_SMS) -> int:
    """The CTA tile edge for an (m, n) output: 128 when the output is at
    least 128 wide and 128 x 128 tiles still launch ``sms`` CTAs, else 16.
    The k loop is never split, so the tile changes no output's bits."""
    if n >= 128 and -(-m // 128) * -(-n // 128) >= sms:
        return 128
    return 16


def gemm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` for shapes that are multiples of 16 (``ops.gemm`` pads).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (float32, contiguous, 16-byte aligned) or raises.
    """
    if not x.is_cuda:
        return gemm_plain(x, y)
    build.refuse_grad("gemm", x, y)
    global launches
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2 or m % 16 or k % 16 or n % 16:
        raise ValueError(f"gemm: shapes {tuple(x.shape)} x {tuple(y.shape)} "
                         "must agree and be multiples of 16")
    for name, t in (("x", x), ("y", y)):
        build.require(f"gemm {name}", t, torch.float32)
        build.require_aligned(f"gemm {name}", t)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = build.function("gemm", "rt_gemm", [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    build.check(fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), m, k, n,
                   gemm_launch(m, n, build.sm_count(x.device)), build.stream(x)),
                "gemm")
    launches += 1
    return out
