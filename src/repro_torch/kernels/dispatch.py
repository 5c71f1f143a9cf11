"""The executor's block path: one launch walks the whole primitive-code grid.

The reference dispatches every (i, j, k) reduction step with a
``lax.switch`` inside a ``lax.scan`` (``src/repro/core/dynasparse.py:239``);
with kernels on, each non-SKIP step is its own Pallas call.  The port runs
the whole grid as one CUDA launch (``csrc/dispatch.cu``): one CTA per
output block, the k loop in order, each step's primitive read from
``codes`` on the device.  Blocks of 128 or 256 rows or columns run as
64 x 64 CTAs that share their block's code.  Operands are float32 or
bfloat16; the product accumulates in float32.  :func:`block_matmul_plain`
is the plain PyTorch version with the same per-step accumulation
(``acc + step``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.profile import tile_nnz

launches = 0
TILE = 16
BLOCK_EDGES = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad ``x`` up to a multiple of ``rows`` x ``cols``."""
    m, n = x.shape
    pm, pn = (-m) % rows, (-n) % cols
    return F.pad(x, (0, pn, 0, pm)) if (pm or pn) else x


def tile_occupancy(x: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (ceil(M/16), ceil(N/16)) uint8 nonzero-tile flags, from
    the profiler kernel's 16x16 counts."""
    return (tile_nnz(x, (TILE, TILE)) > 0).to(torch.uint8)


def _pad_grid(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` zero-padded to exactly ``rows`` x ``cols``, contiguous; no copy
    when it already is."""
    m, n = x.shape
    if (m, n) != (rows, cols):
        x = F.pad(x, (0, cols - n, 0, rows - m))
    return x.contiguous()


def _shapes(x, y, codes, block):
    bm, bk, bn = block
    I, J, K = codes.shape
    if (x.shape[0] > I * bm or x.shape[1] > K * bk or y.shape[0] > K * bk
            or y.shape[1] > J * bn or x.shape[1] != y.shape[0]):
        raise ValueError(f"block_matmul: {tuple(x.shape)} x {tuple(y.shape)} "
                         f"does not fit codes {tuple(codes.shape)} at {block}")
    return bm, bk, bn, I, J, K


def _out(out, rows, cols, device):
    if out is None:
        return torch.zeros((rows, cols), dtype=torch.float32, device=device)
    if tuple(out.shape) != (rows, cols):
        raise ValueError(f"block_matmul: out must be ({rows}, {cols})")
    return out


def block_matmul_plain(x: torch.Tensor, y: torch.Tensor,
                       codes: torch.Tensor, block: Tuple[int, int, int], *,
                       out: Optional[torch.Tensor] = None,
                       skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per output block (i, j): acc = sum over k with codes[i,j,k] != SKIP
    of the float32 block product, added step by step in k order.  Every
    non-SKIP primitive computes the same value; they differ only in what
    they skip."""
    bm, bk, bn, I, J, K = _shapes(x, y, codes, block)
    out = _out(out, I * bm, J * bn, y.device)
    if skip is not None and bool(skip):
        return out
    xb = pad_to(x.float(), bm, bk)
    xb = F.pad(xb, (0, K * bk - xb.shape[1], 0, I * bm - xb.shape[0]))
    yb = pad_to(y.float(), bk, bn)
    yb = F.pad(yb, (0, J * bn - yb.shape[1], 0, K * bk - yb.shape[0]))
    xb = xb.reshape(I, bm, K, bk).permute(0, 2, 1, 3)      # (I, K, bm, bk)
    yb = yb.reshape(K, bk, J, bn).permute(0, 2, 1, 3)      # (K, J, bk, bn)
    acc = torch.zeros((I, J, bm, bn), dtype=torch.float32, device=y.device)
    for k in range(K):
        step = torch.matmul(xb[:, k, None], yb[k][None])   # (I, J, bm, bn)
        run = (codes[:, :, k] != 0)[:, :, None, None]
        acc = torch.where(run, acc + step, acc)
    out.copy_(acc.permute(0, 2, 1, 3).reshape(I * bm, J * bn))
    return out


def block_matmul(x: torch.Tensor, y: torch.Tensor, codes: torch.Tensor,
                 block: Tuple[int, int, int], *,
                 out: Optional[torch.Tensor] = None,
                 skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ y`` dispatched by the (I, J, K) int32 code grid at
    ``block = (bm, bk, bn)``; returns the padded ``(I*bm, J*bn)`` float32
    product (written into ``out`` when given).  When the device flag
    ``skip`` is nonzero nothing is written.

    On CUDA: float32 or bfloat16 operands of one type, ``bm`` and ``bn`` in
    ``BLOCK_EDGES`` and ``bk`` a multiple of 16.
    """
    if not y.is_cuda:
        return block_matmul_plain(x, y, codes, block, out=out, skip=skip)
    global launches
    bm, bk, bn, I, J, K = _shapes(x, y, codes, block)
    if bm not in BLOCK_EDGES or bn not in BLOCK_EDGES or bk % TILE:
        raise ValueError(f"block_matmul: block {block} not supported by the "
                         f"kernel (bm, bn in {BLOCK_EDGES}, bk % 16 == 0)")
    if x.dtype != y.dtype or y.dtype not in DTYPES:
        raise ValueError(f"block_matmul: operands {x.dtype} x {y.dtype} must "
                         "both be float32 or both bfloat16")
    xp = _pad_grid(x, I * bm, K * bk)
    yp = _pad_grid(y, K * bk, J * bn)
    build.require("block_matmul x", xp, y.dtype)
    build.require("block_matmul y", yp, y.dtype)
    build.require("block_matmul codes", codes, torch.int32)
    if skip is not None:
        build.require("block_matmul skip", skip, torch.int32)
    out = _out(out, I * bm, J * bn, y.device)
    build.require("block_matmul out", out, torch.float32)
    if out.numel() == 0:
        return out
    occ_x = tile_occupancy(xp)
    occ_y = tile_occupancy(yp)
    fn = build.function("dispatch", "rt_dispatch", [ctypes.c_void_p] * 2
                        + [ctypes.c_int] + [ctypes.c_void_p] * 5
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    build.check(fn(xp.data_ptr(), yp.data_ptr(), DTYPES[y.dtype],
                   codes.data_ptr(),
                   occ_x.data_ptr(), occ_y.data_ptr(), out.data_ptr(),
                   None if skip is None else skip.data_ptr(),
                   I, J, K, bm, bk, bn, build.stream(y)), "dispatch")
    launches += 1
    return out
