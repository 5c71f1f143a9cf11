"""SpDMM primitive: block-sparse x dense matmul (paper's "SpDMM mode").

Port of ``repro.kernels.spdmm`` (the Pallas kernel at
``src/repro/kernels/spdmm.py:50``).  The sparse operand is Block-CSR
(``core.formats.BlockCSRMatrix``); for each tile-row the kernel walks only
its ``counts[i]`` nonzero tiles, taking the dense operand's matching rows
from ``col_idx[i, s]``.  The CUDA kernel is ``csrc/spdmm.cu``: a CTA per 16
rows x 128 columns for wide outputs, a warp per 16 (or 8) rows x 16
columns for narrow ones (:func:`spdmm_launch`), tile-rows longest first
(:func:`row_order_plain`, ranked on the device).  Each output is one FMA
chain over the row's nonzero tiles in slot order, k ascending, from 0:
the dense ``gemm``'s value bit for bit.  :func:`spdmm_plain` is the plain
PyTorch version.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.formats import BlockCSRMatrix
from repro_torch.kernels import build

launches = 0
# launches by (output rows, x's columns, output width), both padded to the
# tile: the shapes the path gives the two routes
launches_by_shape: collections.Counter = collections.Counter()
WIDE_COLS = 128        # columns of a CTA of the wide route
WARP_COLS = 16         # columns of a warp of the warp route
MAX_WARPS = 4          # warps per CTA of spdmm's warp route


@dataclasses.dataclass(frozen=True)
class SparseLaunch:
    """Launch shape of a block-sparse walk: the output is cut into
    ``row_units`` x ``col_units`` units of ``unit_rows`` x ``unit_cols``
    (a CTA each when ``unit_cols`` is 128, the wide route; else a warp
    each, ``per_cta`` warps a CTA).  Unit w covers row unit ``w //
    col_units`` of the long-rows-first order and column unit ``w %
    col_units``."""
    unit_rows: int
    unit_cols: int
    row_units: int
    col_units: int
    per_cta: int

    @property
    def wide(self) -> bool:
        return self.unit_cols == WIDE_COLS

    @property
    def ctas(self) -> int:
        return -(-self.row_units * self.col_units // self.per_cta)


def warp_launch(rows: int, n: int, max_warps: int,
                sms: int = build.H100_SMS) -> Optional[SparseLaunch]:
    """One warp per 16 rows x 16 columns (8 rows when that leaves fewer
    than 4 warps per SM), up to ``max_warps`` warps a CTA (fewer when the
    CTAs would not fill ``sms`` SMs; the warps walk alone, so the CTA only
    places them).  ``rows`` is a multiple of 16."""
    if rows <= 0 or n <= 0:
        return None
    col_units = -(-n // WARP_COLS)
    unit_rows = 16 if rows // 16 * col_units >= 4 * sms else 8
    units = rows // unit_rows * col_units
    per_cta = max_warps
    while per_cta > 1 and -(-units // per_cta) < sms:
        per_cta //= 2
    return SparseLaunch(unit_rows, WARP_COLS, rows // unit_rows, col_units,
                        per_cta)


@functools.lru_cache(maxsize=1024)
def spdmm_launch(rows: int, n: int,
                 sms: int = build.H100_SMS) -> Optional[SparseLaunch]:
    """The spdmm kernel's route for a ``rows`` x ``n`` output (multiples of
    16), or None when there is nothing to write: the wide route (16 x 128
    per CTA) when the output is at least 128 wide, else the warp route.
    No route splits k, so the choice changes no output's bits."""
    if rows <= 0 or n <= 0:
        return None
    if n >= WIDE_COLS:
        return SparseLaunch(16, WIDE_COLS, rows // 16, -(-n // WIDE_COLS), 1)
    return warp_launch(rows, n, MAX_WARPS, sms)


def row_order_plain(counts: torch.Tensor) -> torch.Tensor:
    """The tile-rows by descending ``counts``, ties in row order (int32):
    the order in which the sparse kernels start their tile-rows, longest
    walks first.  They rank them on the device in their own C call
    (``csrc/sparse.cuh`` row_order_kernel); a wrong order leaves output
    rows unwritten, which the card tests' bitwise checks catch."""
    return torch.argsort(counts, descending=True, stable=True).to(
        torch.int32)


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
    and ``n`` must be multiples of 16, the tensors float32 and the payload
    and ``y`` 16-byte aligned: callers pass ``dispatch.pad_to(y, 16,
    16).contiguous()``, whose rows are whole 16-byte words."""
    if not y.is_cuda:
        return spdmm_plain(x, y)
    build.refuse_grad("spdmm", x.blocks, y)
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
    build.require_aligned("spdmm blocks", x.blocks)
    build.require_aligned("spdmm y", y)
    out = torch.empty((mb * tm, n), dtype=torch.float32, device=y.device)
    if out.numel() == 0:
        return out
    shape = spdmm_launch(mb * tm, n, build.sm_count(y.device))
    order = torch.empty_like(x.counts)      # ranked in the same C call
    fn = build.function("spdmm", "rt_spdmm", [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 5 + [ctypes.c_long]
                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    build.check(fn(x.col_idx.data_ptr(), x.counts.data_ptr(),
                   x.blocks.data_ptr(), y.data_ptr(), order.data_ptr(),
                   out.data_ptr(), mb, smax, tm, tk, n, y.shape[0],
                   shape.unit_rows, shape.unit_cols, shape.per_cta,
                   build.stream(y)), "spdmm")
    launches += 1
    launches_by_shape[(mb * tm, y.shape[0], n)] += 1
    return out
