"""Public wrappers over the primitives (port of ``repro.kernels.ops``).

These own everything the kernels don't: padding to tile multiples,
operand-order normalization (the ``sparse_rhs`` transpose), format
conversion (dense -> Block-CSR / Block-CSC / ELL), and dispatch from a
``Primitive`` code.  A CUDA tensor runs the CUDA kernels, a CPU tensor
their plain versions.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core import formats
from repro_torch.core.perf_model import Primitive
from repro_torch.kernels import csr_spmm as _csr
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import spdmm as _spdmm
from repro_torch.kernels import spmm as _spmm
from repro_torch.kernels.dispatch import pad_to


def gemm(x: torch.Tensor, y: torch.Tensor, *,
         tile: Tuple[int, int, int] = (128, 128, 128)) -> torch.Tensor:
    """Dense tiled matmul for arbitrary 2D shapes (pads, runs, slices)."""
    m, n = x.shape[0], y.shape[1]
    bm, bk, bn = tile
    out = _gemm.gemm(pad_to(x, bm, bk).contiguous(),
                     pad_to(y, bk, bn).contiguous())
    return out[:m, :n]


def spdmm(x: torch.Tensor, y: torch.Tensor, *,
          tile: Tuple[int, int] = (128, 128), bn: int = 128,
          sparse_rhs: bool = False) -> torch.Tensor:
    """Block-sparse x dense.  ``sparse_rhs=True`` treats Y as the sparse
    operand via the transposed product Z = (Y^T X^T)^T."""
    if sparse_rhs:
        return spdmm(y.T, x.T, tile=tile, bn=bn).T
    m, n = x.shape[0], y.shape[1]
    xb = formats.dense_to_bcsr(pad_to(x, *tile), tile)
    out = _spdmm.spdmm(xb, pad_to(y, tile[1], bn).contiguous())
    return out[:m, :n]


def spmm(x: torch.Tensor, y: torch.Tensor, *,
         tile: Tuple[int, int] = (128, 128)) -> torch.Tensor:
    """Block-sparse x block-sparse with tile-pair intersection skipping."""
    m, n = x.shape[0], y.shape[1]
    tk = tile[1]
    xb = formats.dense_to_bcsr(pad_to(x, *tile), tile)
    yb = formats.dense_to_bcsc(pad_to(y, tk, tk), (tk, tk))
    out = _spmm.spmm(xb, yb, _spmm.plan_intersection(xb, yb))
    return out[:m, :n]


def csr_spmm(x: Union[torch.Tensor, formats.ELLMatrix], y: torch.Tensor, *,
             rmax: int = 64) -> torch.Tensor:
    """Row-CSR x dense.  ``x`` is a dense matrix (converted here with
    ``formats.dense_to_ell``) or an already-built ``formats.ELLMatrix``."""
    ell = x if isinstance(x, formats.ELLMatrix) else formats.dense_to_ell(
        x, rmax=rmax)
    return _csr.csr_spmm(ell.values, ell.cols, ell.row_counts,
                         y.contiguous())


def matmul(x: torch.Tensor, y: torch.Tensor, primitive: Primitive, *,
           tile: Tuple[int, int] = (128, 128),
           sparse_rhs: bool = False) -> torch.Tensor:
    """Dispatch one K2P decision (Algorithm 7 output) to its kernel."""
    if primitive == Primitive.SKIP:
        return torch.zeros((x.shape[0], y.shape[1]),
                           dtype=torch.promote_types(x.dtype, y.dtype),
                           device=y.device)
    if primitive == Primitive.GEMM:
        return gemm(x, y, tile=(tile[0], tile[1], tile[1]))
    if primitive == Primitive.SPDMM:
        return spdmm(x, y, tile=tile, sparse_rhs=sparse_rhs)
    if primitive == Primitive.SPMM:
        return spmm(x, y, tile=tile)
    raise ValueError(f"unknown primitive {primitive}")
