"""Public wrappers over the primitives (port of ``repro.kernels.ops``).

These own everything the kernels don't: padding to tile multiples,
operand-order normalization (the ``sparse_rhs`` transpose), format
conversion (dense -> Block-CSR / Block-CSC / ELL), dispatch from a
``Primitive`` code, attention's GQA check and front padding, and the
layout of GAT's edge-softmax operands.  A CUDA tensor runs the CUDA
kernels, a CPU tensor their plain versions.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import formats
from repro_torch.core.perf_model import Primitive
from repro_torch.kernels import csr_spmm as _csr
from repro_torch.kernels import edge_softmax as _edge
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import profile as _profile
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
    ``formats.dense_to_ell``) or an already-built ``formats.ELLMatrix``.
    The kernel accumulates in float32; the result takes
    ``promote_types(x, y)``, as in the reference."""
    ell = x if isinstance(x, formats.ELLMatrix) else formats.dense_to_ell(
        x, rmax=rmax)
    out = _csr.csr_spmm(ell.values, ell.cols, ell.row_counts, y.contiguous())
    return out.to(torch.promote_types(ell.values.dtype, y.dtype))


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


def tile_nnz(x: torch.Tensor, *, tile: Tuple[int, int] = (128, 128)
             ) -> torch.Tensor:
    """Per-tile nonzero counts (the profiling fused at writeback): pads
    ``x`` with zeros to tile multiples, counts with one ``tile_nnz``
    launch (a CUDA tensor) or its plain version (a CPU tensor), and crops
    to (ceil(M/tm), ceil(N/tn)).  The padding adds no nonzero, so the
    counts are those of the ragged tiles."""
    mb, nb = -(-x.shape[0] // tile[0]), -(-x.shape[1] // tile[1])
    return _profile.tile_nnz(pad_to(x, *tile), tile)[:mb, :nb]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """(B, H, Sq, D) x (B, Hkv, Skv, D): front-pads the sequence dims to
    ``min(bq, Sq)`` / ``min(bk, Skv)`` multiples, as the reference does
    (``repro/kernels/ops.py:129-153``).  GQA kv heads are mapped inside the
    kernel (the value equals the reference's ``jnp.repeat``)."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {hkv} kv heads")
    bq, bk = min(bq, max(sq, 1)), min(bk, max(skv, 1))
    pq, pk = (-sq) % bq, (-skv) % bk
    if pk and not causal:
        raise ValueError("non-causal flash requires Skv % bk == 0")
    if pq or pk:
        # FRONT-pad both so the causal "queries at the end of the kv
        # sequence" alignment holds for the real rows.  The padded keys
        # stay visible to the real queries (as in the reference).
        q = F.pad(q, (0, 0, pq, 0))
        k = F.pad(k, (0, 0, pk, 0))
        v = F.pad(v, (0, 0, pk, 0))
    out = _flash.flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
    return out[:, :, pq:, :]


def edge_softmax(a: torch.Tensor, z: torch.Tensor, att_src: torch.Tensor,
                 att_dst: torch.Tensor, *, slope: float = 0.2,
                 threshold: float = 0.0,
                 out_block: Tuple[int, int] = (128, 128)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAT's thresholded masked edge-softmax over ``a``'s support (the
    reference's ``attention_adjacency`` body) on contiguous operands:
    ``(alpha, counts)``, the counts of alpha's nonzeros per ``out_block``
    tile."""
    return _edge.edge_softmax(a.contiguous(), z.contiguous(),
                              att_src.contiguous(), att_dst.contiguous(),
                              slope=slope, threshold=threshold,
                              out_block=out_block)
