"""The unified Dynasparse executor: profile -> plan -> dispatch -> epilogue.

Port of ``repro.core.dynasparse.dynasparse_matmul``.  One call runs

    profile block densities  ->  plan_codes (any strategy)  ->
    block path (one kernel launch over the whole code grid)  ->
    epilogue (residual + scale + activation)  ->
    writeback profile (block counts of the result)

on the operands' device with no host round trip: the code grid, the
format decision and the row-fit check stay on the GPU.  Where the
reference branches with ``lax.cond`` between the block path and the
row-CSR path, the port launches both kernels into one output buffer and
each reads the device-side decision: the one not selected exits at once.

Routes of the block path:

* ``dynamic`` -- the ``dispatch`` kernel walks the planned (I, J, K) grid;
* a static strategy (``gemm``/``s1``/``s2``) fixes one primitive for the
  whole kernel, known on the host without looking at the data, so the
  product runs as one ``gemm`` launch or one ``spdmm`` launch over the
  Block-CSR lhs (16x16 tiles).  Their code grids are still returned.

Operands are float32 or bfloat16 (the LM's FFN); the block path
accumulates in float32 and the result takes ``promote_types(x, y)``, as
in the reference.  The static routes' kernels take float32 only.

The planner bypasses (``codes``, ``dens_x``/``dens_y``, ``fmt``, ``ell``)
keep the reference's meaning: the fused whole-model executor plans from
propagated writeback profiles and shares one ELL view across kernels.
GAT's ``attention_adjacency`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import analyzer, formats, profiler
from repro_torch.core.ir import KernelType
from repro_torch.core.perf_model import FPGACostModel, Format, Primitive
from repro_torch.kernels import csr_spmm as _csr
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import spdmm as _spdmm

TILE = (16, 16)     # the static SpDMM route's Block-CSR tile


@dataclasses.dataclass
class DynasparseResult:
    out: torch.Tensor
    codes: torch.Tensor         # (I, J, K) int32 Primitive per reduction step
    dens_x: torch.Tensor        # (I, K) block densities of X
    dens_y: torch.Tensor        # (K, J) block densities of Y
    out_density: torch.Tensor   # block densities of the (post-epilogue) result
    out_counts: torch.Tensor    # nonzero counts of the result at out_block
    fmt: torch.Tensor           # () int32 Format actually executed


def mask_ell(ell: formats.ELLMatrix, want: torch.Tensor) -> formats.ELLMatrix:
    """``ell`` when the device flag ``want`` selects CSR, else all zeros,
    chosen on the device so the decision never reaches the host."""
    on = want == Format.CSR
    return formats.ELLMatrix(torch.where(on, ell.values, 0),
                             torch.where(on, ell.cols, 0),
                             torch.where(on, ell.row_counts, 0), ell.shape)


def ell_when(want: torch.Tensor, x: torch.Tensor, rmax: int
             ) -> formats.ELLMatrix:
    """The ELL view of ``x`` when ``want`` selects CSR, else all zeros.

    The conversion always runs (it is cheap on the GPU next to a host
    round trip); the reference converts only under its ``lax.cond``.
    """
    return mask_ell(formats.dense_to_ell(x, rmax=rmax), want)


def _block_path(x, y, codes, block, static, out, skip) -> torch.Tensor:
    """The padded float32 product through the route the strategy fixes."""
    m, n = x.shape[0], y.shape[1]
    if static == Primitive.GEMM:
        bm, bk, bn = block
        full = _gemm.gemm(_dispatch.pad_to(x, bm, bk).contiguous(),
                          _dispatch.pad_to(y, bk, bn).contiguous())
        return full[:m, :n]
    if static == Primitive.SPDMM:
        xb = formats.dense_to_bcsr(x, TILE)
        full = _spdmm.spdmm(xb, _dispatch.pad_to(y, TILE[1], 16).contiguous())
        return full[:m, :n]
    # the padded rows are needed only where csr_spmm shares ``out``
    full = _dispatch.block_matmul(x, y, codes, block, out=out, skip=skip,
                                  pad_rows=out is not None)
    return full[:m, :n]


def dynasparse_matmul(
    x: torch.Tensor,
    y: torch.Tensor,
    *,
    codes: Optional[torch.Tensor] = None,
    dens_x: Optional[torch.Tensor] = None,
    dens_y: Optional[torch.Tensor] = None,
    fmt: Optional[torch.Tensor] = None,
    ell: Optional[formats.ELLMatrix] = None,
    residual: Optional[torch.Tensor] = None,
    strategy: str = "dynamic",
    kernel_type: Optional[KernelType] = None,
    epilogue_scale: float = 1.0,
    activation: str = "none",
    out_block: Optional[Tuple[int, int]] = None,
    block: Tuple[int, int, int] = (128, 128, 128),
    cost_model=FPGACostModel(),
    format_aware: bool = False,
    csr_rmax: int = 64,
) -> DynasparseResult:
    """``x @ y`` with per-(partition pair) primitive dispatch + epilogue.

    ``block = (bm, bk, bn)``: X is partitioned (bm x bk), Y (bk x bn).
    ``strategy`` picks the K2P rule (``dynamic`` runs Algorithm 7 through
    ``cost_model.select_traced``).  Epilogue: ``out += residual *
    epilogue_scale`` then ``activation`` (none/relu/prelu).  The result is
    profiled at ``out_block`` (default (bm, bn)).  With ``format_aware``
    the planner also scores row-CSR (``analyzer.plan_format``); the CSR path
    runs when CSR wins AND every row fits ``csr_rmax`` (checked on the
    device).
    """
    m, n = x.shape[0], y.shape[1]
    bm, bk, bn = block
    if dens_x is None:
        dens_x = profiler.block_density(x, (bm, bk))
    if dens_y is None:
        dens_y = profiler.block_density(y, (bk, bn))
    if codes is None:
        codes = analyzer.plan_codes(strategy, dens_x, dens_y, cost_model,
                                    kernel_type=kernel_type)
    if format_aware and fmt is None:
        fmt = analyzer.plan_format(strategy, dens_x, dens_y, tuple(x.shape),
                                   n, block, cost_model,
                                   kernel_type=kernel_type, rmax=csr_rmax)

    out_dtype = torch.promote_types(x.dtype, y.dtype)
    if residual is not None:
        out_dtype = torch.promote_types(out_dtype, residual.dtype)

    I, K = codes.shape[0], codes.shape[2]
    J = codes.shape[1]
    if format_aware and fmt is not None:
        if ell is None:
            ell = ell_when(fmt, x, csr_rmax)
        fits = (ell.row_counts.max() <= csr_rmax if m
                else torch.ones((), dtype=torch.bool, device=y.device))
        use_csr = ((fmt == Format.CSR) & fits).to(torch.int32)
        buf = torch.empty((I * bm, J * bn), dtype=torch.float32,
                          device=y.device)
        out = _block_path(x, y, codes, block, None, buf, use_csr)
        _csr.csr_spmm(ell.values, ell.cols, ell.row_counts, y.contiguous(),
                      out=buf, run=use_csr)
        executed_fmt = use_csr
    else:
        static = (None if strategy == "dynamic"
                  else analyzer.static_primitive(strategy, kernel_type))
        out = _block_path(x, y, codes, block, static, None, None)
        executed_fmt = torch.zeros((), dtype=torch.int32, device=y.device)
    out = out.to(out_dtype)

    if residual is not None:
        out = out + (residual if epilogue_scale == 1.0
                     else residual * epilogue_scale)
    if activation == "relu":
        out = torch.relu(out)
    elif activation == "prelu":
        out = torch.where(out >= 0, out, 0.25 * out)
    elif activation != "none":
        raise ValueError(f"unknown activation {activation!r}")
    out = out.contiguous()

    ob = out_block or (bm, bn)
    out_counts = profiler.block_counts(out, ob)
    out_density = profiler.density_from_counts(out_counts, m, n, *ob)
    return DynasparseResult(out, codes, dens_x, dens_y, out_density,
                            out_counts, executed_fmt)
