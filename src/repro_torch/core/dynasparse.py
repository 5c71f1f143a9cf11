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
  whole kernel, known on the host without looking at the data, so on
  float32 operands the product runs as one ``gemm`` launch or one
  ``spdmm`` launch over the Block-CSR lhs (16x16 tiles); on bf16 operands
  the bf16 ``dispatch`` walks the strategy's constant code grid (the
  route is chosen by type, so the CPU walks it too).  Their code grids
  are still returned.

Operands are float32 or bfloat16 (the LM's FFN); the block path and the
row-CSR kernel accumulate in float32 and the result takes
``promote_types(x, y)``, as in the reference.

The planner bypasses (``codes``, ``dens_x``/``dens_y``, ``fmt``, ``ell``)
keep the reference's meaning: the fused whole-model executor plans from
propagated writeback profiles and shares one ELL view across kernels.

Gradients: where grad mode is on and x or y requires a gradient, the
``dispatch`` route runs inside :class:`BlockMatmulFn` (a float32 forward
at the kernels' block edges on ``dispatch.block_matmul_nn``), whose
backward is two ``dispatch_bwd`` launches on bf16 and float32 grids at
those edges (the operands and the code grid read in place) and otherwise
two more ``dispatch`` launches on transposed operands with the code grid
permuted: the reference's masked VJP (its ``lax.switch`` SKIP branch
returns ``acc``, so ``jax.grad`` gives no gradient through a SKIPped
block step).  Profiling, planning and the writeback counts read detached
tensors.  The other CUDA routes (float32 static ``gemm``/``spdmm``, row
CSR) have no backward and raise under grad.

:func:`attention_adjacency` is GAT's attention kernel: the masked
edge-softmax (``kernels/edge_softmax.py``, a CUDA kernel on the card)
and its writeback profile, which the kernel counts as it writes alpha,
returned as a :class:`DynasparseResult` so both engines chain it like a
matmul kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import trace
from repro_torch.core import analyzer, formats, profiler
from repro_torch.core.ir import KernelType
from repro_torch.core.perf_model import FPGACostModel, Format, Primitive
from repro_torch.kernels import csr_spmm as _csr
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels import dispatch_bwd as _bwd
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import spdmm as _spdmm

TILE = (16, 16)     # the static SpDMM route's Block-CSR tile
_NO_SPANS = trace.KernelSpans(*[None] * len(trace.KernelSpans._fields))


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


class BlockMatmulFn(torch.autograd.Function):
    """``x @ y`` through one ``dispatch`` launch over the code grid, with
    the reference's masked VJP: a block step (i, j, k) that the forward
    SKIPped adds nothing to dx[i, k] or dy[k, j], as in the reference, so
    dx is exactly 0 in a block that every step SKIPped even where the
    dense ``g @ y.T`` is not.  ``g`` is cast once to the operands' type
    (bf16 cotangents of a bf16 result are exact).

    The forward, by route (each counted under ``dispatch``): float32
    operands at a block whose edges are all in ``dispatch_bwd.EDGES``
    (the LM's (256, 256, 256)) take ``dispatch.block_matmul_nn``, the
    float32 tiled kernel of ``csrc/dispatch_bwd_f32.cu`` in its forward
    layout, bit for bit the walk's result; bf16 takes the walk's
    tensor-core route and float32 at smaller edges its FMA route
    (``dispatch.block_matmul``).  The GNN path never comes here (no
    gradient): its float32 Aggregates keep the walk that skips A's empty
    tiles.

    The backward: bf16 or float32 operands at a block whose edges are all
    in ``dispatch_bwd.EDGES`` take ``dispatch_bwd``'s two launches (the
    kernel of their type), which read x, y, g and the forward's codes in
    place (``block_matmul_nt`` for dx, ``block_matmul_tn`` for dy, each
    rounded once to the operand's type).  Anything else takes two more
    ``dispatch`` launches on transposed operands over the code grid
    permuted, with GEMM wherever the forward ran a step:

    * ``dx = block_matmul(g, y.T, run.permute(0, 2, 1), (bm, bn, bk))``
    * ``dy = block_matmul(x.T, g, run.permute(2, 1, 0), (bk, bm, bn))``

    each cut to its operand's shape and cast to its dtype."""

    @staticmethod
    def forward(ctx, x, y, codes, block):
        m, n = x.shape[0], y.shape[1]
        ctx.save_for_backward(x, y, codes)
        ctx.block = block
        if (x.dtype == y.dtype == torch.float32
                and _bwd.takes(torch.float32, block)):
            return _dispatch.block_matmul_nn(x, y, codes, block)
        return _dispatch.block_matmul(x, y, codes, block,
                                      pad_rows=False)[:m, :n]

    @staticmethod
    def backward(ctx, g):
        x, y, codes = ctx.saved_tensors
        block = ctx.block
        gy = g.to(y.dtype, memory_format=torch.contiguous_format)
        gx = gy if x.dtype == y.dtype else g.to(x.dtype)
        dx = dy = None
        if x.dtype == y.dtype and _bwd.takes(x.dtype, block):
            if ctx.needs_input_grad[0]:
                dx = _bwd.block_matmul_nt(gy, y, codes, block)
            if ctx.needs_input_grad[1]:
                dy = _bwd.block_matmul_tn(x, gy, codes, block)
            return dx, dy, None, None
        bm, bk, bn = block
        # The forward's SPDMM/SPMM codes name which FORWARD operand is
        # sparse; after the transpose it is another one.  Every non-SKIP
        # step computes the same value for finite operands, so the
        # backward grids hold GEMM wherever the forward ran a step.
        run = torch.where(codes != Primitive.SKIP, int(Primitive.GEMM),
                          int(Primitive.SKIP)).to(torch.int32)
        if ctx.needs_input_grad[0]:
            dx = _dispatch.block_matmul(
                gy, y.T, run.permute(0, 2, 1).contiguous(), (bm, bn, bk),
                pad_rows=False)
            dx = dx[:x.shape[0], :x.shape[1]].to(x.dtype)
        if ctx.needs_input_grad[1]:
            dy = _dispatch.block_matmul(
                x.T, gx, run.permute(2, 1, 0).contiguous(), (bk, bm, bn),
                pad_rows=False)
            dy = dy[:y.shape[0], :y.shape[1]].to(y.dtype)
        return dx, dy, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_backward_block(block: Tuple[int, int, int]) -> None:
    """The backward's grids are the forward's at (bm, bn, bk) and (bk, bm,
    bn); on CUDA every edge must then suit the kernel's row and column
    edges (``dispatch.BLOCK_EDGES``)."""
    if any(b not in _dispatch.BLOCK_EDGES for b in block):
        raise ValueError(f"dynasparse_matmul: block {block} has no backward "
                         "on the dispatch kernel (its permuted grids need "
                         f"every edge in {_dispatch.BLOCK_EDGES})")


def _block_path(x, y, codes, block, static, out, skip) -> torch.Tensor:
    """The float32 product through the route the strategy and the operand
    type fix: a float32 static strategy runs one ``gemm`` or ``spdmm``
    launch, anything else (bf16 static grids included) the ``dispatch``
    walk of ``codes``, through :class:`BlockMatmulFn` when a gradient is
    wanted."""
    m, n = x.shape[0], y.shape[1]
    if torch.bfloat16 in (x.dtype, y.dtype):
        static = None       # the bf16 dispatch walks the constant grid
    if static is None and out is None and _needs_grad(x, y):
        if y.is_cuda:
            _check_backward_block(block)
        return BlockMatmulFn.apply(x, y, codes, block)
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
    spans: Optional[trace.KernelSpans] = None,
) -> DynasparseResult:
    """``x @ y`` with per-(partition pair) primitive dispatch + epilogue.

    ``block = (bm, bk, bn)``: X is partitioned (bm x bk), Y (bk x bn).
    ``strategy`` picks the K2P rule (``dynamic`` runs Algorithm 7 through
    ``cost_model.select_traced``).  Epilogue: ``out += residual *
    epilogue_scale`` then ``activation`` (none/relu/prelu).  The result is
    profiled at ``out_block`` (default (bm, bn)).  With ``format_aware``
    the planner also scores row-CSR (``analyzer.plan_format``); the CSR path
    runs when CSR wins AND every row fits ``csr_rmax`` (checked on the
    device).  ``spans`` names the block path, the epilogue and the
    writeback profile after the caller's IR kernel (``repro_torch.trace``);
    without it they open no span.
    """
    m, n = x.shape[0], y.shape[1]
    bm, bk, bn = block
    names = spans or _NO_SPANS
    if dens_x is None:
        dens_x = profiler.block_density(x.detach(), (bm, bk))
    if dens_y is None:
        dens_y = profiler.block_density(y.detach(), (bk, bn))
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
        with trace.span(names.block_path):
            buf = torch.empty((I * bm, J * bn), dtype=torch.float32,
                              device=y.device)
            out = _block_path(x, y, codes, block, None, buf, use_csr)
            _csr.csr_spmm(ell.values, ell.cols, ell.row_counts,
                          y.contiguous(), out=buf, run=use_csr)
        executed_fmt = use_csr
    else:
        static = (None if strategy == "dynamic"
                  else analyzer.static_primitive(strategy, kernel_type))
        with trace.span(names.block_path):
            out = _block_path(x, y, codes, block, static, None, None)
        executed_fmt = torch.zeros((), dtype=torch.int32, device=y.device)

    with trace.span(names.epilogue):
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
    with trace.span(names.writeback):
        out_counts = profiler.block_counts(out.detach(), ob)
        out_density = profiler.density_from_counts(out_counts, m, n, *ob)
    return DynasparseResult(out, codes, dens_x, dens_y, out_density,
                            out_counts, executed_fmt)


def dynasparse_dense_equivalent(x: torch.Tensor, y: torch.Tensor
                                ) -> torch.Tensor:
    """Oracle: the dispatch NEVER changes the value, only the cost.  A
    plain float32 product (``torch.matmul``, so TF32 only if the caller
    switched it on), cast to the operands' promoted dtype."""
    return torch.matmul(x.float(), y.float()).to(
        torch.promote_types(x.dtype, y.dtype))


def attention_adjacency(
    a: torch.Tensor,
    z: torch.Tensor,
    att_src: torch.Tensor,
    att_dst: torch.Tensor,
    *,
    slope: float = 0.2,
    threshold: float = 0.0,
    out_block: Tuple[int, int] = (128, 128),
) -> DynasparseResult:
    """Thresholded masked edge-softmax over the adjacency support (GAT);
    port of ``repro.core.dynasparse.attention_adjacency``.

    ``a`` is the (n, n) adjacency (only its support matters), ``z`` the
    head's (n, f) features, ``att_src``/``att_dst`` its (f, 1) attention
    vectors.  ``out`` is alpha (``promote_types(a, z)``): rows sum to 1
    over the support before weights ``<= threshold`` drop to exactly 0,
    and all-zero rows stay zero.  ``codes`` is the degenerate one-GEMM grid
    (the kernel's cost is one dense task), ``dens_x``/``dens_y`` ones, and
    ``out_counts`` alpha's block counts at ``out_block``, which the
    edge-softmax counts as it writes alpha: what the head's Aggregate
    plans from.  Both engines call this one function, so their alpha is
    bitwise the same.
    """
    m = a.shape[0]
    dev = a.device
    alpha, out_counts = _ops.edge_softmax(a, z, att_src, att_dst,
                                          slope=slope, threshold=threshold,
                                          out_block=tuple(out_block))
    out_density = profiler.density_from_counts(out_counts, m, m, *out_block)
    one = torch.ones((1, 1), dtype=torch.float32, device=dev)
    codes = torch.full((1, 1, 1), int(Primitive.GEMM), dtype=torch.int32,
                       device=dev)
    return DynasparseResult(alpha, codes, one, one, out_density, out_counts,
                            torch.zeros((), dtype=torch.int32, device=dev))
