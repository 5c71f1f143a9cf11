"""Runtime Analyzer: kernel-to-primitive mapping for every strategy.

Port of ``repro.core.analyzer``.  :func:`plan_codes` is the planner: the
(I, J, K) primitive-code grid for all four mapping strategies -- ``dynamic``
(Algorithm 7), ``s1`` (HyGCN/BoostGCN), ``s2`` (AWB-GCN), ``gemm`` (dense
lower bound).  It runs on the density tensors' device, so the executor
plans on the GPU with no host round trip; :func:`plan_format` is the
format half of the decision.  :func:`task_costs_host` is the numpy
bookkeeping the engines' reports use.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ir import KernelType
from repro_torch.core.perf_model import Primitive

CostModel = object  # FPGACostModel | TPUCostModel (duck-typed)

STRATEGIES = ("dynamic", "s1", "s2", "gemm")


def static_primitive(strategy: str,
                     kernel_type: Optional[KernelType]) -> Primitive:
    """The fixed primitive of a static strategy (s1/s2/gemm)."""
    if strategy == "s1":
        if kernel_type is None:
            raise ValueError("strategy 's1' maps by kernel type; pass one")
        return (Primitive.SPDMM if kernel_type == KernelType.AGGREGATE
                else Primitive.GEMM)
    if strategy == "s2":
        return Primitive.SPDMM
    if strategy == "gemm":
        return Primitive.GEMM
    raise ValueError(f"unknown strategy {strategy!r}")


def plan_codes(strategy: str, dens_x: torch.Tensor, dens_y: torch.Tensor,
               model: CostModel, *,
               kernel_type: Optional[KernelType] = None) -> torch.Tensor:
    """K2P decision grid: (I, K) x (K, J) -> (I, J, K) int32 Primitive codes.

    Decision (i, j, k) maps the reduction step X[i,k] @ Y[k,j].  Static
    strategies ignore the densities and never emit SKIP.
    """
    I, K = dens_x.shape
    J = dens_y.shape[1]
    if strategy != "dynamic":
        prim = static_primitive(strategy, kernel_type)
        return torch.full((I, J, K), int(prim), dtype=torch.int32,
                          device=dens_x.device)
    ax = dens_x[:, None, :].expand(I, J, K)
    ay = dens_y.T[None].expand(I, J, K)
    # elementwise ops on expanded views may keep their strides; the
    # dispatch kernel reads the grid row-major
    return model.select_traced(ax, ay).contiguous()


def plan_codes_from_profiles(strategy: str, prof_x, prof_y, model: CostModel,
                             *, kernel_type: Optional[KernelType] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K2P planning from propagated writeback profiles, not operands.

    Returns ``(codes, dens_x, dens_y)``.
    """
    dens_x = prof_x.densities()
    dens_y = prof_y.densities()
    codes = plan_codes(strategy, dens_x, dens_y, model,
                       kernel_type=kernel_type)
    return codes, dens_x, dens_y


def plan_format(strategy: str, dens_x: torch.Tensor, dens_y: torch.Tensor,
                lhs_shape: Tuple[int, int], rhs_cols: int,
                block_dims: Tuple[int, int, int], model: CostModel, *,
                kernel_type: Optional[KernelType] = None,
                rmax: int = 0) -> Optional[torch.Tensor]:
    """The format half of the (primitive, format) K2P decision.

    ``None`` when the kernel is statically dense (static strategy,
    non-Aggregate kernel, ``rmax <= 0``, or a cost model without format
    costs); otherwise a () int32 ``Format`` code on the densities' device.
    """
    if rmax <= 0 or strategy != "dynamic":
        return None
    if kernel_type != KernelType.AGGREGATE:
        return None
    if not hasattr(model, "select_format_traced"):
        return None
    m, k = lhs_shape
    bm, bk, _ = block_dims
    I, K = dens_x.shape
    rows = np.clip(m - bm * np.arange(I), 0, bm)
    cols = np.clip(k - bk * np.arange(K), 0, bk)
    elems = torch.from_numpy(np.outer(rows, cols).astype(np.float32)).to(
        dens_x.device)
    nnz = torch.sum(dens_x * elems)
    ax = dens_x[:, None, :]
    ay = dens_y.T[None]
    occupied = torch.sum((ax > 0) & (ay > 0))
    return model.select_format_traced(m, k, rhs_cols, block_dims, nnz,
                                      occupied, rmax)


def task_costs(codes: np.ndarray, dens_x: np.ndarray, dens_y: np.ndarray,
               block_dims: Tuple[int, int, int], model: CostModel
               ) -> np.ndarray:
    """Per-task predicted cost (I, J) in float64 numpy: Table IV cost summed
    over the K reduction steps under each step's selected primitive."""
    bm, bk, bn = block_dims
    ax = np.asarray(dens_x, dtype=np.float64)[:, None, :]
    ay = np.swapaxes(np.asarray(dens_y, dtype=np.float64), 0, 1)[None]
    ax, ay = np.broadcast_arrays(ax, ay)
    step = np.where(
        codes == Primitive.GEMM,
        model.cycles(Primitive.GEMM, bm, bk, bn, ax, ay),
        np.where(
            codes == Primitive.SPDMM,
            model.cycles(Primitive.SPDMM, bm, bk, bn, ax, ay),
            np.where(
                codes == Primitive.SPMM,
                model.cycles(Primitive.SPMM, bm, bk, bn, ax, ay),
                0.0)))
    return step.sum(axis=2)


def task_costs_host(codes: np.ndarray, dens_x: np.ndarray,
                    dens_y: np.ndarray, block_dims: Tuple[int, int, int],
                    model: CostModel, *, chunk_elems: float = 2e6
                    ) -> np.ndarray:
    """Chunked :func:`task_costs` (bounds the broadcast temporaries)."""
    I, J, K = codes.shape
    costs = np.empty((I, J), np.float64)
    chunk = max(1, int(chunk_elems / max(J * K, 1)))
    for i0 in range(0, I, chunk):
        i1 = min(i0 + chunk, I)
        costs[i0:i1] = task_costs(codes[i0:i1], dens_x[i0:i1], dens_y,
                                  block_dims, model)
    return costs
