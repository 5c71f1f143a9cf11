"""Runtime Analyzer: kernel-to-primitive mapping for every strategy.

Port of ``repro.core.analyzer``.  :func:`plan_codes` is the planner: the
(I, J, K) primitive-code grid for all four mapping strategies -- ``dynamic``
(Algorithm 7), ``s1`` (HyGCN/BoostGCN), ``s2`` (AWB-GCN), ``gemm`` (dense
lower bound).  It runs on the density tensors' device, so the executor
plans on the GPU with no host round trip; :func:`plan_format` is the
format half of the decision.  :func:`delta_replan_mask` re-selects only
the cells a streaming edge delta touched, host numpy in and out.
:func:`task_costs_host` is the numpy bookkeeping the engines' reports use.

The cost simulator's planner, :func:`plan_kernel_host`, takes host numpy
densities, plans on a device with :func:`plan_codes` and costs the codes
in float64 numpy.  :func:`plan_task` / :func:`plan_kernel` are the
per-task scalar form of Algorithm 7 on the host (``model.select``).
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.ir import KernelType
from repro_torch.core.perf_model import Primitive
from repro_torch.device import DeviceLike, resolve

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
               kernel_type: Optional[KernelType] = None,
               source_order: bool = False) -> torch.Tensor:
    """K2P decision grid: (I, K) x (K, J) -> (I, J, K) int32 Primitive codes.

    Decision (i, j, k) maps the reduction step X[i,k] @ Y[k,j].  Static
    strategies ignore the densities and never emit SKIP.  The engines plan
    in the reference's compiled float32 order; ``source_order=True`` takes
    the order as written, as the reference's simulator plans
    (``model.select_traced``).
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
    return model.select_traced(ax, ay, source_order=source_order).contiguous()


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


def delta_replan_mask(strategy: str, old_dens_x: np.ndarray,
                      new_dens_x: np.ndarray, dens_y: np.ndarray,
                      model: CostModel, *,
                      touched: Optional[np.ndarray] = None) -> np.ndarray:
    """Which lhs cells a streaming graph delta forces to REPLAN.

    Returns the (I, K) bool numpy mask of lhs blocks whose K2P decision
    against at least one rhs block changed between the old and new (I, K)
    densities (the rhs (K, J) densities are unchanged) -- the density
    crossed a primitive boundary.  :func:`plan_codes` is a pure function of
    the density pair, so re-selecting only the ``touched`` cells (the
    incremental profile patch's mask,
    ``data.sampling.AdjacencyBlockProfile.apply_delta``; default: the
    cells whose density changed) reproduces the diff of two full replans.
    The selection runs on float32 CPU tensors of the touched cells only
    (float64 inputs are rounded to float32 first, as the reference's jnp
    does).  Static strategies never consult densities: empty mask (the
    reference's unused ``kernel_type`` argument is left out).
    """
    old = np.asarray(old_dens_x)
    new = np.asarray(new_dens_x)
    if touched is None:
        touched = old != new
    out = np.zeros(old.shape, bool)
    if strategy != "dynamic" or not np.any(touched):
        return out
    ti, tk = np.nonzero(touched)
    ay = torch.from_numpy(np.asarray(dens_y, np.float32)[tk, :])  # (t, J)

    def codes(dens: np.ndarray) -> np.ndarray:
        ax = torch.from_numpy(dens[ti, tk].astype(np.float32))[:, None]
        return model.select_traced(ax, ay).numpy()

    out[ti, tk] = np.any(codes(old) != codes(new), axis=1)
    return out


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
    # the elements inside each block, made on the device (an upload would
    # wait for the stream); integers below 2^24, exact in float32
    dev = dens_x.device
    rows = torch.clamp(m - bm * torch.arange(I, device=dev), 0, bm)
    cols = torch.clamp(k - bk * torch.arange(K, device=dev), 0, bk)
    elems = (rows[:, None] * cols[None, :]).to(torch.float32)
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
    over the K reduction steps under each step's selected primitive.

    Each step takes its primitive's cost and SKIP (or any other code) 0.0,
    the reference's nested selection; a primitive no step selected is not
    costed at all (a static strategy costs one), which leaves every value
    as it was."""
    bm, bk, bn = block_dims
    ax = np.asarray(dens_x, dtype=np.float64)[:, None, :]
    ay = np.swapaxes(np.asarray(dens_y, dtype=np.float64), 0, 1)[None]
    ax, ay = np.broadcast_arrays(ax, ay)
    step = np.zeros(codes.shape)
    for prim in (Primitive.SPMM, Primitive.SPDMM, Primitive.GEMM):
        hit = codes == prim
        if hit.any():
            step = np.where(hit, model.cycles(prim, bm, bk, bn, ax, ay),
                            step)
    return step.sum(axis=2)


def task_costs_host(codes: np.ndarray, dens_x: np.ndarray,
                    dens_y: np.ndarray, block_dims: Tuple[int, int, int],
                    model: CostModel, *, chunk_elems: float = 2.5e5
                    ) -> np.ndarray:
    """Chunked :func:`task_costs` over output rows, in host threads when
    there is more than one chunk (numpy releases the GIL inside its
    loops).  A row's cost is the same whichever chunk computes it, so the
    chunk size, here one that keeps a chunk's temporaries in a core's
    cache, and the threads change no value."""
    I, J, K = codes.shape
    costs = np.empty((I, J), np.float64)
    chunk = max(1, int(chunk_elems / max(J * K, 1)))
    spans = [(i0, min(i0 + chunk, I)) for i0 in range(0, I, chunk)]

    def fill(span: Tuple[int, int]) -> None:
        i0, i1 = span
        costs[i0:i1] = task_costs(codes[i0:i1], dens_x[i0:i1], dens_y,
                                  block_dims, model)

    if len(spans) == 1:
        fill(spans[0])
    else:
        workers = min(len(spans), os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(fill, spans))
    return costs


def plan_kernel_host(strategy: str, dens_x: np.ndarray, dens_y: np.ndarray,
                     block_dims: Tuple[int, int, int], model: CostModel, *,
                     kernel_type: Optional[KernelType] = None,
                     chunk_elems: float = 2e6, device: DeviceLike = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Planning for one kernel from host densities: (codes (I, J, K) int32,
    costs (I, J) float64) numpy.

    Chunked over output rows as the reference chunks them, so NELL-sized
    grids bound their broadcast temporaries.  Each chunk is planned by
    :func:`plan_codes` on ``device`` (the GPU unless the caller asks for
    the CPU) from the densities rounded to float32, as the reference's
    ``jnp.asarray`` rounds them: a float64 density just below a threshold
    (0.5, ``2 / p_sys``) would pick another code.  It plans in the
    source's float32 order, as the reference's simulator (which runs
    ``plan_codes`` op by op, uncompiled) does: under the TPU model a dense
    weight makes SpDMM and SPMM tie in exact arithmetic, and the engines'
    compiled order breaks the tie the other way.  The codes come back to
    the host and are costed by :func:`task_costs_host` in float64.
    """
    dev = resolve(device)
    I, K = dens_x.shape
    J = dens_y.shape[1]
    codes = np.empty((I, J, K), np.int32)
    x32 = torch.from_numpy(np.asarray(dens_x, np.float32)).to(dev)
    y32 = torch.from_numpy(np.asarray(dens_y, np.float32)).to(dev)
    chunk = max(1, int(chunk_elems / max(J * K, 1)))
    for i0 in range(0, I, chunk):
        i1 = min(i0 + chunk, I)
        codes[i0:i1] = plan_codes(strategy, x32[i0:i1], y32, model,
                                  kernel_type=kernel_type,
                                  source_order=True).cpu().numpy()
    return codes, task_costs_host(codes, dens_x, dens_y, block_dims, model)


@dataclasses.dataclass
class TaskPlan:
    """K2P decision for one task (one output partition Z_ij)."""

    i: int
    k: int
    primitives: np.ndarray        # (K,) Primitive codes per reduction step
    sparse_is_lhs: np.ndarray     # (K,) bool: which operand goes to BufferU
    est_cost: float               # predicted cycles/seconds for the task

    @property
    def skipped(self) -> int:
        return int(np.sum(self.primitives == Primitive.SKIP))


def plan_task(model: CostModel, dens_x_row: np.ndarray,
              dens_y_col: np.ndarray, dims: Tuple[int, int, int],
              i: int = 0, k: int = 0) -> TaskPlan:
    """Algorithm 7 over all reduction steps of one task, on the host."""
    m, n, d = dims
    K = len(dens_x_row)
    prims = np.empty((K,), np.int32)
    sparse_lhs = np.zeros((K,), bool)
    cost = 0.0
    for t in range(K):
        ax, ay = float(dens_x_row[t]), float(dens_y_col[t])
        p = model.select(ax, ay)
        prims[t] = p
        # Alg. 7: the sparser operand goes to BufferU (is the gathered one)
        sparse_lhs[t] = ax <= ay
        cost += float(model.cycles(p, m, n, d, ax, ay))
    return TaskPlan(i=i, k=k, primitives=prims, sparse_is_lhs=sparse_lhs,
                    est_cost=cost)


def plan_kernel(model: CostModel, dens_x: np.ndarray, dens_y: np.ndarray,
                block_dims: Tuple[int, int, int]) -> List[TaskPlan]:
    """K2P for every task of a kernel, (I, K) x (K, J) host densities:
    O(I*J*K) scalar decisions."""
    I, K = dens_x.shape
    K2, J = dens_y.shape
    if K != K2:
        raise ValueError(f"reduction dims differ: {dens_x.shape} x "
                         f"{dens_y.shape}")
    return [
        plan_task(model, dens_x[i], dens_y[:, j], block_dims, i=i, k=j)
        for i in range(I)
        for j in range(J)
    ]


def primitive_histogram(plans: List[TaskPlan]) -> np.ndarray:
    """Counts of [SKIP, GEMM, SPDMM, SPMM] across all reduction steps."""
    hist = np.zeros((4,), np.int64)
    for p in plans:
        for v in p.primitives:
            hist[int(v)] += 1
    return hist
