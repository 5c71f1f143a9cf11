"""Analytical performance models for primitive selection (paper Table IV).

Port of ``repro.core.perf_model``.  The same two models, with the same
formulas, so the planner makes the same decisions as the reference:

* :class:`FPGACostModel` -- Table IV verbatim, parameterized on ``p_sys``.
* :class:`TPUCostModel` -- the reference's tile-density adaptation, whose
  constants are the TPU's (``hw.TPU_V5E``).  It is kept because the
  reference planner uses it; it does not model the GPU.

``cycles`` accepts host numpy arrays (report bookkeeping, in
float64) or torch tensors; ``select_traced`` and ``select_format_traced``
take float32 tensors on any device and keep the reference's float32
operation order.  A divisor that is a Python number is first made a tensor
on the operand's device: CUDA's true division by a host scalar multiplies
by its reciprocal, which rounds differently and would move decisions that
sit on a threshold.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Union

import numpy as np
import torch

from repro_torch import hw

ArrayLike = Union[float, np.ndarray, torch.Tensor]


class Primitive(enum.IntEnum):
    """Computation primitives.  Order matters: it is the dispatch code."""

    SKIP = 0     # alpha_min == 0: the product of an all-zero operand is zero
    GEMM = 1     # dense x dense
    SPDMM = 2    # sparse x dense (skip zeros of the sparser operand)
    SPMM = 3     # sparse x sparse (skip zeros of both operands)


class Format(enum.IntEnum):
    """Execution formats for a kernel's sparse operand.

    DENSE keeps the block path (GEMM/SpDMM/SPMM per task); CSR converts the
    sparse lhs on the fly (D2S) and runs the row-gather SPMM instead.
    """

    DENSE = 0
    CSR = 1


def _is_t(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def _minimum(a, b):
    return torch.minimum(a, b) if _is_t(a, b) else np.minimum(a, b)


def _maximum(a, b):
    return torch.maximum(a, b) if _is_t(a, b) else np.maximum(a, b)


def _div(a, b):
    """``a / b`` with a Python-number divisor turned into a device tensor
    (IEEE division on every device, see the module docstring)."""
    if isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a / b


@dataclasses.dataclass(frozen=True)
class FPGACostModel:
    """Paper Table IV.  Costs are in accelerator clock cycles.

    GEMM:  p^2 MACs/cycle             -> m*n*d / p^2
    SpDMM: p^2/2 MACs/cycle, skips the sparser operand's zeros
                                      -> 2 * a_min * m*n*d / p^2
    SPMM:  p MACs/cycle, skips both   -> a_x * a_y * m*n*d / p
    """

    p_sys: int = hw.ALVEO_U250.p_sys
    freq_hz: float = hw.ALVEO_U250.freq_hz

    def gemm_cycles(self, m, n, d) -> ArrayLike:
        return (m * n * d) / (self.p_sys ** 2)

    def spdmm_cycles(self, m, n, d, a_x, a_y) -> ArrayLike:
        a_min = _minimum(a_x, a_y)
        return 2.0 * a_min * (m * n * d) / (self.p_sys ** 2)

    def spmm_cycles(self, m, n, d, a_x, a_y) -> ArrayLike:
        return a_x * a_y * (m * n * d) / self.p_sys

    def cycles(self, primitive: Primitive, m, n, d, a_x, a_y) -> ArrayLike:
        if primitive == Primitive.SKIP:
            return 0.0 * (a_x + a_y)
        if primitive == Primitive.GEMM:
            return self.gemm_cycles(m, n, d) + 0.0 * (a_x + a_y)
        if primitive == Primitive.SPDMM:
            return self.spdmm_cycles(m, n, d, a_x, a_y)
        if primitive == Primitive.SPMM:
            return self.spmm_cycles(m, n, d, a_x, a_y)
        raise ValueError(f"unknown primitive {primitive}")

    def select_traced(self, a_x: torch.Tensor, a_y: torch.Tensor
                      ) -> torch.Tensor:
        """Vectorized Algorithm 7 on tensors: int32 Primitive codes."""
        a_min = torch.minimum(a_x, a_y)
        a_max = torch.maximum(a_x, a_y)
        spdmm = torch.full_like(a_min, int(Primitive.SPDMM), dtype=torch.int32)
        spmm = torch.full_like(spdmm, int(Primitive.SPMM))
        out = torch.where(a_max >= 2.0 / self.p_sys, spdmm, spmm)
        out = torch.where(a_min >= 0.5, int(Primitive.GEMM), out)
        return torch.where(a_min == 0.0, int(Primitive.SKIP), out).to(
            torch.int32)


@dataclasses.dataclass(frozen=True)
class TPUCostModel:
    """The reference's TPU adaptation of Table IV, over *tile* densities.

    GEMM is a roofline over the full block; SpDMM scales compute with the
    sparser operand's tile density ``b_min``; SPMM with ``b_x * b_y``.
    ``select_traced`` picks the argmin of predicted seconds (ties go GEMM < SpDMM
    < SPMM), SKIP when ``b_min == 0``.  All constants are the reference's.
    """

    spec: hw.TPUSpec = hw.TPU_V5E
    dtype_bytes: int = 2
    eff_gemm: float = 1.00
    eff_spdmm: float = 0.88
    eff_spmm: float = 0.72
    launch_overhead_s: float = 2e-6
    eff_csr: float = 0.45
    eff_transform: float = 1e-3
    transform_overhead_s: float = 2e-5
    csr_fill_slack: float = 3.0

    def _roofline_seconds(self, flops, bytes_moved, eff) -> ArrayLike:
        t_compute = _div(flops, self.spec.peak_bf16_flops * eff)
        t_memory = _div(bytes_moved, self.spec.hbm_bandwidth)
        return _maximum(t_compute, t_memory) + self.launch_overhead_s

    def gemm_seconds(self, m, n, d) -> ArrayLike:
        flops = 2.0 * m * n * d
        bytes_moved = (m * n + n * d + m * d) * self.dtype_bytes
        return self._roofline_seconds(flops, bytes_moved, self.eff_gemm)

    def spdmm_seconds(self, m, n, d, b_x, b_y) -> ArrayLike:
        b_min = _minimum(b_x, b_y)
        flops = 2.0 * b_min * m * n * d
        # the two constant terms are summed first: XLA folds
        # (x + n*d) + m*d into x + (n*d + m*d) in the reference's compiled
        # planner, and the two orders round differently in float32
        bytes_moved = (b_min * m * n + (n * d + m * d)) * self.dtype_bytes
        return self._roofline_seconds(flops, bytes_moved, self.eff_spdmm)

    def spmm_seconds(self, m, n, d, b_x, b_y) -> ArrayLike:
        flops = 2.0 * b_x * b_y * m * n * d
        bytes_moved = (b_x * m * n + b_y * n * d + m * d) * self.dtype_bytes
        return self._roofline_seconds(flops, bytes_moved, self.eff_spmm)

    def seconds(self, primitive: Primitive, m, n, d, b_x, b_y) -> ArrayLike:
        if primitive == Primitive.SKIP:
            return 0.0 * (b_x + b_y)
        if primitive == Primitive.GEMM:
            return self.gemm_seconds(m, n, d) + 0.0 * (b_x + b_y)
        if primitive == Primitive.SPDMM:
            return self.spdmm_seconds(m, n, d, b_x, b_y)
        if primitive == Primitive.SPMM:
            return self.spmm_seconds(m, n, d, b_x, b_y)
        raise ValueError(f"unknown primitive {primitive}")

    def cycles(self, primitive, m, n, d, b_x, b_y):
        return self.seconds(primitive, m, n, d, b_x, b_y)

    def select_traced(self, b_x: torch.Tensor, b_y: torch.Tensor,
                      m=128, n=128, d=128) -> torch.Tensor:
        """First-minimum argmin over (GEMM, SpDMM, SPMM), written as strict
        ``<`` comparisons so ties resolve to the earlier primitive on every
        device."""
        shape = torch.broadcast_shapes(b_x.shape, b_y.shape)
        # the GEMM cost is a host float64 number rounded once to float32,
        # as the reference's broadcast of it is
        best_cost = torch.full(shape, float(self.gemm_seconds(m, n, d)),
                               dtype=torch.float32, device=b_x.device)
        best = torch.full(shape, int(Primitive.GEMM), dtype=torch.int32,
                          device=b_x.device)
        for prim, cost in ((Primitive.SPDMM,
                            self.spdmm_seconds(m, n, d, b_x, b_y)),
                           (Primitive.SPMM,
                            self.spmm_seconds(m, n, d, b_x, b_y))):
            cost = torch.broadcast_to(cost, shape)
            better = cost < best_cost
            best = torch.where(better, int(prim), best)
            best_cost = torch.where(better, cost, best_cost)
        return torch.where(torch.minimum(b_x, b_y) == 0.0,
                           int(Primitive.SKIP), best).to(torch.int32)

    # -- format selection (row-CSR vs the block path) ------------------------

    def csr_spmm_seconds(self, m, n, d, rmax) -> ArrayLike:
        flops = 2.0 * m * rmax * d
        bytes_moved = (m * rmax * (4 + self.dtype_bytes)
                       + m * rmax * d * self.dtype_bytes
                       + m * d * self.dtype_bytes)
        return self._roofline_seconds(flops, bytes_moved, self.eff_csr)

    def transform_seconds(self, m, n, rmax) -> ArrayLike:
        bytes_moved = (m * n * self.dtype_bytes
                       + m * rmax * (4 + self.dtype_bytes))
        return (bytes_moved / (self.spec.hbm_bandwidth * self.eff_transform)
                + self.transform_overhead_s)

    def select_format_traced(self, m, n, d, block_dims, nnz: torch.Tensor,
                             occupied_steps: torch.Tensor, rmax
                             ) -> torch.Tensor:
        """CSR wins only when conversion plus gather execution beat the
        block path's occupied reduction steps AND the predicted max row
        fill fits ``rmax``.  Returns a () int32 Format code on the device."""
        bm, bk, bn_ = block_dims
        block_s = occupied_steps * self.gemm_seconds(bm, bk, bn_)
        csr_s = self.transform_seconds(m, n, rmax) + self.csr_spmm_seconds(
            m, n, d, rmax)
        fits = nnz * self.csr_fill_slack <= rmax * m
        return ((csr_s < block_s) & fits).to(torch.int32)
