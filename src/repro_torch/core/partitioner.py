"""Data partitioning (paper Section IV-C + Algorithm 9).

Chooses (N1, N2) so that
  (1) every kernel exposes >= eta * N_CC tasks        (load balance),
  (2) partitions fit the on-chip (VMEM) budget        (memory capacity),
  (3) N1, N2 are as large as possible                 (locality),
with N1, N2 power-of-two multiples of the hardware tile (128 on TPU; the
paper's FPGA uses p_sys-aligned sizes).

Aggregate tasks:  T_a = (|V| * f1) / (N1 * N2)   (Algorithm 2, lines 2-3)
Update tasks:     T_u = (|V| * f2) / (N2 * N2)   (Algorithm 3, lines 2-3)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Tuple

from repro_torch import hw
from repro_torch.core.ir import ComputationGraph, KernelIR, KernelType

ETA_DEFAULT = 4  # paper: follows GPoP; eta=1 risks idle cores


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    n1: int
    n2: int
    eta: int
    n_cc: int
    n_max: int


def _round_down_pow2(x: int, lo: int) -> int:
    if x < lo:
        return lo
    return 2 ** int(math.floor(math.log2(x)))


def max_partition_size(on_chip_bytes: int, dtype_bytes: int = 4,
                       n_buffers: int = 8, align: int = 128) -> int:
    """g(S_o) in Algorithm 9.

    A Computation Core double-buffers 4 buffers (U/O/P/Result) of N_max^2
    elements each -> 8 live partitions.  Largest aligned power-of-two N with
    n_buffers * N^2 * dtype_bytes <= S_o.
    """
    n = int(math.isqrt(on_chip_bytes // (n_buffers * dtype_bytes)))
    n = _round_down_pow2(n, align)
    return max(n, align)


def choose_partition_sizes(
    graph: ComputationGraph,
    *,
    n_cc: int,
    eta: int = ETA_DEFAULT,
    on_chip_bytes: int = hw.TPU_V5E.vmem_bytes,
    dtype_bytes: int = 4,
    align: int = 128,
) -> PartitionConfig:
    """Algorithm 9: two passes (N2 from Update kernels, N1 from Aggregate)."""
    n_max = max_partition_size(on_chip_bytes, dtype_bytes, align=align)
    target_tasks = eta * n_cc

    # ---- Step 1: N2 from Update kernels:  Q / N2^2 >= target  ----
    n2 = n_max
    for k in graph.kernels:
        if k.kernel_type != KernelType.UPDATE:
            continue
        n_prime = int(math.isqrt(max(k.workload // target_tasks, 1)))
        n_it = min(_round_down_pow2(n_prime, align), n_max)
        n2 = min(n2, n_it)
    # ---- Step 2: N1 from Aggregate kernels:  Q / (N1*N2) >= target ----
    n1 = n_max
    for k in graph.kernels:
        if k.kernel_type != KernelType.AGGREGATE:
            continue
        n_prime = max(k.workload // (target_tasks * n2), 1)
        n_it = min(_round_down_pow2(n_prime, align), n_max)
        n1 = min(n1, n_it)
    n1 = max(n1, n2)  # fibers are N1 x N2 with N1 >= N2 by construction
    return PartitionConfig(n1=n1, n2=n2, eta=eta, n_cc=n_cc, n_max=n_max)


def apply_partitioning(graph: ComputationGraph, cfg: PartitionConfig) -> None:
    """Fill each kernel's ExecutionScheme (Algorithms 2/3 task grids)."""
    for k in graph.kernels:
        m, n, d = k.matmul_dims
        if k.kernel_type in (KernelType.AGGREGATE, KernelType.ATTENTION):
            gi = _ceil_div(m, cfg.n1)
            gj = _ceil_div(n, cfg.n1)
            gk = _ceil_div(d, cfg.n2)
        else:
            gi = _ceil_div(m, cfg.n2)
            gj = _ceil_div(n, cfg.n2)
            gk = _ceil_div(d, cfg.n2)
        k.scheme.n1, k.scheme.n2 = cfg.n1, cfg.n2
        k.scheme.grid_i, k.scheme.grid_k, k.scheme.grid_j = gi, gk, gj
        k.scheme.num_tasks = gi * gk


def task_count(k: KernelIR) -> int:
    return k.scheme.num_tasks


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)
