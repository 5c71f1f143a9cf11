"""Intermediate representation (paper Section IV-A, Table II).

The compiler turns a GNN model spec + graph meta data into a *computation
graph* whose nodes are Kernel IRs (Aggregate / Update) and whose edges are
data dependencies.  Each kernel IR carries the meta data of Table II plus the
execution-scheme metadata produced by data partitioning (Algorithms 2/3/9).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class KernelType(enum.IntEnum):
    AGGREGATE = 0
    UPDATE = 1
    # element-wise epilogues are folded into the producing kernel (the FPGA
    # applies activation on the writeback path); kept for IR completeness:
    ELEMENTWISE = 2
    # masked edge-softmax over the adjacency support (GAT, DESIGN.md §17):
    # produces a (|V|, |V|) attention matrix whose sparsity is input- and
    # head-dependent -- the operand whose density the K2P planner cannot
    # know until runtime.  Not a matmul: executed by a dedicated traced
    # function (``dynasparse.attention_adjacency``) in both engines.
    ATTENTION = 3


class AggOp(enum.Enum):
    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"


class Activation(enum.Enum):
    NONE = "none"
    RELU = "relu"
    PRELU = "prelu"


@dataclasses.dataclass
class ExecutionScheme:
    """Partitioning metadata (Algorithms 2/3): the task grid of a kernel."""

    n1: int = 0                      # adjacency / fiber partition size
    n2: int = 0                      # feature / weight partition size
    grid_i: int = 0                  # output row-partition count
    grid_k: int = 0                  # output col-partition count
    grid_j: int = 0                  # reduction partition count
    num_tasks: int = 0               # grid_i * grid_k

    def as_tuple(self) -> Tuple[int, int, int]:
        return (self.grid_i, self.grid_k, self.grid_j)


@dataclasses.dataclass
class KernelIR:
    """Table II meta data for one kernel."""

    kernel_type: KernelType
    layer_id: int
    f_in: int
    f_out: int
    n_vertices: int
    n_edges: int
    agg_op: AggOp = AggOp.SUM
    activation: Activation = Activation.NONE
    activation_enabled: bool = False
    name: str = ""
    # operand bindings: names in the runtime's tensor environment
    lhs: str = ""                    # "A" for Aggregate, feature name for Update
    rhs: str = ""                    # feature name for Aggregate, weight name for Update
    out: str = ""
    # extra epilogue: residual add (GIN's (1+eps)h + agg, SAGE self path)
    epilogue_add: Optional[str] = None
    epilogue_scale: float = 1.0
    # ATTENTION kernels only: names of the per-head attention weight
    # vectors (score_ij = LeakyReLU(a_src . z_i + a_dst . z_j)), the
    # LeakyReLU negative slope, and the post-softmax absolute threshold
    # below which an attention weight is dropped to exactly zero (what
    # makes the head's effective operand density input-dependent).
    att_src: Optional[str] = None
    att_dst: Optional[str] = None
    att_slope: float = 0.2
    att_threshold: float = 0.0
    scheme: ExecutionScheme = dataclasses.field(default_factory=ExecutionScheme)

    @property
    def matmul_dims(self) -> Tuple[int, int, int]:
        """(m, n, d) of the underlying matrix product."""
        if self.kernel_type in (KernelType.AGGREGATE, KernelType.ATTENTION):
            return (self.n_vertices, self.n_vertices, self.f_in)
        return (self.n_vertices, self.f_in, self.f_out)

    @property
    def block_dims(self) -> Tuple[int, int, int]:
        """(bm, bk, bn) partition dims of one task's matmul steps.

        Aggregate (Alg. 2): A blocks N1xN1 x H fibers N1xN2 -> out N1xN2.
        Update   (Alg. 3): H subfibers N2xN2 x W blocks N2xN2 -> out N2xN2.
        Attention:          the (|V|, |V|) output is planned/profiled at the
        adjacency granularity N1xN1 (its scores read N2-wide features).
        """
        s = self.scheme
        if self.kernel_type in (KernelType.AGGREGATE, KernelType.ATTENTION):
            return (s.n1, s.n1, s.n2)
        return (s.n2, s.n2, s.n2)

    @property
    def workload(self) -> int:
        """Q in Algorithm 9: |V| * f for the kernel's output."""
        m, _, d = self.matmul_dims
        return m * d


@dataclasses.dataclass(frozen=True)
class OperandFlow:
    """Where one operand's block-density profile comes from (fused path).

    The fused whole-model executor never re-profiles an intermediate: a
    producing kernel emits its writeback profile at the repo-wide feature
    granularity (N2, N2), and each consumer reads it pooled to its own
    operand granularity.  This record is the per-kernel metadata that wires
    that chain: which tensor the operand binds to, which kernel (if any)
    produces it, the (rows, cols) block granularity this consumer plans at,
    and the row-pool factor from the producer's (N2, N2) profile.

    ``producer is None`` means a graph input (A / A_mean / H0 / weights):
    the executor profiles it in-trace once per (tensor, granularity) and
    caches the counts for every consumer.
    """

    source: str                      # IR tensor name the operand binds to
    producer: Optional[int]          # kernel index writing it; None = input
    block: Tuple[int, int]           # (rows, cols) consumer granularity
    pool_rows: int                   # row-pool factor from (N2, N2) profile
    # column-pool factor from the (N2, N2) profile.  1 for every feature
    # operand (they are N2 columns wide already); > 1 only for a produced
    # square operand consumed at the (N1, N1) adjacency granularity -- the
    # GAT attention matrix feeding its Aggregate (DESIGN.md §17).  Exact
    # for the same reason pool_rows is: counts are integers, so a two-axis
    # block sum is bitwise equal to profiling the tensor directly.
    pool_cols: int = 1


@dataclasses.dataclass
class ComputationGraph:
    """Nodes = kernel IRs, edges = data dependencies (by tensor names)."""

    kernels: List[KernelIR]
    model_name: str = ""
    graph_name: str = ""

    def topo_order(self) -> List[KernelIR]:
        """Kernels are emitted in topological order by the compiler."""
        return list(self.kernels)

    def edges(self) -> List[Tuple[int, int]]:
        produced: Dict[str, int] = {}
        out = []
        for i, k in enumerate(self.kernels):
            for dep in (k.lhs, k.rhs, k.epilogue_add):
                if dep in produced:
                    out.append((produced[dep], i))
            produced[k.out] = i
        return out

    def operand_flows(self) -> List[Tuple[OperandFlow, OperandFlow]]:
        """Per-kernel (lhs_flow, rhs_flow): the density-propagation wiring.

        Requires partitioning to have run (``scheme.n1``/``n2`` set).  For a
        produced operand the consumer granularity must be a block-multiple
        (rows AND columns) of the producer's (N2, N2) writeback profile --
        guaranteed by Algorithm 9 (N1 and N2 are power-of-two multiples of
        the alignment with N1 >= N2, so N2 divides N1 on both axes) and
        asserted here so a future scheme change fails loudly instead of
        silently mis-planning.  Feature operands pool rows only
        (``pool_cols == 1``); the GAT attention matrix consumed at
        (N1, N1) pools both axes.
        """
        produced: Dict[str, int] = {}
        flows: List[Tuple[OperandFlow, OperandFlow]] = []
        for i, k in enumerate(self.kernels):
            bm, bk, bn = k.block_dims
            n2 = k.scheme.n2
            pair = []
            for name, blk in ((k.lhs, (bm, bk)), (k.rhs, (bk, bn))):
                prod = produced.get(name)
                pool = cpool = 1
                if prod is not None:
                    assert blk[0] % n2 == 0 and blk[1] % n2 == 0, (
                        f"kernel {k.name}: operand {name} consumed at {blk} "
                        f"cannot chain from the (N2={n2}, N2) profile")
                    pool, cpool = blk[0] // n2, blk[1] // n2
                pair.append(OperandFlow(source=name, producer=prod,
                                        block=blk, pool_rows=pool,
                                        pool_cols=cpool))
            flows.append((pair[0], pair[1]))
            produced[k.out] = i
        return flows

    def __len__(self) -> int:
        return len(self.kernels)
