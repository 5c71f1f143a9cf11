"""Compiler (paper Section IV): GNN model spec + graph meta -> optimized IR.

Step 1 parses the model into a computation graph of Aggregate/Update kernels
(Fig. 10 layer IRs); Step 2 runs data partitioning (Algorithm 9) and attaches
execution schemes (Algorithms 2/3).  It also pre-profiles the compile-time-
known densities (A, W, H^0) with counters, exactly as the paper's compiler
does -- intermediate feature densities are left to the runtime profiler.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import partitioner
from repro_torch.core.ir import (Activation, AggOp, ComputationGraph, ExecutionScheme,
                           KernelIR, KernelType)
from repro_torch.core.profiler import SparsityStats


@dataclasses.dataclass
class GraphMeta:
    """Meta data of the input graph (paper Table II inputs)."""

    name: str
    n_vertices: int
    n_edges: int
    f_in: int


@dataclasses.dataclass
class GNNModelSpec:
    """User-level model definition (the paper takes PyG specs; we take this)."""

    model: str                       # gcn | sage | gin | sgc | gat
    layer_dims: List[int]            # [f_in, hidden, ..., f_out]
    agg_op: AggOp = AggOp.SUM
    activation: Activation = Activation.RELU
    sgc_hops: int = 2                # K for SGC
    gin_eps: float = 0.0
    # GAT only (DESIGN.md §17).  Heads are summed (not concatenated) so
    # ``layer_dims`` keeps its meaning; the threshold is the post-softmax
    # cutoff below which an attention weight is dropped to exactly zero,
    # which is what makes each head's operand density input-dependent.
    gat_heads: int = 2
    att_slope: float = 0.2
    att_threshold: float = 0.02

    @property
    def n_layers(self) -> int:
        return len(self.layer_dims) - 1


@dataclasses.dataclass
class CompiledModel:
    graph: ComputationGraph
    partition: partitioner.PartitionConfig
    static_stats: Dict[str, SparsityStats]   # densities known at compile time
    compile_seconds: float


def _agg(layer: int, f: int, meta: GraphMeta, src: str, dst: str,
         op: AggOp, act: Activation = Activation.NONE,
         act_on: bool = False, **kw) -> KernelIR:
    return KernelIR(KernelType.AGGREGATE, layer, f, f, meta.n_vertices,
                    meta.n_edges, agg_op=op, activation=act,
                    activation_enabled=act_on,
                    name=f"l{layer}.agg", lhs="A", rhs=src, out=dst, **kw)


def _upd(layer: int, f_in: int, f_out: int, meta: GraphMeta, src: str,
         w: str, dst: str, act: Activation = Activation.NONE,
         act_on: bool = False, **kw) -> KernelIR:
    return KernelIR(KernelType.UPDATE, layer, f_in, f_out, meta.n_vertices,
                    meta.n_edges, activation=act, activation_enabled=act_on,
                    name=f"l{layer}.upd.{w}", lhs=src, rhs=w, out=dst, **kw)


def build_computation_graph(spec: GNNModelSpec, meta: GraphMeta) -> ComputationGraph:
    """Fig. 10: per-layer kernel IRs for GCN / GraphSAGE / GIN / SGC / GAT.

    Kernel ordering inside a GCN layer follows the cheaper association:
    when f_in > f_out we transform first (Update -> Aggregate) -- the paper's
    GCN discussion ("the first Update(H0, W1) kernel of GCN") confirms this
    ordering; otherwise Aggregate -> Update.
    """
    ks: List[KernelIR] = []
    act = spec.activation
    h = "H0"
    model = spec.model.lower()
    L = spec.n_layers
    for l in range(1, L + 1):
        f_in, f_out = spec.layer_dims[l - 1], spec.layer_dims[l]
        last = l == L
        if model == "gcn":
            if f_in > f_out:
                ks.append(_upd(l, f_in, f_out, meta, h, f"W{l}", f"Z{l}"))
                ks.append(_agg(l, f_out, meta, f"Z{l}", f"H{l}", spec.agg_op,
                               act, act_on=not last))
            else:
                ks.append(_agg(l, f_in, meta, h, f"Z{l}", spec.agg_op))
                ks.append(_upd(l, f_in, f_out, meta, f"Z{l}", f"W{l}", f"H{l}",
                               act, act_on=not last))
        elif model == "sage":
            # h' = act(W_self h + W_neigh * mean_agg(h))
            ks.append(_agg(l, f_in, meta, h, f"N{l}", AggOp.MEAN))
            ks.append(_upd(l, f_in, f_out, meta, h, f"Wself{l}", f"S{l}"))
            ks.append(_upd(l, f_in, f_out, meta, f"N{l}", f"Wneigh{l}", f"H{l}",
                           act, act_on=not last, epilogue_add=f"S{l}"))
        elif model == "gin":
            # h' = MLP((1 + eps) h + sum_agg(h)); 2-layer MLP
            ks.append(_agg(l, f_in, meta, h, f"N{l}", AggOp.SUM,
                           epilogue_add=h, epilogue_scale=1.0 + spec.gin_eps))
            ks.append(_upd(l, f_in, f_out, meta, f"N{l}", f"Wa{l}", f"M{l}",
                           act, act_on=True))
            ks.append(_upd(l, f_out, f_out, meta, f"M{l}", f"Wb{l}", f"H{l}",
                           act, act_on=not last))
        elif model == "gat":
            # Per head h: Z = h W_h (Update); T = edge-softmax over the
            # adjacency support with per-head scores, thresholded
            # (Attention); out = T Z (Aggregate).  Heads are summed via the
            # epilogue-add chain; the last head applies the activation and
            # writes H{l}.  Each head's T has its own runtime density, so
            # the fused walk plans a distinct (primitive, format) grid per
            # head from the propagated writeback profiles (DESIGN.md §17).
            prev = None
            for hd in range(1, spec.gat_heads + 1):
                z, t = f"Z{l}h{hd}", f"T{l}h{hd}"
                ks.append(_upd(l, f_in, f_out, meta, h, f"Wg{l}h{hd}", z))
                ks.append(KernelIR(
                    KernelType.ATTENTION, l, f_out, f_out, meta.n_vertices,
                    meta.n_edges, name=f"l{l}.att.h{hd}", lhs="A", rhs=z,
                    out=t, att_src=f"a_src{l}h{hd}", att_dst=f"a_dst{l}h{hd}",
                    att_slope=spec.att_slope,
                    att_threshold=spec.att_threshold))
                last_head = hd == spec.gat_heads
                dst = f"H{l}" if last_head else f"G{l}h{hd}"
                ks.append(KernelIR(
                    KernelType.AGGREGATE, l, f_out, f_out, meta.n_vertices,
                    meta.n_edges, agg_op=AggOp.SUM,
                    activation=act, activation_enabled=last_head and not last,
                    name=f"l{l}.agg.h{hd}", lhs=t, rhs=z, out=dst,
                    epilogue_add=prev))
                prev = dst
        elif model == "sgc":
            # SGC collapses to A^K H W with no inter-hop nonlinearity;
            # emitted as K Aggregates (first layer only) + one Update.
            if l == 1:
                hop_src = h
                for hop in range(1, spec.sgc_hops + 1):
                    ks.append(_agg(l, f_in, meta, hop_src, f"P{hop}", spec.agg_op))
                    hop_src = f"P{hop}"
                ks.append(_upd(l, f_in, f_out, meta, hop_src, f"W{l}", f"H{l}",
                               act, act_on=not last))
            else:
                ks.append(_upd(l, f_in, f_out, meta, h, f"W{l}", f"H{l}",
                               act, act_on=not last))
        else:
            raise ValueError(f"unknown GNN model {spec.model!r}")
        h = f"H{l}"
    return ComputationGraph(ks, model_name=model, graph_name=meta.name)


def compile_model(
    spec: GNNModelSpec,
    meta: GraphMeta,
    *,
    n_cc: int,
    tensors: Optional[Dict[str, np.ndarray]] = None,
    eta: int = partitioner.ETA_DEFAULT,
    on_chip_bytes: Optional[int] = None,
    align: int = 128,
) -> CompiledModel:
    """Full compilation: IR -> partitioning -> static sparsity profiling."""
    t0 = time.perf_counter()
    graph = build_computation_graph(spec, meta)
    kwargs = dict(n_cc=n_cc, eta=eta, align=align)
    if on_chip_bytes is not None:
        kwargs["on_chip_bytes"] = on_chip_bytes
    cfg = partitioner.choose_partition_sizes(graph, **kwargs)
    partitioner.apply_partitioning(graph, cfg)
    static_stats: Dict[str, SparsityStats] = {}
    if tensors:
        for name, arr in tensors.items():
            # convention: adjacency at (N1, N1); everything else (weights,
            # features) at (N2, N2) -- Aggregate consumers pool rows to N1.
            block = (cfg.n1, cfg.n1) if name.startswith("A") else (cfg.n2, cfg.n2)
            static_stats[name] = SparsityStats.measure(arr, block)
    dt = time.perf_counter() - t0
    return CompiledModel(graph, cfg, static_stats, dt)
