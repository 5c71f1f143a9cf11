"""GNN models (GCN / GraphSAGE / GIN / SGC / GAT) through the Dynasparse
stack.

Port of ``repro.models.gnn``: the model IS its IR (``core.compiler``);
this module wires weights and datasets into an engine-ready bundle.
Weights, GAT's per-head attention vectors included, are drawn with numpy
from the same seed and in the same order as the reference, so
:func:`init_weights` is bitwise the reference's.  :func:`build_sim` is
the cost-model bundle at full Table VI scale: block statistics generated
on the host, planned on the device by ``SimGNN.simulate``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compiler, runtime
from repro_torch.core.compiler import CompiledModel, GNNModelSpec, GraphMeta
from repro_torch.core.ir import AggOp, KernelType
from repro_torch.core.profiler import SparsityStats
from repro_torch.data import graphs as graph_data
from repro_torch.device import DeviceLike, resolve

GNN_MODELS = ("gcn", "sage", "gin", "sgc", "gat")


def make_model_spec(model: str, f_in: int, hidden: int, n_classes: int
                    ) -> GNNModelSpec:
    """The paper's 2-layer models (Section VIII-A)."""
    agg = AggOp.MEAN if model == "sage" else AggOp.SUM
    dims = [f_in, n_classes] if model == "sgc" else [f_in, hidden, n_classes]
    return GNNModelSpec(model, dims, agg_op=agg)


def _glorot_pruned(kernels, *, seed: int, density: float
                   ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for k in kernels:
        if k.kernel_type == KernelType.ATTENTION:
            # per-head attention vectors (f, 1), glorot, never pruned;
            # drawn where the reference draws them, so the rng stream and
            # every weight stay identical
            for name in (k.att_src, k.att_dst):
                if name in out:
                    continue
                lim = np.sqrt(6.0 / (k.f_in + 1))
                out[name] = rng.uniform(
                    -lim, lim, size=(k.f_in, 1)).astype(np.float32)
            continue
        if k.kernel_type != KernelType.UPDATE or k.rhs in out:
            continue
        lim = np.sqrt(6.0 / (k.f_in + k.f_out))
        w = rng.uniform(-lim, lim, size=(k.f_in, k.f_out)).astype(np.float32)
        out[k.rhs] = graph_data.prune_weights(w, density, rng)
    return out


def init_weights(compiled: CompiledModel, *, seed: int = 0,
                 density: float = 1.0) -> Dict[str, np.ndarray]:
    """Glorot weights for every Update kernel, magnitude-pruned to
    ``density``, and GAT's attention vectors (never pruned)."""
    return _glorot_pruned(compiled.graph.kernels, seed=seed, density=density)


def init_spec_weights(spec: GNNModelSpec, *, seed: int = 0,
                      density: float = 1.0) -> Dict[str, np.ndarray]:
    """Weights for a model SPEC, independent of any concrete graph (bitwise
    equal to :func:`init_weights` on any compile of the same spec)."""
    meta = GraphMeta(spec.model, 1, 1, spec.layer_dims[0])
    graph = compiler.build_computation_graph(spec, meta)
    return _glorot_pruned(graph.kernels, seed=seed, density=density)


def tensors_from_reference(tensors: Dict[str, np.ndarray],
                           device: DeviceLike = None
                           ) -> Dict[str, torch.Tensor]:
    """Carry a bundle's host arrays (``A``, ``A_mean``, ``H0`` and the
    weights, e.g. ``np.asarray`` of the reference bundle's) into the port
    as float32 tensors on ``device``."""
    dev = resolve(device)
    return {name: torch.from_numpy(np.array(arr, dtype=np.float32)).to(dev)
            for name, arr in tensors.items()}


@dataclasses.dataclass
class DenseGNN:
    """Engine-ready bundle on a materialized graph."""

    compiled: CompiledModel
    tensors: Dict[str, torch.Tensor]
    graph: graph_data.DenseGraph

    def run(self, engine=None, *, strategy: Optional[str] = None
            ) -> Tuple[torch.Tensor, runtime.InferenceReport]:
        """One inference through ``engine`` (a :class:`runtime.
        DynasparseEngine` or :class:`runtime.FusedModelExecutor`); pass
        ``strategy`` as a shortcut for ``DynasparseEngine(strategy=...)``."""
        if engine is None:
            engine = runtime.DynasparseEngine(strategy=strategy or "dynamic")
        elif strategy is not None and strategy != engine.strategy:
            raise ValueError(
                f"strategy {strategy!r} conflicts with engine "
                f"strategy {engine.strategy!r}")
        env, rep = engine.run(self.compiled, self.tensors)
        return env[self.compiled.graph.kernels[-1].out], rep


def build_dense(model: str, dataset: str, *, scale: float = 0.25,
                n_cc: int = 7, weight_density: float = 1.0, seed: int = 0,
                on_chip_bytes: Optional[int] = None, align: int = 16,
                device: DeviceLike = None) -> DenseGNN:
    """Materialize a (scaled) dataset, compile, init weights, all on
    ``device`` (the GPU unless the caller asks for the CPU)."""
    dev = resolve(device)
    g = graph_data.materialize(dataset, scale=scale, seed=seed)
    spec = make_model_spec(model, g.spec.f_in, g.spec.hidden,
                           g.spec.n_classes)
    meta = GraphMeta(dataset, g.spec.n_vertices, g.spec.n_edges, g.spec.f_in)
    tensors = tensors_from_reference(
        {"A": g.a_gcn, "A_mean": g.a_mean, "H0": g.h0}, dev)
    cm = compiler.compile_model(
        spec, meta, n_cc=n_cc, tensors=tensors, align=align,
        on_chip_bytes=on_chip_bytes or 256 * 1024)
    weights = init_weights(cm, seed=seed, density=weight_density)
    for name, w in tensors_from_reference(weights, dev).items():
        tensors[name] = w
        cm.static_stats[name] = SparsityStats.measure(
            w, (cm.partition.n2, cm.partition.n2))
    return DenseGNN(cm, tensors, g)


@dataclasses.dataclass
class SimGNN:
    """Cost-model bundle at full Table VI scale (no numerics).  ``device``
    is where ``simulate`` plans (resolved by :func:`build_sim`)."""

    compiled: CompiledModel
    stats: Dict[str, SparsityStats]
    device: DeviceLike = None

    def simulate(self, strategy: str, model=None, n_cc: Optional[int] = None
                 ) -> runtime.InferenceReport:
        return runtime.simulate_inference(self.compiled, self.stats,
                                          strategy=strategy, model=model,
                                          n_cc=n_cc, device=self.device)


def build_sim(model: str, dataset: str, *, n_cc: int = 7,
              weight_density: float = 1.0, seed: int = 0,
              relu_keep: float = 0.5, align: int = 16,
              on_chip_bytes: int = 6 * 1024 * 1024,
              device: DeviceLike = None) -> SimGNN:
    """Full-scale bundle: Alg. 9 partitioning + synthetic block stats +
    density propagation for the runtime-only intermediate features.

    Defaults model the paper's FPGA: partitions align to p_sys=16 and the
    per-core buffer budget is ~45MB/7 cores.  The bundle plans on
    ``device``: the GPU unless the caller asks for the CPU.
    """
    if model == "gat":
        raise NotImplementedError(
            "gat has no cost-model simulation path: attention sparsity is "
            "input-dependent, so there is no density to propagate -- use "
            "the real-numerics engines (build_dense / serving)")
    dev = resolve(device)
    spec_g = graph_data.TABLE_VI[dataset]
    spec = make_model_spec(model, spec_g.f_in, spec_g.hidden,
                           spec_g.n_classes)
    meta = GraphMeta(dataset, spec_g.n_vertices, spec_g.n_edges, spec_g.f_in)
    cm = compiler.compile_model(spec, meta, n_cc=n_cc, align=align,
                                on_chip_bytes=on_chip_bytes)
    p = cm.partition
    stats = graph_data.block_stats(dataset, p.n1, p.n2, seed=seed)
    for k in cm.graph.kernels:
        if k.kernel_type != KernelType.UPDATE or k.rhs in stats:
            continue
        stats.update(graph_data.weight_stats(
            [k.f_in, k.f_out], p.n2, weight_density, seed=seed,
            names=[k.rhs]))
    stats = runtime.propagate_stats(cm, stats, relu_keep=relu_keep)
    return SimGNN(cm, stats, dev)
