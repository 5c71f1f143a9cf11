"""Host-runtime engines: the soft processor's runtime system (Section VI).

Port of the single-inference engines of ``repro.core.runtime``:

* :class:`DynasparseEngine` -- one ``dynasparse_matmul`` call per kernel
  (profile -> plan -> dispatch -> epilogue -> writeback profile, all on
  the device), with a per-signature executor cache and per-kernel walls.
* :class:`FusedModelExecutor` -- the whole model as one walk: graph inputs
  are profiled once per tensor identity, every intermediate is planned
  from its producer's writeback counts (never re-profiled), and kernels
  reading the same source share one ELL view.  Its outputs are bitwise
  equal to the per-kernel engine's.

Both bring the planner's codes to the host only for the report
bookkeeping (``_bookkeep_kernel``).  Batched waves, sharded dispatch and
the cost-model simulator are not ported yet; ATTENTION kernels (GAT) raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import analyzer, formats, profiler, scheduler
from repro_torch.core.compiler import CompiledModel
from repro_torch.core.dynasparse import (DynasparseResult, dynasparse_matmul,
                                         mask_ell)
from repro_torch.core.ir import AggOp, KernelIR, KernelType
from repro_torch.core.perf_model import FPGACostModel

# instructions the soft processor spends per K2P decision (Alg. 7 is a few
# compares + buffer assignment); 500 MIPS MicroBlaze (Section VII).
_K2P_INSTRUCTIONS = 32
_SOFT_PROC_IPS = 500e6


@dataclasses.dataclass
class KernelReport:
    name: str
    num_tasks: int
    histogram: np.ndarray            # [SKIP, GEMM, SPDMM, SPMM] step counts
    makespan_cycles: float           # predicted, after Alg. 8 scheduling
    utilization: float
    k2p_seconds: float               # modeled soft-processor time
    k2p_wall_seconds: float = 0.0    # measured host bookkeeping time
    wall_seconds: float = 0.0        # host wall clock (per-kernel engine)
    dens_x: Optional[np.ndarray] = None   # (I, K) profiled lhs densities
    dens_y: Optional[np.ndarray] = None   # (K, J) profiled rhs densities


@dataclasses.dataclass
class InferenceReport:
    kernels: List[KernelReport]
    strategy: str
    # set by the fused executor: the whole walk's wall time
    fused_wall_seconds: Optional[float] = None

    @property
    def total_cycles(self) -> float:
        return float(sum(k.makespan_cycles for k in self.kernels))

    def total_seconds(self, freq_hz: float) -> float:
        return self.total_cycles / freq_hz

    @property
    def k2p_seconds(self) -> float:
        return float(sum(k.k2p_seconds for k in self.kernels))

    def k2p_exposed_seconds(self, freq_hz: float) -> float:
        """Modeled K2P time left on the critical path under layer overlap
        (kernel l+1 planned while kernel l executes)."""
        ks = self.kernels
        if not ks:
            return 0.0
        exposed = ks[0].k2p_seconds
        for prev, cur in zip(ks, ks[1:]):
            exposed += max(0.0, cur.k2p_seconds
                           - prev.makespan_cycles / freq_hz)
        return exposed

    @property
    def k2p_wall_seconds(self) -> float:
        return float(sum(k.k2p_wall_seconds for k in self.kernels))

    @property
    def wall_seconds(self) -> float:
        if self.fused_wall_seconds is not None:
            return self.fused_wall_seconds
        return float(sum(k.wall_seconds for k in self.kernels))

    @property
    def histogram(self) -> np.ndarray:
        return np.sum([k.histogram for k in self.kernels], axis=0)


def _k2p_model_seconds(num_decisions: int) -> float:
    return num_decisions * _K2P_INSTRUCTIONS / _SOFT_PROC_IPS


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


_AGG_PRE = {AggOp.SUM: "A", AggOp.MEAN: "A_mean"}


def _agg_lhs_name(k: KernelIR) -> str:
    """Env name of an Aggregate kernel's lhs operand ("A" rebinds to the
    normalization the agg op needs; a produced lhs binds by its own name)."""
    if k.lhs != "A":
        return k.lhs
    name = _AGG_PRE.get(k.agg_op)
    if name is None:
        raise NotImplementedError(
            f"{k.agg_op} aggregation is not matmul-representable")
    return name


def _no_attention(k: KernelIR) -> None:
    if k.kernel_type == KernelType.ATTENTION:
        raise NotImplementedError(
            f"kernel {k.name}: ATTENTION kernels (GAT) are not ported yet")


def _bookkeep_kernel(k: KernelIR, codes, dens_x, dens_y, n_cc: int, model
                     ) -> KernelReport:
    """Host bookkeeping from the planner's codes (the MicroBlaze's role):
    Table IV per-task costs, Alg. 8 scheduling, primitive histogram, modeled
    + measured K2P time.  The only place the codes leave the device."""
    codes = codes.cpu().numpy()
    dx = dens_x.cpu().numpy()
    dy = dens_y.cpu().numpy()
    t_plan = time.perf_counter()
    costs = analyzer.task_costs_host(codes, dx, dy, k.block_dims, model)
    sched = scheduler.schedule_dynamic(costs.reshape(-1), n_cc)
    hist = np.bincount(codes.reshape(-1), minlength=4).astype(np.int64)
    k2p_wall = time.perf_counter() - t_plan
    return KernelReport(
        name=k.name, num_tasks=int(costs.size), histogram=hist,
        makespan_cycles=sched.makespan, utilization=sched.utilization,
        k2p_seconds=_k2p_model_seconds(codes.size),
        k2p_wall_seconds=k2p_wall, dens_x=dx, dens_y=dy)


class DynasparseEngine:
    """Executes a compiled GNN one ``dynasparse_matmul`` call per kernel.

    * ``strategy`` -- one of ``analyzer.STRATEGIES``; outputs agree across
      strategies up to float rounding (dispatch changes cost, not values).
    * ``profiled_densities[out]`` is each kernel's writeback profile at
      (N2, N2); ``keep_codes=True`` also records every kernel's code grid
      (``planned_codes``) and executed format (``planned_formats``).
    * ``format_aware`` / ``csr_rmax`` -- the row-CSR path, active only under
      a cost model with format costs (``TPUCostModel``).
    """

    def __init__(self, *, strategy: str = "dynamic",
                 model: Optional[FPGACostModel] = None,
                 n_cc: Optional[int] = None,
                 keep_codes: bool = False,
                 format_aware: bool = True,
                 csr_rmax: int = 64):
        self.strategy = strategy
        self.model = model or FPGACostModel()
        self.n_cc = n_cc
        self.keep_codes = keep_codes
        self.format_aware = format_aware
        self.csr_rmax = csr_rmax
        self._executors: Dict[tuple, functools.partial] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.profiled_densities: Dict[str, torch.Tensor] = {}
        self.planned_codes: Dict[str, np.ndarray] = {}
        self.planned_formats: Dict[str, int] = {}

    def run(self, compiled: CompiledModel, tensors: Dict[str, torch.Tensor]
            ) -> Tuple[Dict[str, torch.Tensor], InferenceReport]:
        env = dict(tensors)
        n_cc = self.n_cc or compiled.partition.n_cc
        self.profiled_densities = {}
        self.planned_codes = {}
        self.planned_formats = {}
        reports: List[KernelReport] = []
        for k in compiled.graph.topo_order():
            t0 = time.perf_counter()
            out, rep = self._run_kernel(k, env, n_cc)
            env[k.out] = out
            rep.wall_seconds = time.perf_counter() - t0
            reports.append(rep)
        return env, InferenceReport(reports, self.strategy)

    def _executor(self, k: KernelIR, x: torch.Tensor, y: torch.Tensor,
                  has_residual: bool) -> functools.partial:
        activation = (k.activation.value if k.activation_enabled else "none")
        scale = k.epilogue_scale if has_residual else 1.0
        key = (k.kernel_type, k.block_dims, tuple(x.shape), str(x.dtype),
               tuple(y.shape), str(y.dtype), self.strategy, has_residual,
               scale, activation)
        fn = self._executors.get(key)
        if fn is not None:
            self.cache_hits += 1
            return fn
        self.cache_misses += 1
        n2 = k.scheme.n2
        fn = functools.partial(
            dynasparse_matmul, strategy=self.strategy,
            kernel_type=k.kernel_type, epilogue_scale=scale,
            activation=activation, out_block=(n2, n2), block=k.block_dims,
            cost_model=self.model, format_aware=self.format_aware,
            csr_rmax=self.csr_rmax)
        self._executors[key] = fn
        return fn

    def _run_kernel(self, k: KernelIR, env: Dict[str, torch.Tensor],
                    n_cc: int) -> Tuple[torch.Tensor, KernelReport]:
        _no_attention(k)
        x = env[_agg_lhs_name(k) if k.kernel_type == KernelType.AGGREGATE
                else k.lhs]
        y = env[k.rhs]
        residual = env[k.epilogue_add] if k.epilogue_add is not None else None
        fn = self._executor(k, x, y, residual is not None)
        res: DynasparseResult = fn(x, y, residual=residual)
        _sync(res.out)
        self.profiled_densities[k.out] = res.out_density
        if self.keep_codes:
            self.planned_codes[k.out] = res.codes.cpu().numpy()
            self.planned_formats[k.out] = int(res.fmt)
        rep = _bookkeep_kernel(k, res.codes, res.dens_x, res.dens_y,
                               n_cc, self.model)
        return res.out, rep


@dataclasses.dataclass
class _WalkPlan:
    """What the fused executor builds once per (model, tensor signature)."""

    kernels: list
    flows: list
    needed: List[tuple]


class FusedModelExecutor:
    """Runs a whole ``CompiledModel`` as one walk with chained profiles.

    * graph inputs (adjacency, features, weights) are profiled ONCE per
      (tensor identity, granularity) and cached across inferences;
    * every intermediate is planned from its producer's writeback counts,
      pooled to the consumer's granularity by exact integer sums
      (``profiler.BlockProfile.pool_rows``), never re-profiled;
    * kernels that read the same source tensor share one ELL conversion.

    ``trace_count`` counts the walk plans built: one per signature.
    ``collect_report=False`` skips the host bookkeeping, so no code grid
    leaves the device.  ``run`` keeps ``DynasparseEngine.run``'s contract.
    """

    def __init__(self, *, strategy: str = "dynamic",
                 model: Optional[FPGACostModel] = None,
                 n_cc: Optional[int] = None,
                 keep_intermediates: bool = False,
                 keep_codes: bool = False,
                 collect_report: bool = True,
                 format_aware: bool = True,
                 csr_rmax: int = 64):
        self.strategy = strategy
        self.model = model or FPGACostModel()
        self.n_cc = n_cc
        self.keep_intermediates = keep_intermediates
        self.keep_codes = keep_codes
        self.format_aware = format_aware
        self.csr_rmax = csr_rmax
        self.collect_report = collect_report
        self._programs: Dict[tuple, _WalkPlan] = {}
        # (env name, granularity) -> (tensor ref, BlockProfile); the ref
        # keeps the tensor alive so the identity check is sound
        self._input_profiles: Dict[tuple, tuple] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.trace_count = 0
        self.profiled_densities: Dict[str, torch.Tensor] = {}
        self.planned_codes: Dict[str, np.ndarray] = {}
        self.planned_formats: Dict[str, np.ndarray] = {}

    @staticmethod
    def _tensor_sig(tensors: Dict[str, torch.Tensor]) -> tuple:
        return tuple(sorted((name, tuple(v.shape), str(v.dtype))
                            for name, v in tensors.items()))

    def _signature(self, compiled: CompiledModel,
                   tensors: Dict[str, torch.Tensor]) -> tuple:
        ks = tuple(
            (k.name, k.kernel_type, k.block_dims, k.scheme.n2, k.lhs, k.rhs,
             k.out, k.agg_op.value, k.epilogue_add, k.epilogue_scale,
             k.activation.value if k.activation_enabled else "none")
            for k in compiled.graph.topo_order())
        return (ks, self._tensor_sig(tensors))

    @staticmethod
    def _resolved_flows(compiled: CompiledModel):
        """Per-kernel (lhs, rhs) OperandFlows with Aggregate lhs rebound to
        its env name ("A"/"A_mean"; the IR names it "A")."""
        out = []
        for k, (fx, fy) in zip(compiled.graph.topo_order(),
                               compiled.graph.operand_flows()):
            if k.kernel_type == KernelType.AGGREGATE:
                fx = dataclasses.replace(fx, source=_agg_lhs_name(k))
            out.append((fx, fy))
        return out

    @staticmethod
    def _needed_inputs(flows) -> List[tuple]:
        """Ordered unique (env name, granularity) of every graph-input
        profile the walk consumes."""
        seen: List[tuple] = []
        for fx, fy in flows:
            for f in (fx, fy):
                key = (f.source, f.block)
                if f.producer is None and key not in seen:
                    seen.append(key)
        return seen

    def _trace_kernels(self, kernels, flows, env: Dict[str, torch.Tensor],
                       profiles: Dict[tuple, profiler.BlockProfile]) -> list:
        """Walk the kernels, planning each from ``profiles`` (graph inputs)
        or the producer's chained writeback counts.  Mutates ``env`` and
        returns the per-kernel (codes, dens_x, dens_y, out_density, fmt).

        ELL sharing: the first kernel that reads a source converts it; a
        later kernel reuses that view when it or any earlier reader wanted
        CSR, else sees zeros -- the reference's cond chain, evaluated on the
        device.  The conversion is deterministic, so the shared view is
        bitwise what the per-kernel engine builds for itself."""
        counts_env: Dict[str, profiler.BlockProfile] = {}
        ell_env: Dict[tuple, tuple] = {}    # key -> (want so far, full view)
        sides = []
        for k, (fx, fy) in zip(kernels, flows):
            _no_attention(k)
            x, y = env[fx.source], env[fy.source]
            prof_x, prof_y = (
                counts_env[f.source].pool_rows(f.pool_rows)
                                    .pool_cols(f.pool_cols)
                if f.producer is not None else profiles[(f.source, f.block)]
                for f in (fx, fy))
            codes, dens_x, dens_y = analyzer.plan_codes_from_profiles(
                self.strategy, prof_x, prof_y, self.model,
                kernel_type=k.kernel_type)
            fmt = ell = None
            if self.format_aware:
                fmt = analyzer.plan_format(
                    self.strategy, dens_x, dens_y, tuple(x.shape),
                    y.shape[1], k.block_dims, self.model,
                    kernel_type=k.kernel_type, rmax=self.csr_rmax)
                if fmt is not None:
                    ekey = (fx.source, tuple(x.shape))
                    prev = ell_env.get(ekey)
                    if prev is None:
                        want = fmt
                        full = formats.dense_to_ell(x, rmax=self.csr_rmax)
                    else:
                        prev_want, full = prev
                        want = torch.maximum(prev_want, fmt)
                    ell = mask_ell(full, want)
                    ell_env[ekey] = (want, full)
            residual = (env[k.epilogue_add]
                        if k.epilogue_add is not None else None)
            n2 = k.scheme.n2
            res = dynasparse_matmul(
                x, y, codes=codes, dens_x=dens_x, dens_y=dens_y,
                fmt=fmt, ell=ell, residual=residual, strategy=self.strategy,
                kernel_type=k.kernel_type,
                epilogue_scale=(k.epilogue_scale
                                if residual is not None else 1.0),
                activation=(k.activation.value
                            if k.activation_enabled else "none"),
                out_block=(n2, n2), block=k.block_dims,
                cost_model=self.model, format_aware=self.format_aware,
                csr_rmax=self.csr_rmax)
            env[k.out] = res.out
            counts_env[k.out] = profiler.BlockProfile(
                res.out_counts, tuple(res.out.shape), (n2, n2))
            sides.append((res.codes, res.dens_x, res.dens_y,
                          res.out_density, res.fmt))
        return sides

    def _program(self, compiled: CompiledModel,
                 tensors: Dict[str, torch.Tensor]) -> _WalkPlan:
        key = self._signature(compiled, tensors)
        plan = self._programs.get(key)
        if plan is not None:
            self.cache_hits += 1
            return plan
        self.cache_misses += 1
        self.trace_count += 1
        flows = self._resolved_flows(compiled)
        plan = _WalkPlan(compiled.graph.topo_order(), flows,
                         self._needed_inputs(flows))
        self._programs[key] = plan
        return plan

    def _input_counts(self, needed, tensors) -> Tuple[torch.Tensor, ...]:
        """The graph-input profiles, measured once per tensor identity."""
        out = []
        for name, blk in needed:
            arr = tensors[name]
            cached = self._input_profiles.get((name, blk))
            if cached is None or cached[0] is not arr:
                cached = (arr, profiler.BlockProfile.measure(arr, blk))
                self._input_profiles[(name, blk)] = cached
            out.append(cached[1].counts)
        return tuple(out)

    def run(self, compiled: CompiledModel, tensors: Dict[str, torch.Tensor]
            ) -> Tuple[Dict[str, torch.Tensor], InferenceReport]:
        """One whole-model inference.  Returns ``(env, report)``: ``env``
        holds the final output (all intermediates too iff
        ``keep_intermediates``); the report carries the per-kernel
        bookkeeping plus ``fused_wall_seconds``."""
        n_cc = self.n_cc or compiled.partition.n_cc
        plan = self._program(compiled, tensors)
        in_counts = self._input_counts(plan.needed, tensors)
        t0 = time.perf_counter()
        env = dict(tensors)
        profiles = {
            (name, blk): profiler.BlockProfile(
                counts, tuple(env[name].shape), blk)
            for (name, blk), counts in zip(plan.needed, in_counts)}
        sides = self._trace_kernels(plan.kernels, plan.flows, env, profiles)
        final = plan.kernels[-1].out
        _sync(env[final])
        wall = time.perf_counter() - t0
        outs = (env if self.keep_intermediates else {final: env[final]})

        topo = plan.kernels
        self.profiled_densities = {
            k.out: side[3] for k, side in zip(topo, sides)}
        if self.keep_codes:
            self.planned_codes = {
                k.out: side[0].cpu().numpy() for k, side in zip(topo, sides)}
            self.planned_formats = {
                k.out: side[4].cpu().numpy() for k, side in zip(topo, sides)}
        reports = []
        if self.collect_report:
            reports = [
                _bookkeep_kernel(k, codes, dens_x, dens_y, n_cc, self.model)
                for k, (codes, dens_x, dens_y, _, _fmt) in zip(topo, sides)]
        return outs, InferenceReport(reports, self.strategy,
                                     fused_wall_seconds=wall)
