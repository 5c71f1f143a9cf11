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
bookkeeping (``_bookkeep_kernel``).  A GAT head's ATTENTION kernel runs
``attention_adjacency`` (the masked edge-softmax) in both engines; it plans
nothing itself, and its writeback counts are what the head's Aggregate
plans from.

:meth:`FusedModelExecutor.run_batch` (``launch_batch`` + ``finish_batch``)
serves a wave of stacked requests: the shared weights are profiled once
per tensor identity, the requests' inputs in one batched
``tile_nnz`` launch per (input, granularity), and each slot walks the same
fused kernel walk, planning from its own profile.  With ``mesh=`` (a 1-D
``cores`` mesh, ``distributed.sharding``) the wave's slots split evenly
over the mesh's devices (``sharding.wave_slices``): each lane profiles
and walks its own slot range on its own device, with its own copy of the
weights, and ``finish_batch`` waits on every lane.  Walk plans are keyed
by the group SIZE, so equal-size device groups share one.

:func:`simulate_inference` is the pure cost-model execution (no numerics):
from per-tensor density statistics it predicts a strategy's latency on the
paper's FPGA (or under the TPU model).  Densities of the intermediates are
propagated in float64 numpy (:func:`propagate_stats`), each kernel is
planned on the device (``analyzer.plan_kernel_host``) and costed and
scheduled on the host.  This is how the paper-table results evaluate
graphs whose dense operands would not fit (NELL, Reddit).

Both engines open ``repro_torch.trace`` spans around their phases while a
profiler records, and count ``runs``, ``host_syncs`` and (``run``)
``run_host_ns``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace
from repro_torch.core import analyzer, formats, profiler, scheduler
from repro_torch.core.compiler import CompiledModel
from repro_torch.core.dynasparse import (DynasparseResult,
                                         attention_adjacency,
                                         dynasparse_matmul, mask_ell,
                                         takes_x_format)
from repro_torch.core.ir import Activation, AggOp, KernelIR, KernelType
from repro_torch.core.perf_model import FPGACostModel
from repro_torch.core.profiler import SparsityStats
from repro_torch.device import DeviceLike, resolve
from repro_torch.distributed import sharding
from repro_torch.kernels import dispatch as _dispatch

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
    # set by the fused executor: the whole walk's wall time (for a wave,
    # launch to ready)
    fused_wall_seconds: Optional[float] = None
    # set on the batched serving path: the wave's slot count, and -- filled
    # in by the admission layer, the only place that knows real from
    # dummy -- how many of those slots carried real requests
    wave_slots: Optional[int] = None
    wave_real: Optional[int] = None
    # host seconds the admission layer spent filling the wave's slot
    # buffers (normalize + feature copy), and enqueuing their copy to the
    # device; 0.0 off the wave path
    gather_seconds: float = 0.0
    copy_seconds: float = 0.0
    # the number of devices (lanes) the wave's slots were split over; 1
    # when unsharded
    wave_lanes: int = 1

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


@dataclasses.dataclass
class PendingWave:
    """An in-flight ``launch_batch`` wave (its handle for ``finish_batch``).

    ``outs``/``sides`` hold one entry per lane: that lane's slots stacked
    (B/lanes, ...) on its device, whose kernels may still be running.
    ``done`` holds one CUDA event per lane, recorded after its last kernel
    (empty on the CPU, where everything has run).  ``launched_at`` anchors
    the wave's launch-to-ready wall, so a wave queued behind earlier work
    on the stream reports the wait it saw; ``copy_seconds`` is the host
    time spent enqueuing the per-lane input copies of a sharded wave."""

    outs: List[Dict[str, torch.Tensor]]
    sides: List[list]
    compiled: CompiledModel
    n_cc: int
    wave_slots: int
    launched_at: float
    lanes: int = 1
    done: Tuple[torch.cuda.Event, ...] = ()
    copy_seconds: float = 0.0


def _k2p_model_seconds(num_decisions: int) -> float:
    return num_decisions * _K2P_INSTRUCTIONS / _SOFT_PROC_IPS


# ---------------------------------------------------------------------------
# Pure cost-model simulation (paper-table results; no numerics).
# ---------------------------------------------------------------------------

def propagate_stats(compiled: CompiledModel,
                    static_stats: Dict[str, SparsityStats], *,
                    relu_keep: float = 0.5) -> Dict[str, SparsityStats]:
    """Forward pass in DENSITY space over the IR, in float64 numpy.

    Intermediate feature densities are predicted per block with the
    independent-Bernoulli model (``perf_model.predict_output_density``, in
    log space); ReLU keeps ``relu_keep`` of nonzeros.  This stays on the
    host in the reference's operation order: a density one ulp off can
    move a code across a threshold.
    """
    env = dict(static_stats)
    for k in compiled.graph.topo_order():
        if k.kernel_type == KernelType.ATTENTION:
            raise NotImplementedError(
                "attention kernels have no density-space model (their "
                "operand density is input-dependent by construction); GAT "
                "runs only through the real-numerics engines")
        dx, dy = _operand_block_densities(k, env)
        _, bk, _ = k.block_dims
        # out block (i, j): 1 - prod_k (1 - dx[i,k] dy[k,j])^bk
        log_stay = np.zeros((dx.shape[0], dy.shape[1]))
        for kk in range(dx.shape[1]):
            p = np.clip(np.outer(dx[:, kk], dy[kk, :]), 0.0, 1.0 - 1e-12)
            log_stay += bk * np.log1p(-p)
        dens = 1.0 - np.exp(log_stay)
        if k.kernel_type == KernelType.AGGREGATE:
            # stats convention: features live at (N2, N2) granularity; the
            # Aggregate result is uniform within its N1 row panel -> expand.
            dens = np.repeat(dens, max(k.scheme.n1 // k.scheme.n2, 1), axis=0)
            m = k.matmul_dims[0]
            dens = dens[: -(-m // k.scheme.n2)]
        if k.epilogue_add is not None and k.epilogue_add in env:
            other = env[k.epilogue_add].block_densities
            dens = 1.0 - (1.0 - dens) * (1.0 - other)
        if k.activation_enabled and k.activation == Activation.RELU:
            dens = dens * relu_keep
        m, _, d = k.matmul_dims
        env[k.out] = SparsityStats.from_predicted(
            (m, d), (k.scheme.n2, k.scheme.n2), dens)
    return env


def _pool_rows(bd: np.ndarray, r: int) -> np.ndarray:
    """Mean-pool row-blocks r at a time (exact for element densities)."""
    if r <= 1:
        return bd
    rows = bd.shape[0]
    pad = (-rows) % r
    if pad:
        bd = np.concatenate([bd, np.zeros((pad, bd.shape[1]))], axis=0)
        w = np.concatenate([np.ones((rows, 1)), np.zeros((pad, 1))])
    else:
        w = np.ones((bd.shape[0], 1))
    num = (bd * w).reshape(-1, r, bd.shape[1]).sum(axis=1)
    den = w.reshape(-1, r, 1).sum(axis=1)
    return num / np.maximum(den, 1)


def _operand_block_densities(k: KernelIR, env: Dict[str, SparsityStats]
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """(I, K) lhs / (K, J) rhs block-density grids at the kernel's dims.

    Feature-matrix stats are stored at (N2, N2); an Aggregate kernel
    consumes its rhs at (N1, N2) fiber granularity, so row-blocks are
    mean-pooled.
    """
    sx, sy = env[k.lhs], env[k.rhs]
    dx, dy = sx.block_densities, sy.block_densities
    if k.kernel_type == KernelType.AGGREGATE:
        dy = _pool_rows(dy, max(k.scheme.n1 // k.scheme.n2, 1))
    return dx, dy


def simulate_inference(compiled: CompiledModel,
                       stats_env: Dict[str, SparsityStats], *,
                       strategy: str = "dynamic",
                       model: Optional[FPGACostModel] = None,
                       n_cc: Optional[int] = None,
                       device: DeviceLike = None) -> InferenceReport:
    """Predicted latency of a full GNN inference under a mapping strategy.

    Pure cost-model execution: ``stats_env`` maps every tensor the IR
    references to its :class:`SparsityStats` (adjacency at (N1, N1),
    features and weights at (N2, N2); :func:`propagate_stats` predicts the
    intermediates).  Per kernel: K2P planning on ``device`` (the GPU unless
    the caller asks for the CPU) through ``analyzer.plan_kernel_host``,
    Alg. 8 dynamic scheduling over ``n_cc`` cores and the Table IV cost
    under ``model`` (``FPGACostModel`` for the paper's numbers, or
    ``TPUCostModel``), all bookkeeping in float64 numpy.
    """
    dev = resolve(device)
    model = model or FPGACostModel()
    n_cc = n_cc or compiled.partition.n_cc
    reports = []
    for k in compiled.graph.topo_order():
        if k.kernel_type == KernelType.ATTENTION:
            raise NotImplementedError(
                "attention kernels have no density-space cost model; GAT "
                "runs only through the real-numerics engines")
        dx, dy = _operand_block_densities(k, stats_env)
        codes, costs = analyzer.plan_kernel_host(
            strategy, dx, dy, k.block_dims, model,
            kernel_type=k.kernel_type, device=dev)
        sched = scheduler.schedule_dynamic(costs.reshape(-1), n_cc)
        # the codes' histogram: four counting passes, about twice as fast
        # as np.bincount's widening copy on these grids
        hist = np.array([np.count_nonzero(codes == p) for p in range(4)],
                        np.int64)
        reports.append(KernelReport(
            name=k.name, num_tasks=int(costs.size), histogram=hist,
            makespan_cycles=sched.makespan, utilization=sched.utilization,
            k2p_seconds=_k2p_model_seconds(codes.size)))
    return InferenceReport(reports, strategy)


def _sync(t: torch.Tensor) -> None:
    """Wait for the device to finish ``t`` (counted as a host sync on any
    device)."""
    trace.count("host_syncs")
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


def _attention(k: KernelIR, x: torch.Tensor, y: torch.Tensor,
               env: Dict[str, torch.Tensor]) -> DynasparseResult:
    """A GAT head's masked edge-softmax over ``x``'s support ("A"), with
    ``y`` its features; profiled at (N2, N2) like every writeback."""
    n2 = k.scheme.n2
    return attention_adjacency(
        x, y, env[k.att_src], env[k.att_dst], slope=k.att_slope,
        threshold=k.att_threshold, out_block=(n2, n2))


def _bookkeep_kernel(k: KernelIR, codes, dens_x, dens_y, n_cc: int, model
                     ) -> KernelReport:
    """Host bookkeeping from the planner's codes (the MicroBlaze's role):
    Table IV per-task costs, Alg. 8 scheduling, primitive histogram, modeled
    + measured K2P time.  The only place the codes leave the device."""
    trace.count("host_syncs", 3)
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
        trace.count("runs")
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
        x = env[_agg_lhs_name(k) if k.kernel_type == KernelType.AGGREGATE
                else k.lhs]
        y = env[k.rhs]
        spans = trace.kernel_spans(k.name)
        with trace.span(spans.kernel):
            if k.kernel_type == KernelType.ATTENTION:
                res = _attention(k, x, y, env)
            else:
                residual = (env[k.epilogue_add]
                            if k.epilogue_add is not None else None)
                fn = self._executor(k, x, y, residual is not None)
                res = fn(x, y, residual=residual, spans=spans)
        _sync(res.out)
        self.profiled_densities[k.out] = res.out_density
        if self.keep_codes:
            trace.count("host_syncs", 2)
            self.planned_codes[k.out] = res.codes.cpu().numpy()
            self.planned_formats[k.out] = int(res.fmt)
        rep = _bookkeep_kernel(k, res.codes, res.dens_x, res.dens_y,
                               n_cc, self.model)
        return res.out, rep


@dataclasses.dataclass
class _WalkPlan:
    """What the fused executor builds once per (model, tensor signature):
    the kernels in walk order, their operand flows, the graph-input
    profiles they need and each kernel's span names."""

    kernels: list
    flows: list
    needed: List[tuple]
    spans: List[trace.KernelSpans]


class FusedModelExecutor:
    """Runs a whole ``CompiledModel`` as one walk with chained profiles.

    * graph inputs (adjacency, features, weights) are profiled ONCE per
      (tensor identity, ``_version``, granularity) and cached across
      inferences;
    * every intermediate is planned from its producer's writeback counts,
      pooled to the consumer's granularity by exact integer sums
      (``profiler.BlockProfile.pool_rows``), never re-profiled;
    * kernels that read the same source tensor share one ELL conversion;
    * in :meth:`run`, a graph input that a kernel's float32 walk reads as
      its lhs keeps its walk format (``dispatch.WalkFormat``: x's tile
      bitmask words and staged tiles) across inferences while it stays
      the same tensor object at the same ``_version``: the first run that
      reads it builds nothing (a one-shot input pins no A-sized buffer),
      the next builds the format in its first walk over it, and every
      later walk over it skips the format pass.  Another object, a
      bumped version or an inference tensor (which keeps no version)
      starts again; one entry per (name, k-block edge, device), dropped
      with the executor.  A wave's walks (``run_batch``) hold none.

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
        # (env name, granularity, device) -> (tensor ref, BlockProfile, its
        # _version); the ref keeps the tensor alive so the identity check
        # is sound
        self._input_profiles: Dict[tuple, tuple] = {}
        # (env name, device) -> (source tensor, its copy there): the shared
        # weights of a lane on another device than the caller's
        self._device_copies: Dict[tuple, tuple] = {}
        # (env name, k-block edge, device) -> (tensor, its _version, the
        # run that first read it, its WalkFormat or None); the runs are
        # counted by _runs
        self._walk_formats: Dict[tuple, tuple] = {}
        self._runs = 0
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
             k.activation.value if k.activation_enabled else "none",
             k.att_src, k.att_dst, k.att_slope, k.att_threshold)
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

    def _trace_kernels(self, plan: _WalkPlan, env: Dict[str, torch.Tensor],
                       profiles: Dict[tuple, profiler.BlockProfile],
                       hold_formats: bool = False) -> list:
        """Walk ``plan``'s kernels, each in its span, planning each from
        ``profiles`` (graph inputs) or the producer's chained writeback
        counts.  Mutates ``env`` and returns the per-kernel (codes, dens_x,
        dens_y, out_density, fmt).  With ``hold_formats`` a graph input's
        walk format is kept across runs (:meth:`_x_format`).

        ELL sharing: the first kernel that reads a source converts it; a
        later kernel reuses that view when it or any earlier reader wanted
        CSR, else sees zeros -- the reference's cond chain, evaluated on the
        device.  The conversion is deterministic, so the shared view is
        bitwise what the per-kernel engine builds for itself."""
        counts_env: Dict[str, profiler.BlockProfile] = {}
        ell_env: Dict[tuple, tuple] = {}    # key -> (want so far, full view)
        sides = []
        for k, (fx, fy), spans in zip(plan.kernels, plan.flows, plan.spans):
            with trace.span(spans.kernel):
                res = self._trace_kernel(k, fx, fy, spans, env, profiles,
                                         counts_env, ell_env, hold_formats)
            n2 = k.scheme.n2
            env[k.out] = res.out
            counts_env[k.out] = profiler.BlockProfile(
                res.out_counts, tuple(res.out.shape), (n2, n2))
            sides.append((res.codes, res.dens_x, res.dens_y,
                          res.out_density, res.fmt))
        return sides

    def _trace_kernel(self, k: KernelIR, fx, fy, spans: trace.KernelSpans,
                      env: Dict[str, torch.Tensor],
                      profiles: Dict[tuple, profiler.BlockProfile],
                      counts_env: Dict[str, profiler.BlockProfile],
                      ell_env: Dict[tuple, tuple],
                      hold_formats: bool = False) -> DynasparseResult:
        """One kernel of :meth:`_trace_kernels`: plan, share the ELL view,
        run."""
        x, y = env[fx.source], env[fy.source]
        if k.kernel_type == KernelType.ATTENTION:
            # no planning of its own: its output density is known only after
            # it runs, and its writeback counts feed the head's Aggregate
            return _attention(k, x, y, env)
        with trace.span(spans.plan):
            prof_x, prof_y = (
                counts_env[f.source].pool_rows(f.pool_rows)
                                    .pool_cols(f.pool_cols)
                if f.producer is not None
                else profiles[(f.source, f.block)]
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
            with trace.span(spans.format):
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
        x_format = None
        if (hold_formats and fx.producer is None
                and takes_x_format(x, y, self.strategy)):
            x_format = self._x_format(fx.source, x, k.block_dims[1])
        return dynasparse_matmul(
            x, y, codes=codes, dens_x=dens_x, dens_y=dens_y,
            fmt=fmt, ell=ell, residual=residual,
            strategy=self.strategy, kernel_type=k.kernel_type,
            epilogue_scale=(k.epilogue_scale
                            if residual is not None else 1.0),
            activation=(k.activation.value
                        if k.activation_enabled else "none"),
            out_block=(k.scheme.n2, k.scheme.n2),
            block=k.block_dims,
            cost_model=self.model, format_aware=self.format_aware,
            csr_rmax=self.csr_rmax, spans=spans, x_format=x_format)

    def _x_format(self, name: str, x: torch.Tensor, bk: int
                  ) -> Optional[_dispatch.WalkFormat]:
        """The walk format of graph input ``name`` (``x``) at k-block edge
        ``bk`` for this run's walk: None where x is new under this key (a
        first sight, remembered) or an inference tensor (forgotten); built
        in the first walk of a later run that reads x unchanged; then kept
        and handed to every later walk."""
        key = (name, bk, x.device)
        if x.is_inference():
            self._walk_formats.pop(key, None)
            return None
        held = self._walk_formats.get(key)
        if held is None or held[0] is not x or held[1] != x._version:
            self._walk_formats[key] = (x, x._version, self._runs, None)
            return None
        x_format = held[3]
        if x_format is None and held[2] < self._runs:
            x_format = _dispatch.build_x_format(x, -(-x.shape[1] // bk), bk)
            self._walk_formats[key] = held[:3] + (x_format,)
        return x_format

    def _program(self, compiled: CompiledModel, key: tuple) -> _WalkPlan:
        """The walk plan cached under ``key``: a single inference's
        signature, or a wave's (model, shared and wave signatures)."""
        plan = self._programs.get(key)
        if plan is not None:
            self.cache_hits += 1
            return plan
        self.cache_misses += 1
        self.trace_count += 1
        flows = self._resolved_flows(compiled)
        kernels = compiled.graph.topo_order()
        plan = _WalkPlan(kernels, flows, self._needed_inputs(flows),
                         [trace.kernel_spans(k.name) for k in kernels])
        self._programs[key] = plan
        return plan

    def _input_counts(self, needed, tensors) -> Tuple[torch.Tensor, ...]:
        """The graph-input profiles, measured once per tensor identity and
        ``_version`` (an inference tensor keeps none: its identity)."""
        out = []
        for name, blk in needed:
            arr = tensors[name]
            key = (name, blk, arr.device)
            version = None if arr.is_inference() else arr._version
            cached = self._input_profiles.get(key)
            if (cached is None or cached[0] is not arr
                    or cached[2] != version):
                cached = (arr, profiler.BlockProfile.measure(arr, blk),
                          version)
                self._input_profiles[key] = cached
            out.append(cached[1].counts)
        return tuple(out)

    def run(self, compiled: CompiledModel, tensors: Dict[str, torch.Tensor]
            ) -> Tuple[Dict[str, torch.Tensor], InferenceReport]:
        """One whole-model inference.  Returns ``(env, report)``: ``env``
        holds the final output (all intermediates too iff
        ``keep_intermediates``); the report carries the per-kernel
        bookkeeping plus ``fused_wall_seconds``."""
        t_enter = time.perf_counter_ns()
        trace.count("runs")
        self._runs += 1
        with trace.span(trace.RUN):
            n_cc = self.n_cc or compiled.partition.n_cc
            with trace.span(trace.RUN_SIGNATURE):
                plan = self._program(compiled,
                                     self._signature(compiled, tensors))
            with trace.span(trace.RUN_INPUT_PROFILES):
                in_counts = self._input_counts(plan.needed, tensors)
            t0 = time.perf_counter()
            env = dict(tensors)
            profiles = {
                (name, blk): profiler.BlockProfile(
                    counts, tuple(env[name].shape), blk)
                for (name, blk), counts in zip(plan.needed, in_counts)}
            sides = self._trace_kernels(plan, env, profiles,
                                        hold_formats=True)
            final = plan.kernels[-1].out
            trace.count("run_host_ns", time.perf_counter_ns() - t_enter)
            with trace.span(trace.RUN_SYNC):
                _sync(env[final])
            wall = time.perf_counter() - t0
            with trace.span(trace.RUN_REPORT):
                outs = (env if self.keep_intermediates
                        else {final: env[final]})
                reports = self._report(plan.kernels, sides, n_cc)
        return outs, InferenceReport(reports, self.strategy,
                                     fused_wall_seconds=wall)

    def _report(self, topo, sides, n_cc: int) -> List[KernelReport]:
        """``run``'s bookkeeping: the profiled densities, the codes and
        formats under ``keep_codes``, the kernel reports under
        ``collect_report``."""
        self.profiled_densities = {
            k.out: side[3] for k, side in zip(topo, sides)}
        if self.keep_codes:
            trace.count("host_syncs", 2 * len(topo))
            self.planned_codes = {
                k.out: side[0].cpu().numpy() for k, side in zip(topo, sides)}
            self.planned_formats = {
                k.out: side[4].cpu().numpy() for k, side in zip(topo, sides)}
        if not self.collect_report:
            return []
        return [_bookkeep_kernel(k, codes, dens_x, dens_y, n_cc, self.model)
                for k, (codes, dens_x, dens_y, _, _fmt) in zip(topo, sides)]

    # -- batched (multi-tenant) execution ------------------------------------
    @trace.spanned(trace.WAVE_LAUNCH)
    def launch_batch(self, compiled: CompiledModel,
                     shared: Dict[str, torch.Tensor],
                     batched: Dict[str, torch.Tensor],
                     mesh: Optional[sharding.CoresMesh] = None
                     ) -> PendingWave:
        """Enqueue one wave WITHOUT synchronizing with the device: the
        asynchronous half of :meth:`run_batch`.

        Nothing here waits for the device (no ``.item()``, no copy to the
        host), so a serving layer can launch the next wave while this one
        runs; :meth:`finish_batch` blocks and collects ``(outs, report)``.
        With ``mesh``, ``batched`` may lie on the host (pinned): each
        lane's slot range is copied to its own device here
        (``sharding.shard_wave``)."""
        n_cc = self.n_cc or compiled.partition.n_cc
        lanes = 1
        if mesh is not None:
            if (len(mesh.axis_names) != 1
                    or mesh.axis_names[0] != sharding.CORES_AXIS):
                raise ValueError(
                    f"run_batch mesh must be 1-D over "
                    f"{sharding.CORES_AXIS!r}, got {mesh.axis_names}")
            lanes = mesh.size
            # raises on a wave whose slots the mesh does not divide
            sharding.wave_slices(int(next(iter(batched.values())).shape[0]),
                                 lanes)
        # one plan per (model, group size, shared shapes, wave shapes): a
        # server that pads waves to a fixed slot count builds one per shape
        # bucket and group size, whichever devices the group holds
        plan = self._program(compiled, (
            "wave",
            None if mesh is None else sharding.abstract_cores_mesh(lanes),
            self._signature(compiled, shared), self._tensor_sig(batched)))
        missing = [n for n, _ in plan.needed
                   if n not in shared and n not in batched]
        if missing:
            raise KeyError(f"wave inputs missing tensors: {missing}")
        shared_needed = tuple((n, b) for n, b in plan.needed if n in shared)
        request_needed = tuple((n, b) for n, b in plan.needed
                               if n in batched)
        slots = _wave_slots(batched)
        copy_seconds = 0.0
        if mesh is None:
            parts = [(None, batched)]
        else:
            t0 = time.perf_counter()
            parts = list(zip(mesh.devices, sharding.shard_wave(batched,
                                                               mesh)))
            copy_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs, sides, done = [], [], []
        for dev, part in parts:
            with _on(dev):
                o, s = self._walk_wave(plan, self._shared_on(shared, dev),
                                       shared_needed, request_needed, part)
                final = o[plan.kernels[-1].out]
                if final.is_cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(final.device))
                    done.append(ev)
            outs.append(o)
            sides.append(s)
        return PendingWave(outs=outs, sides=sides, compiled=compiled,
                           n_cc=n_cc, wave_slots=slots, launched_at=t0,
                           lanes=lanes, done=tuple(done),
                           copy_seconds=copy_seconds)

    def _walk_wave(self, plan: _WalkPlan, shared: Dict[str, torch.Tensor],
                   shared_needed: tuple, request_needed: tuple,
                   batched: Dict[str, torch.Tensor]) -> tuple:
        """One lane of a wave on its device: the requests' inputs profiled
        in one launch per (input, granularity), then each slot's fused
        walk from its own profile.  Returns the stacked outputs and
        per-kernel sides."""
        slots = _wave_slots(batched)
        shared_counts = self._input_counts(shared_needed, shared)
        base = {(name, blk): profiler.BlockProfile(
                    counts, tuple(shared[name].shape), blk)
                for (name, blk), counts in zip(shared_needed, shared_counts)}
        # each request is a new graph: its inputs are profiled on the
        # device, one launch per (input, granularity) for the lane's slots
        wave_counts = [profiler.batched_block_counts(batched[name], blk)
                       for name, blk in request_needed]
        final = plan.kernels[-1].out
        keep = ([k.out for k in plan.kernels] if self.keep_intermediates
                else [final])
        slot_outs, slot_sides = [], []
        for b in range(slots):
            env = dict(shared)
            env.update({name: v[b] for name, v in batched.items()})
            profiles = dict(base)
            for (name, blk), counts in zip(request_needed, wave_counts):
                profiles[(name, blk)] = profiler.BlockProfile(
                    counts[b], tuple(env[name].shape), blk)
            slot_sides.append(self._trace_kernels(plan, env, profiles))
            slot_outs.append([env[name] for name in keep])
        outs = {name: torch.stack([o[i] for o in slot_outs])
                for i, name in enumerate(keep)}
        sides = [tuple(torch.stack([s_[k][j] for s_ in slot_sides])
                       for j in range(5))
                 for k in range(len(plan.kernels))]
        return outs, sides

    def _shared_on(self, shared: Dict[str, torch.Tensor],
                   dev: Optional[torch.device]) -> Dict[str, torch.Tensor]:
        """The shared tensors on ``dev``: themselves where they lie there,
        else one copy per (tensor identity, device), kept, so that a lane
        on another card neither copies nor re-profiles its weights in
        steady state."""
        if dev is None or all(v.device == dev for v in shared.values()):
            return shared
        out = {}
        for name, v in shared.items():
            if v.device != dev:
                cached = self._device_copies.get((name, dev))
                if cached is None or cached[0] is not v:
                    cached = (v, v.to(dev))
                    self._device_copies[(name, dev)] = cached
                v = cached[1]
            out[name] = v
        return out

    @trace.spanned(trace.WAVE_FINISH)
    def finish_batch(self, pending: PendingWave
                     ) -> Tuple[Dict[str, torch.Tensor], InferenceReport]:
        """Block on a :meth:`launch_batch` wave and assemble its report
        (the synchronous half of :meth:`run_batch`).  A sharded wave's
        lanes are gathered in slot order onto the first lane's device."""
        trace.count("runs", pending.wave_slots)
        trace.count("host_syncs", len(pending.done))
        for ev in pending.done:
            ev.synchronize()
        wall = time.perf_counter() - pending.launched_at
        topo = pending.compiled.graph.topo_order()
        outs, sides = pending.outs[0], pending.sides[0]
        if pending.lanes > 1:
            dev = outs[topo[-1].out].device
            outs = {name: torch.cat([o[name].to(dev) for o in pending.outs])
                    for name in outs}
            sides = [tuple(torch.cat([s_[k][j].to(dev)
                                      for s_ in pending.sides])
                           for j in range(5))
                     for k in range(len(topo))]
        self.profiled_densities = {
            k.out: side[3] for k, side in zip(topo, sides)}      # (B, ...)
        if self.keep_codes:
            trace.count("host_syncs", 2 * len(topo))
            self.planned_codes = {
                k.out: side[0].cpu().numpy() for k, side in zip(topo, sides)}
            self.planned_formats = {       # (B,) executed Format per slot
                k.out: side[4].cpu().numpy() for k, side in zip(topo, sides)}
        reports = []
        if self.collect_report:
            for b in range(pending.wave_slots):
                for k, (codes, dens_x, dens_y, _, _fmt) in zip(topo, sides):
                    rep = _bookkeep_kernel(k, codes[b], dens_x[b], dens_y[b],
                                           pending.n_cc, self.model)
                    rep.name = f"{k.name}[{b}]"
                    reports.append(rep)
        return outs, InferenceReport(
            reports, self.strategy, fused_wall_seconds=wall,
            wave_slots=pending.wave_slots,
            copy_seconds=pending.copy_seconds, wave_lanes=pending.lanes)

    def run_batch(self, compiled: CompiledModel,
                  shared: Dict[str, torch.Tensor],
                  batched: Dict[str, torch.Tensor],
                  mesh: Optional[sharding.CoresMesh] = None
                  ) -> Tuple[Dict[str, torch.Tensor], InferenceReport]:
        """Serve a WAVE of stacked inferences.

        * ``shared`` -- tensors common to every request (the weights),
          profiled once per (tensor identity, device) (``run``'s cache);
        * ``batched`` -- per-request tensors stacked on a leading slot axis
          (``(B, ...)``), profiled on the device in one batched launch per
          (input, granularity) and lane; each slot then walks the fused
          kernel walk on its own slice, planning its K2P codes from its own
          profile;
        * ``mesh`` -- a 1-D ``cores`` mesh (``sharding.cores_mesh``) whose
          D devices each run B/D of the slots (``B % D == 0``); ``None``
          runs the wave where ``batched`` lies.

        Returns ``(outs, report)``: every entry of ``outs`` is stacked
        ``(B, ...)`` (the final output, or every kernel's under
        ``keep_intermediates``); the report is wave-level, with
        ``collect_report`` rows named ``"{kernel}[b]"`` and the lane count
        in ``wave_lanes``.  A slot's result is bitwise what ``run`` gives
        on its slice, on any mesh.  Plans are cached per (model, group
        size, shared signature, wave signature), so ``trace_count`` grows
        by at most one per (bucket, group size) of a fixed-slot server."""
        return self.finish_batch(self.launch_batch(compiled, shared,
                                                   batched, mesh=mesh))


def _on(dev: Optional[torch.device]):
    """Make ``dev`` the current CUDA device (a no-op off CUDA)."""
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _wave_slots(batched: Dict[str, torch.Tensor]) -> int:
    """The wave's slot count, checked across its stacked inputs.  On the
    card every slot's view must start on a 16-byte boundary (kernels read
    their operands in 16-byte words); a slot stride that is not a multiple
    of 16 bytes raises rather than run another route."""
    if not batched:
        raise ValueError("run_batch: a wave needs per-request inputs")
    sizes = {name: int(v.shape[0]) for name, v in batched.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(f"run_batch: stacked inputs disagree on the slot "
                         f"count: {sizes}")
    for name, v in batched.items():
        apart = v.stride(0) * v.element_size()
        if v.is_cuda and (v.data_ptr() % 16 or apart % 16):
            raise ValueError(
                f"run_batch: slots of {name!r} lie {apart} bytes apart; "
                "each slot must start on a 16-byte boundary (pad the "
                "bucket to a multiple of 4 rows)")
    return next(iter(sizes.values()))
