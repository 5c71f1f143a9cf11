"""Batched GNN serving: concurrent graph queries over one compiled model.

Port of ``repro.serving.graph_engine`` (the synchronous engine).  The
paper's runtime serves a *stream* of queries: it profiles
each incoming graph and re-plans the kernel-to-primitive mapping per
input.  :class:`GraphServeEngine` runs that loop over the fused executor:

    request -> shape bucket -> admission wave -> profile -> plan -> execute

* **Shape buckets.**  A request lands in the smallest power of two >=
  max(|V|, ``min_bucket``); one ``CompiledModel`` per bucket is shared by
  every request in it, and the weights are shared by all
  (``models.gnn.init_spec_weights``: weight shapes never depend on |V|).
* **Waves.**  Requests of a bucket are cut into waves of ``slots``; a wave
  is padded with zero dummy requests (their blocks plan to SKIP), filled
  on the host, copied to the device once per input, and served by ONE
  ``FusedModelExecutor.launch_batch``: the wave's inputs are profiled in
  one batched ``tile_nnz`` launch per (input, granularity), and each slot
  walks the fused kernel walk, planning from its own profile.  The walk
  plan is built once per bucket (``executor.trace_count``).
* **Bitwise request isolation.**  A request's result depends only on its
  own slot and the weights, so it is bitwise what a per-request
  ``DynasparseEngine`` gives on the same padded tensors
  (:meth:`GraphServeEngine.run_naive`, the oracle), whatever the admission
  order or the wave's other requests.

* **Online serving.**  :meth:`GraphServeEngine.cut_wave`,
  :meth:`GraphServeEngine.request_cost` and the deadline fields of
  :class:`GraphResult` are what ``serving.scheduler.ContinuousGraphServer``
  reads to serve requests that arrive over time.

* **Mini-batch requests.**  A request may carry a ``fill_features(out)``
  hook; the slot fill then hands it the slot's (n, f_in) feature view
  instead of copying ``features`` (``serving.minibatch.SeedRequest``
  copies the rows it gathered from the feature store at admission).

* **Sharded waves.**  With ``mesh`` (a 1-D ``cores`` mesh,
  ``distributed.sharding.cores_mesh``) every wave's slots split evenly
  over the mesh's devices, and requests are placed into each device's
  slot range by cost-aware LPT bins over :meth:`GraphServeEngine
  .request_cost` (:meth:`GraphServeEngine._slot_layout`), so that the
  per-device walks carry a balanced predicted load.  :meth:`GraphServeEngine
  .begin_wave` also takes a per-wave ``submesh`` (a disjoint device group
  from ``sharding.partition_mesh``): the continuous scheduler's resize
  lanes.  Results stay bitwise :meth:`GraphServeEngine.run_naive`'s on any
  mesh, and walk plans grow by at most one per (bucket, group size).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import compiler, runtime
from repro_torch.core import scheduler as core_scheduler
from repro_torch.core.compiler import CompiledModel, GraphMeta
from repro_torch.core.perf_model import Primitive
from repro_torch.data import graphs as graph_data
from repro_torch.distributed import sharding
from repro_torch.models import gnn as gnn_models
from repro_torch.serving.config import UNSET, EngineConfig, merge_config


@dataclasses.dataclass
class GraphRequest:
    """One inference query: a graph at the engine's feature width.

    ``adjacency`` is the raw (n, n) 0/1 adjacency (self loops optional --
    normalization forces them); ``features`` the (n, f_in) node features.
    """

    adjacency: np.ndarray
    features: np.ndarray
    request_id: int = 0

    @property
    def n_vertices(self) -> int:
        return int(self.features.shape[0])


@dataclasses.dataclass
class GraphResult:
    request_id: int
    logits: np.ndarray              # (n, n_classes), padding rows sliced off
    bucket: int                     # padded vertex count the wave ran at
    wave: int                       # admission wave index (-1: run_naive)
    # continuous-serving metadata (serving.scheduler fills these in; the
    # synchronous serve()/run_naive() paths leave them None)
    deadline: Optional[float] = None      # absolute clock deadline, if any
    completed_at: Optional[float] = None  # clock time the wave finished

    @property
    def deadline_met(self) -> Optional[bool]:
        """True/False under the continuous scheduler; None when the result
        came from a path with no deadline accounting."""
        if self.deadline is None or self.completed_at is None:
            return None
        return self.completed_at <= self.deadline


@dataclasses.dataclass
class InFlightWave:
    """A launched-but-unfinished wave (``begin_wave``'s handle): the
    requests, their slots (request i in slot ``slot_of[i]``) and the
    executor's pending dispatch.  Pass it to ``finish_wave`` to block and
    collect the results."""

    bucket: int
    wave: List[GraphRequest]
    slot_of: List[int]
    pending: runtime.PendingWave
    final: str                      # env name of the model's output tensor
    index: int                      # admission wave index (GraphResult.wave)
    gather_seconds: float = 0.0     # host wall filling the slot buffers
    copy_seconds: float = 0.0       # host wall enqueuing their device copy


def random_requests(n_requests: int, *, f_in: int,
                    sizes: Sequence[int] = (48, 96, 160),
                    seed: int = 0, avg_degree: int = 8,
                    feat_density: float = 0.25) -> List[GraphRequest]:
    """A synthetic query stream with per-request size AND sparsity: each
    request draws its own vertex count (jittered around ``sizes``),
    power-law degree structure and feature density (floored at 0.02).
    Draws the reference's arrays from the same seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        base = int(rng.choice(np.asarray(sizes)))
        n = max(8, base - int(rng.integers(0, max(base // 4, 1))))
        e = max(n * avg_degree, n)
        w = graph_data.powerlaw_marginal(n, rng)
        src = rng.choice(n, size=e, p=w)
        dst = rng.choice(n, size=e, p=w)
        a = np.zeros((n, n), np.float32)
        a[src, dst] = 1.0
        a[dst, src] = 1.0
        dens = float(np.clip(feat_density * rng.uniform(0.4, 1.6), 0.02, 1.0))
        mask = rng.random((n, f_in)) < dens
        h = (rng.normal(size=(n, f_in)).astype(np.float32) ** 2) * mask
        out.append(GraphRequest(a, h, request_id=i))
    return out


class GraphServeEngine:
    """Request-loop GNN server over one shared compiled model per bucket.

    >>> eng = GraphServeEngine("gcn", f_in=64, n_classes=7, device="cpu")
    >>> results = eng.serve(random_requests(8, f_in=64))

    Contracts:

    * results come back in request order, each sliced to its request's
      vertex count;
    * outputs are bitwise equal to :meth:`run_naive` and do not depend on
      the admission order;
    * ``executor.trace_count`` grows by at most one per shape bucket;
    * ``collect_report=False`` (the default) keeps every code grid on the
      device; with it on, the wave report carries per-request per-kernel
      rows.

    ``mesh`` (a 1-D ``cores`` mesh) shards every wave over its devices:
    ``slots`` must divide by its size, requests are LPT-binned into the
    devices' slot ranges by :meth:`request_cost`, and the plan bound
    becomes one per (bucket, group size).  :meth:`begin_wave` takes a
    per-wave ``submesh`` too.  Without an explicit ``device`` the engine
    lives on the mesh's first device.

    The knobs form an :class:`EngineConfig` (``config=`` /
    :meth:`from_config`; the resolved config is ``self.config``).  Explicit
    kwargs override config fields left at their default; a kwarg that
    conflicts with a field the config sets raises.  Weights live on the
    engine's device for its lifetime.
    """

    def __init__(self, model: str = UNSET, *,
                 config: Optional[EngineConfig] = None,
                 f_in: int = UNSET, hidden: int = UNSET,
                 n_classes: int = UNSET,
                 weights: Optional[Dict[str, np.ndarray]] = UNSET,
                 weight_seed: int = UNSET, weight_density: float = UNSET,
                 slots: int = UNSET, min_bucket: int = UNSET,
                 strategy: str = UNSET, n_cc: int = UNSET, align: int = UNSET,
                 on_chip_bytes: int = UNSET, collect_report: bool = UNSET,
                 keep_codes: bool = UNSET, cost_model=UNSET,
                 format_aware: bool = UNSET, csr_rmax: int = UNSET,
                 mesh: Optional[sharding.CoresMesh] = UNSET,
                 device=UNSET):
        cfg = merge_config(EngineConfig, config, dict(
            model=model, f_in=f_in, hidden=hidden, n_classes=n_classes,
            weights=weights, weight_seed=weight_seed,
            weight_density=weight_density, slots=slots,
            min_bucket=min_bucket, strategy=strategy, n_cc=n_cc,
            align=align, on_chip_bytes=on_chip_bytes,
            collect_report=collect_report, keep_codes=keep_codes,
            cost_model=cost_model, format_aware=format_aware,
            csr_rmax=csr_rmax, mesh=mesh, device=device)).validate()
        self.config = cfg
        self.spec = gnn_models.make_model_spec(cfg.model, cfg.f_in,
                                               cfg.hidden, cfg.n_classes)
        self.f_in = cfg.f_in
        self.slots = cfg.slots
        # sharded dispatch: the mesh splits every wave's slots evenly over
        # its devices, requests placed into each device's range by
        # cost-aware LPT bins (_slot_layout)
        self.mesh = cfg.mesh
        self.lanes = 1 if self.mesh is None else self.mesh.size
        if self.slots % self.lanes:
            raise ValueError(
                f"slots={self.slots} not divisible by the {self.lanes}-device "
                f"cores mesh")
        self.device = _device.resolve(
            self.mesh.devices[0] if cfg.device is None and self.mesh
            is not None else cfg.device)
        # keep the pad-to-pow2 contract whatever floor is passed
        self.min_bucket = 1 << (max(cfg.min_bucket, 2) - 1).bit_length()
        self.strategy = cfg.strategy
        self.n_cc = cfg.n_cc
        self.align = cfg.align
        self.on_chip_bytes = cfg.on_chip_bytes
        weights = cfg.weights
        if weights is None:
            weights = gnn_models.init_spec_weights(
                self.spec, seed=cfg.weight_seed, density=cfg.weight_density)
        # one device tensor per weight for the engine's lifetime: the
        # executor's input-profile cache is identity-keyed, so steady-state
        # waves never re-profile them
        self.weights = {name: torch.from_numpy(np.array(w, np.float32)).to(
                            self.device) for name, w in weights.items()}
        self.format_aware = cfg.format_aware
        self.csr_rmax = cfg.csr_rmax
        self.executor = runtime.FusedModelExecutor(
            strategy=cfg.strategy, model=cfg.cost_model, n_cc=cfg.n_cc,
            collect_report=cfg.collect_report, keep_codes=cfg.keep_codes,
            format_aware=cfg.format_aware, csr_rmax=cfg.csr_rmax)
        self._compiled: Dict[int, CompiledModel] = {}
        self._input_names: Dict[int, List[str]] = {}
        self._naive: Optional[runtime.DynasparseEngine] = None
        # serving counters (benchmark/test observability)
        self.waves = 0
        self.served = 0
        self.wave_walls: List[float] = []
        self.wave_loads: List[Tuple[int, int]] = []     # (real, slots)
        self.bucket_walls: Dict[int, List[float]] = {}
        # per-group-size walls (1 when unsharded): the resize scheduler's
        # per-size wall estimates seed from these
        self.group_walls: Dict[int, List[float]] = {}
        self.last_wave_report: Optional[runtime.InferenceReport] = None

    @classmethod
    def from_config(cls, config: EngineConfig) -> "GraphServeEngine":
        """An equivalent engine from a resolved :class:`EngineConfig`
        (weight generation is seeded, so the weights are the same)."""
        return cls(config=config)

    # -- admission ----------------------------------------------------------
    def _validate(self, req: GraphRequest) -> None:
        for name, arr in (("adjacency", req.adjacency),
                          ("features", req.features)):
            a = np.asarray(arr)
            # admission casts to float32; anything that cannot carry graph
            # numerics (complex, object, strings) is rejected here
            if not (np.issubdtype(a.dtype, np.floating)
                    or np.issubdtype(a.dtype, np.integer)
                    or a.dtype == np.bool_):
                raise ValueError(
                    f"request {req.request_id}: {name} dtype {a.dtype} is "
                    f"not numeric (float/int/bool)")
            # NaN/inf would flow through the degree sums of normalization
            if (np.issubdtype(a.dtype, np.floating)
                    and not np.isfinite(a).all()):
                raise ValueError(
                    f"request {req.request_id}: {name} contains non-finite "
                    f"values (NaN/inf)")
        if req.features.ndim != 2:
            raise ValueError(
                f"request {req.request_id}: features must be 2-D "
                f"(n_vertices, f_in), got shape {req.features.shape}")
        if req.features.shape[1] != self.f_in:
            raise ValueError(
                f"request {req.request_id}: feature width "
                f"{req.features.shape[1]} != engine f_in {self.f_in}")
        n = req.n_vertices
        if req.adjacency.shape != (n, n):
            raise ValueError(
                f"request {req.request_id}: adjacency "
                f"{req.adjacency.shape} != ({n}, {n}) for {n} feature rows")

    def bucket_for(self, n_vertices: int) -> int:
        """Smallest power of two >= max(n_vertices, min_bucket)."""
        b = self.min_bucket
        while b < n_vertices:
            b *= 2
        return b

    @property
    def buckets(self) -> List[int]:
        """Shape buckets compiled so far (one walk plan each)."""
        return sorted(self._compiled)

    def _compile(self, bucket: int) -> CompiledModel:
        cm = self._compiled.get(bucket)
        if cm is None:
            meta = GraphMeta(f"serve{bucket}", bucket, bucket * 8, self.f_in)
            cm = compiler.compile_model(
                self.spec, meta, n_cc=self.n_cc, align=self.align,
                on_chip_bytes=self.on_chip_bytes)
            self._compiled[bucket] = cm
            flows = runtime.FusedModelExecutor._resolved_flows(cm)
            self._input_names[bucket] = sorted(
                {f.source for pair in flows for f in pair
                 if f.producer is None and f.source not in self.weights})
        return cm

    def _input_shape(self, name: str, bucket: int) -> Tuple[int, int]:
        if name in ("A", "A_mean"):
            return (bucket, bucket)
        if name == "H0":
            return (bucket, self.f_in)
        raise KeyError(f"no admission builder for graph input {name!r}")

    def _fill_slot(self, req: GraphRequest,
                   views: Dict[str, np.ndarray]) -> None:
        """Normalize-then-fill ONE request into zero-initialized slot
        views (one (bucket, ...) view per graph input).  Normalization
        sees the true graph -- padding vertices stay isolated -- so
        real-vertex outputs do not depend on the bucket.  Feature rows
        come from the request's ``fill_features(view[:n])`` hook when it
        has one (a mini-batch ``SeedRequest`` copies its gathered rows
        straight into the slot view) and are a plain copy otherwise."""
        n = req.n_vertices
        adj = None
        for name, view in views.items():
            if name == "H0":
                fill = getattr(req, "fill_features", None)
                if fill is not None:
                    fill(view[:n])
                else:
                    view[:n] = np.asarray(req.features, np.float32)
            else:
                if adj is None:
                    adj = graph_data.normalize_adjacency(req.adjacency)
                view[:n, :n] = adj[0] if name == "A" else adj[1]

    def _padded(self, req: GraphRequest, bucket: int
                ) -> Dict[str, np.ndarray]:
        """One request's padded host inputs for this bucket's model
        (``run_naive``'s admission path)."""
        self._compile(bucket)
        out = {name: np.zeros(self._input_shape(name, bucket), np.float32)
               for name in self._input_names[bucket]}
        self._fill_slot(req, out)
        return out

    def cut_wave(self, entries: Sequence, *, force: bool = False
                 ) -> Tuple[list, list]:
        """Cut at most one wave off the front of a FIFO of entries.

        Returns ``(wave, rest)``: the first ``slots`` entries when a full
        wave is available; the whole (short) remainder when ``force`` is
        set (a deadline-, age- or drain-triggered partial wave); otherwise
        an empty wave and ``entries`` unchanged.  The synchronous
        :meth:`serve` and the continuous scheduler share it, so a wave
        never holds more than ``slots`` requests and each request lands in
        exactly one wave."""
        entries = list(entries)
        if len(entries) >= self.slots:
            return entries[: self.slots], entries[self.slots:]
        if force and entries:
            return entries, []
        return [], entries

    def _admit(self, requests: Sequence[GraphRequest]
               ) -> Dict[int, List[List[Tuple[int, GraphRequest]]]]:
        """Group by bucket (first-seen order), then cut into waves of at
        most ``slots`` requests each, first come first slotted (a trailing
        partial wave is padded with dummy slots)."""
        by_bucket: Dict[int, List[Tuple[int, GraphRequest]]] = {}
        for idx, req in enumerate(requests):
            self._validate(req)
            by_bucket.setdefault(self.bucket_for(req.n_vertices), []
                                 ).append((idx, req))
        out: Dict[int, List[List[Tuple[int, GraphRequest]]]] = {}
        for bucket, entries in by_bucket.items():
            waves = []
            while entries:
                wave, entries = self.cut_wave(entries, force=True)
                waves.append(wave)
            out[bucket] = waves
        return out

    def request_cost(self, req: GraphRequest) -> float:
        """Analyzer-predicted cost of one request (relative units): the
        Table IV cost of its Aggregate product at its measured adjacency
        and feature densities, under the engine's cost model -- the model
        the planner minimizes over, at request granularity.  The
        continuous scheduler's admission control converts it to seconds
        (``perf_model.CostCalibration``).

        Host numpy, as the reference computes it, so the float is the
        reference's.  Memoized on the request object under the engine's
        (cost model, f_in): requests are immutable once validated, and a
        request shared between engines with other models is re-costed."""
        memo_key = (self.executor.model, self.f_in)
        cached = getattr(req, "_dynasparse_cost", None)
        if cached is not None and cached[0] == memo_key:
            return cached[1]
        adj = np.asarray(req.adjacency)
        feat = np.asarray(req.features)
        n = max(req.n_vertices, 1)
        d_adj = float(np.count_nonzero(adj)) / max(adj.size, 1)
        d_feat = float(np.count_nonzero(feat)) / max(feat.size, 1)
        model = self.executor.model
        prim = model.select(d_adj, d_feat)
        cost = (0.0 if prim == Primitive.SKIP else
                float(model.cycles(prim, n, n, self.f_in, d_adj, d_feat)))
        req._dynasparse_cost = (memo_key, cost)
        return cost

    def _slot_layout(self, wave: Sequence[GraphRequest],
                     lanes: Optional[int] = None) -> List[int]:
        """Request -> slot placement of one wave over ``lanes`` devices
        (default: the engine mesh's size).

        One lane keeps the FIFO layout.  On a group of several, device d
        owns the slot range ``sharding.wave_slices(slots, lanes)[d]``;
        requests are LPT-binned over their :meth:`request_cost` (capacity:
        a device's slot count), so every device's walk carries a balanced
        predicted load, and dummies fill the slots left.  Placement never
        changes numerics (request isolation), only load balance."""
        lanes = self.lanes if lanes is None else lanes
        if lanes == 1:
            return list(range(len(wave)))
        ranges = sharding.wave_slices(self.slots, lanes)
        bins = core_scheduler.assign_bins(
            [self.request_cost(r) for r in wave], lanes,
            capacity=ranges[0].stop)
        next_slot = [r.start for r in ranges]
        slots = []
        for lane in bins:
            slots.append(next_slot[lane])
            next_slot[lane] += 1
        return slots

    # -- execution ----------------------------------------------------------
    def begin_wave(self, bucket: int, wave: Sequence[GraphRequest],
                   submesh: Optional[sharding.CoresMesh] = None
                   ) -> InFlightWave:
        """Launch one wave WITHOUT waiting for the device: fill one
        zero-initialized (slots, ...) host buffer per graph input, each
        request into its slot of :meth:`_slot_layout` (dummy slots stay
        zero), and hand the stacks to ``FusedModelExecutor.launch_batch``.

        Unsharded, each stack is copied to the device once; on a mesh,
        each lane's slot range goes to its own device (``sharding
        .shard_wave``, inside ``launch_batch``).  ``submesh`` runs THIS
        wave on one device group (a disjoint group of ``sharding
        .partition_mesh``) instead of the engine's mesh, placing its
        requests within that group's slot ranges only; ``slots`` must
        divide by the group's size.  Equal-size groups share one walk
        plan, so resizing groups between waves builds none.

        On the card the buffers are pinned and fresh per wave, so the copy
        is asynchronous and a wave can be filled while earlier ones run;
        :meth:`finish_wave` blocks and yields the results."""
        if not 0 < len(wave) <= self.slots:
            raise ValueError(
                f"wave of {len(wave)} requests (engine slots={self.slots})")
        mesh = self.mesh if submesh is None else submesh
        lanes = 1 if mesh is None else mesh.size
        if submesh is not None and self.slots % lanes:
            raise ValueError(
                f"slots={self.slots} not divisible by the {lanes}-device "
                f"submesh group")
        cm = self._compile(bucket)
        slot_of = self._slot_layout(wave, lanes)
        pin = (self.device.type == "cuda" if mesh is None
               else any(d.type == "cuda" for d in mesh.devices))
        t0 = time.perf_counter()
        host = {name: torch.zeros((self.slots,)
                                  + self._input_shape(name, bucket),
                                  dtype=torch.float32, pin_memory=pin)
                for name in self._input_names[bucket]}
        views = {name: buf.numpy() for name, buf in host.items()}
        for req, slot in zip(wave, slot_of):
            self._fill_slot(req, {name: buf[slot]
                                  for name, buf in views.items()})
        t1 = time.perf_counter()
        batched = host
        if mesh is None:
            batched = {name: buf.to(self.device, non_blocking=True)
                       for name, buf in host.items()}
        t2 = time.perf_counter()
        pending = self.executor.launch_batch(cm, self.weights, batched,
                                             mesh=mesh)
        index = self.waves
        self.waves += 1
        return InFlightWave(bucket=bucket, wave=list(wave), slot_of=slot_of,
                            pending=pending,
                            final=cm.graph.kernels[-1].out, index=index,
                            gather_seconds=t1 - t0, copy_seconds=t2 - t1)

    def finish_wave(self, inflight: InFlightWave) -> List[GraphResult]:
        """Block on a :meth:`begin_wave` launch, record the serving
        counters, stamp the wave report and slice per-request results back
        out of their slots (wave order)."""
        outs, rep = self.executor.finish_batch(inflight.pending)
        rep.wave_real = len(inflight.wave)
        rep.gather_seconds = inflight.gather_seconds
        rep.copy_seconds += inflight.copy_seconds
        self.last_wave_report = rep
        arr = outs[inflight.final].cpu().numpy()
        results = [GraphResult(req.request_id, arr[slot, : req.n_vertices],
                               inflight.bucket, inflight.index)
                   for slot, req in zip(inflight.slot_of, inflight.wave)]
        self.served += len(inflight.wave)
        self.wave_walls.append(rep.fused_wall_seconds)
        self.wave_loads.append((len(inflight.wave), self.slots))
        self.bucket_walls.setdefault(inflight.bucket, []).append(
            rep.fused_wall_seconds)
        self.group_walls.setdefault(inflight.pending.lanes, []).append(
            rep.fused_wall_seconds)
        return results

    def dispatch_wave(self, bucket: int, wave: Sequence[GraphRequest]
                      ) -> List[GraphResult]:
        """Execute one admission wave: :meth:`begin_wave` then
        :meth:`finish_wave`."""
        return self.finish_wave(self.begin_wave(bucket, wave))

    def serve(self, requests: Sequence[GraphRequest]) -> List[GraphResult]:
        """Serve a batch of queries; results in request order."""
        results: List[Optional[GraphResult]] = [None] * len(requests)
        for bucket, waves in self._admit(requests).items():
            for wave in waves:
                wave_results = self.dispatch_wave(
                    bucket, [req for _, req in wave])
                for (idx, _), res in zip(wave, wave_results):
                    results[idx] = res
        return results  # type: ignore[return-value]

    def run_naive(self, requests: Sequence[GraphRequest]
                  ) -> List[GraphResult]:
        """Per-request baseline AND bitwise parity oracle: the same
        pad-to-bucket admission, but one per-kernel ``DynasparseEngine.run``
        per request, with no wave batching."""
        if self._naive is None:
            self._naive = runtime.DynasparseEngine(
                strategy=self.strategy, model=self.executor.model,
                n_cc=self.n_cc, format_aware=self.format_aware,
                csr_rmax=self.csr_rmax)
        results = []
        for req in requests:
            self._validate(req)
            bucket = self.bucket_for(req.n_vertices)
            cm = self._compile(bucket)
            tensors = dict(self.weights)
            tensors.update({name: torch.from_numpy(v).to(self.device)
                            for name, v in self._padded(req, bucket).items()})
            env, _ = self._naive.run(cm, tensors)
            final = cm.graph.kernels[-1].out
            results.append(GraphResult(
                req.request_id, env[final].cpu().numpy()[: req.n_vertices],
                bucket, -1))
        return results
