"""Continuous deadline-aware GNN serving: queue -> cut -> pack -> stream.

Port of ``repro.serving.scheduler``.  The batched
:class:`~repro_torch.serving.graph_engine.GraphServeEngine` serves a
*synchronous* batch: every request is present up front and results come
back when the whole batch is done.  A deployed GNN service sees requests
that ARRIVE over time, carry deadlines, and want their result the moment
their wave completes.  :class:`ContinuousGraphServer` is that online layer:

* **Time-ordered queue.**  :meth:`~ContinuousGraphServer.submit` validates
  a request, assigns it to its shape bucket and appends it (with its
  arrival time and optional absolute deadline) to the bucket's queue.
  Nothing runs at submit time; :meth:`~ContinuousGraphServer.poll` is the
  scheduler tick.

* **Deadline-aware wave cutting.**  A bucket's queue is cut the moment a
  full wave of ``slots`` requests is there (reason ``"full"``).  A partial
  wave is cut early when the TIGHTEST queued deadline's slack has dropped
  to within the bucket's estimated wait bound (``"deadline"``), or when
  the oldest request has waited ``min(max_wait, batch_patience *
  estimate)`` (``"age"``, the starvation-freedom backstop).  The wait
  bound is the bucket's EWMA wave wall plus one estimated wave of every
  other bucket with queued work, packed over the waves in flight
  (``pipeline_depth``), scaled by ``slack_margin``.  The EWMA reads the
  engine's ``bucket_walls``: the launch-to-ready wall of each wave, which
  leaves out the host gather of ``begin_wave``.

* **Cross-bucket packing.**  The waves cut in one tick dispatch
  deadline/age cuts first, then in class-weighted LPT order over their
  estimated walls (``core.scheduler.schedule_weighted``).

* **Slot-level result streaming.**  ``poll`` returns the newly finished
  :class:`~repro_torch.serving.graph_engine.GraphResult` objects, stamped
  with ``completed_at`` and their ``deadline``;
  :meth:`~ContinuousGraphServer.drain` force-cuts everything left.

* **Overload control.**  ``submit`` returns a :class:`Ticket` with an
  admission verdict (``admit`` / ``admit-at-risk`` / ``shed``) from a
  predicted completion: the queue backlog packed over the EWMA walls, the
  request's own wave floored by its Analyzer cost
  (``GraphServeEngine.request_cost``) through a measured
  seconds-per-cost-unit calibration and by the measured cut -> delivery
  wall per wave.  The ``shed=`` policy decides whether a predicted miss is
  rejected.  Requests carry ``priority``/``tenant`` classes: full waves
  are composed highest class first (with an age backstop), and
  ``class_stats`` counts admitted/shed/met/missed per class.  Above
  ``pressure_threshold`` the backlog sheds at-risk queued work lowest
  class first.

None of this touches numerics: admitted results are bitwise
``GraphServeEngine.run_naive``'s whatever the priorities, deadlines,
arrival order or clock.  The clock is injectable (``clock=``, default
``time.monotonic``).  The server runs on whatever devices its engine has;
it reaches them only through ``begin_wave``/``finish_wave``.

* **Giant-graph queries.**  With a ``minibatch=`` planner
  (``serving.minibatch.MiniBatchPlanner``),
  :meth:`~ContinuousGraphServer.submit_query` takes seed vertices of one
  host graph: hot seeds are answered from the planner's cache, a seed
  already in flight is coalesced, the rest are sampled and submitted as
  requests with negative ids, and ``poll``/``drain`` route their results
  back to the waiting queries.  :meth:`~ContinuousGraphServer.apply_delta`
  streams edge deltas into the graph mid-stream.

* **Multi-device lanes.**  On an engine with a ``cores`` mesh the lanes
  default to one per device.  ``resize=True`` makes them DISJOINT device
  groups, replanned every tick from the queue (:func:`plan_groups`): a
  heavy wave takes a wide group while light waves take one device each,
  each wave running on its group alone (``begin_wave(submesh=...)``),
  at most one in flight per group.  Walls are then also tracked per group
  SIZE, and the wait bound packs over the planned groups.
  ``autoscale=True`` re-picks the number of groups every tick
  (:func:`plan_lanes`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import perf_model
from repro_torch.core import scheduler as core_scheduler
from repro_torch.distributed import sharding
from repro_torch.serving.config import UNSET, ServeConfig, merge_config
from repro_torch.serving.graph_engine import (GraphRequest, GraphResult,
                                              GraphServeEngine)
from repro_torch.serving.minibatch import DeltaReport, QueryTicket


def plan_groups(n_devices: int, demands: Sequence[float], slots: int,
                max_groups: Optional[int] = None) -> List[int]:
    """Disjoint device-group sizes for one dispatch tick.

    Given ``n_devices`` mesh devices, the estimated walls of the waves
    wanting to run (``demands``) and the engine's wave ``slots``, returns
    group sizes for ``sharding.partition_mesh``: each positive, dividing
    ``slots`` (a wave's slots split evenly over its group), summing to
    ``n_devices``.

    The first ``k = min(len(demands), n_devices, max_groups)`` entries are
    the demand-assigned groups, aligned with ``demands`` sorted descending
    (largest demand <-> widest group); trailing 1s are devices left idle
    this tick.  Groups start at one device each, and the group with the
    highest remaining demand/size ratio doubles while spare devices
    allow: a lone heavy wave takes the whole mesh, many light waves one
    device each."""
    if n_devices < 1:
        raise ValueError(f"plan_groups over {n_devices} devices")
    if slots < 1:
        raise ValueError(f"plan_groups with {slots} wave slots")
    dem = [float(x) for x in demands]
    if not dem:
        raise ValueError("plan_groups with no demands")
    if any(x < 0 for x in dem):
        raise ValueError(f"negative demand in {demands}")
    k = min(len(dem), n_devices)
    if max_groups is not None:
        if max_groups < 1:
            raise ValueError(f"max_groups {max_groups} < 1")
        k = min(k, max_groups)
    dem = sorted(dem, reverse=True)[:k]
    sizes = [1] * k
    spare = n_devices - k
    while spare > 0:
        best, best_ratio = -1, -1.0
        for i in range(k):
            doubled = sizes[i] * 2
            if sizes[i] > spare:           # doubling adds sizes[i] devices
                continue
            if doubled > slots or slots % doubled:
                continue                   # a group must divide the slots
            ratio = dem[i] / sizes[i]
            if ratio > best_ratio:
                best, best_ratio = i, ratio
        if best < 0:
            break
        spare -= sizes[best]
        sizes[best] *= 2
    # greedy by ratio keeps the sizes descending beside the sorted demands
    # (equal sizes tie toward the larger demand)
    return sizes + [1] * spare


def plan_lanes(n_devices: int, demands: Sequence[float], slots: int,
               max_lanes: int,
               size_wall: Optional[Callable[[int], float]] = None) -> int:
    """The number of groups whose :func:`plan_groups` split finishes first.

    For each candidate count ``k`` up to ``max_lanes``, plan the group
    sizes and pack the ``demands`` (estimated wave walls) longest first
    over the ``k`` groups, each wave costed at no less than its group's
    per-size wall ``size_wall(size)`` (``None``: no floor); return the
    ``k`` of the smallest predicted finish.  Ties prefer MORE groups, so
    a backlog of light waves spreads out while a lone heavy wave takes
    one full-mesh group."""
    if max_lanes < 1:
        raise ValueError(f"max_lanes {max_lanes} < 1")
    dem = sorted((float(x) for x in demands), reverse=True)
    if not dem:
        raise ValueError("plan_lanes with no demands")
    best_k, best_t = 1, math.inf
    for k in range(1, min(len(dem), n_devices, max_lanes) + 1):
        sizes = plan_groups(n_devices, dem, slots, max_groups=k)
        finish = [0.0] * k
        for c in dem:
            g = min(range(k), key=lambda j: (finish[j], j))
            floor = size_wall(sizes[g]) if size_wall is not None else 0.0
            finish[g] += max(c, floor)
        t = max(finish)
        if t <= best_t + 1e-12:
            best_k, best_t = k, min(t, best_t)
    return best_k


class Ticket(int):
    """Admission ticket returned by :meth:`ContinuousGraphServer.submit`.

    An ``int`` subclass whose value IS the submission sequence number
    (``int(ticket)``, hashing, dict keys and f-strings behave as a bare
    int), carrying the admission decision:

    * ``verdict`` -- ``"admit"`` | ``"admit-at-risk"`` | ``"shed"``
      (``admitted`` is the convenience bool; a shed request never
      produces a result);
    * ``predicted_miss`` -- completion was predicted past the deadline at
      submit time, whatever the shed policy did about it;
    * ``predicted_wall`` -- the predicted seconds until the result;
    * ``bucket``, ``priority``, ``tenant``, ``deadline`` -- the
      admission-time classification, echoed back.

    The verdict bands, in classification order (``slack`` is ``deadline -
    now``, infinite without a deadline; ``W`` is ``predicted_wall``; ``m``
    is the server's ``admit_margin >= 1``):

    ===================================  ===============================
    band                                 verdict
    ===================================  ===============================
    queue full (``shed="capacity"``      ``"shed"`` (before any
    and ``pending >= max_pending``)      prediction is consulted)
    ``slack < W`` (a predicted miss)     ``"shed"`` under
                                         ``shed="predicted-miss"``,
                                         else ``"admit-at-risk"``
    ``W <= slack < m * W``               ``"admit-at-risk"``
    ``slack >= m * W``                   ``"admit"``
    ===================================  ===============================
    """

    def __new__(cls, seq: int, *, bucket: int = 0,
                predicted_wall: float = 0.0, verdict: str = "admit",
                predicted_miss: bool = False, priority: int = 0,
                tenant: str = "default",
                deadline: Optional[float] = None):
        self = super().__new__(cls, seq)
        self.bucket = int(bucket)
        self.predicted_wall = float(predicted_wall)
        self.verdict = str(verdict)
        self.predicted_miss = bool(predicted_miss)
        self.priority = int(priority)
        self.tenant = str(tenant)
        self.deadline = deadline
        return self

    @property
    def seq(self) -> int:
        return int(self)

    @property
    def admitted(self) -> bool:
        return self.verdict != "shed"

    def __repr__(self) -> str:
        return (f"Ticket({int(self)}, bucket={self.bucket}, "
                f"verdict={self.verdict!r}, "
                f"predicted_wall={self.predicted_wall:.4g}, "
                f"predicted_miss={self.predicted_miss}, "
                f"priority={self.priority}, tenant={self.tenant!r})")

    # printing or formatting a ticket gives the bare number; only repr is
    # structured
    __str__ = int.__repr__


@dataclasses.dataclass
class ClassStats:
    """Per-(tenant, priority) serving counters.

    ``admitted`` counts requests enqueued at submit; ``shed`` counts door
    rejections plus queued requests shed later; ``met``/``missed`` split
    delivered results by deadline outcome (deadline-less deliveries count
    as ``met``).  Conservation: submits == admitted + door sheds, and
    admitted == delivered + later sheds + still queued.
    """

    admitted: int = 0
    shed: int = 0
    met: int = 0
    missed: int = 0

    @property
    def delivered(self) -> int:
        return self.met + self.missed


@dataclasses.dataclass
class QueuedRequest:
    """One queue entry: the request plus its admission-time metadata."""

    seq: int                        # submission order (ticket id)
    request: GraphRequest
    bucket: int
    arrival: float                  # clock time at submit
    deadline: Optional[float]       # ABSOLUTE clock deadline (None = none)
    priority: int = 0               # class: higher dispatches sooner
    tenant: str = "default"         # accounting stream for class_stats
    cost: float = 0.0               # Analyzer cost units (calibration)
    ticket: Optional[Ticket] = None


@dataclasses.dataclass
class WaveLog:
    """Dispatch-log entry: one cut wave, why it was cut, what it cost."""

    bucket: int
    n_real: int                     # real (non-dummy) requests in the wave
    reason: str                     # "full" | "deadline" | "age" | "drain"
    cut_at: float                   # clock time the cut decision was made
    wall: float                     # launch-to-ready wall (engine-measured)
    lane: int = 0                   # dispatch lane the wave was pulled by
    group_size: int = 1             # devices the wave ran on
    classes: Dict[int, int] = dataclasses.field(default_factory=dict)
    #                                 priority -> real-request count


class _EwmaWall:
    """EWMA wave-wall estimate with an explicit cold start.

    ``observe`` folds each measured wall in with weight ``alpha``; before
    the first observation the estimate is the seed (the MINIMUM of the
    engine's recorded walls: their outliers, such as a bucket's first wave
    that builds its walk plan, are always upward) or ``cold_start``.
    """

    def __init__(self, alpha: float, seed: Optional[float],
                 cold_start: float):
        self.alpha = alpha
        self.value = cold_start if seed is None else float(seed)

    def observe(self, wall: float) -> None:
        self.value += self.alpha * (float(wall) - self.value)


class ContinuousGraphServer:
    """Deadline-aware online scheduler over a :class:`GraphServeEngine`.

    >>> eng = GraphServeEngine("gcn", f_in=64, n_classes=7, slots=4)
    >>> srv = ContinuousGraphServer(eng)        # or config=ServeConfig(...)
    >>> t = srv.submit(req, deadline=srv.clock() + 0.05, priority=1)
    >>> int(t), t.verdict, t.predicted_miss    # Ticket is an int subclass
    (0, 'admit', False)
    >>> done = srv.poll()          # dispatches any cuttable waves
    >>> tail = srv.drain()         # force-flush at shutdown

    Contracts:

    * every admitted request is dispatched in exactly one wave of at most
      ``engine.slots`` requests, eventually (full cut, deadline cut,
      ``max_wait`` age cut, or :meth:`drain`), or shed and logged in
      ``shed_log``;
    * results are bitwise ``engine.run_naive``'s on the same requests, and
      ``engine.executor.trace_count`` grows by at most one per bucket (per
      (bucket, group size) under ``resize=True``);
    * within one :meth:`poll`, cut waves dispatch urgent cuts first, then
      in weighted LPT order over the EWMA estimates, each pulled by the
      earliest-idle of the ``n_lanes`` lanes, with at most
      ``pipeline_depth`` waves in flight;
    * ``dispatch_log`` records every wave (bucket, real slots, cut reason,
      cut time, measured wall, lane, group size, class composition).

    ``resize=True`` (an engine with a mesh) switches the lanes from slot
    ranges of one shared mesh to DISJOINT device groups, replanned between
    waves by :func:`plan_groups` (:meth:`_dispatch_groups`).  Walls are
    also tracked per group SIZE (:meth:`group_estimate`), the wait bound
    packs over the planned groups, and ``n_lanes=1`` always plans the one
    full-mesh group: the shared-mesh single lane, exactly.

    The knobs form a :class:`ServeConfig` (``config=`` /
    :meth:`from_config`; the resolved config is ``self.config``), merged
    with explicit kwargs as :class:`EngineConfig` is.
    """

    def __init__(self, engine: GraphServeEngine, *,
                 config: Optional[ServeConfig] = None,
                 clock: Callable[[], float] = UNSET,
                 ewma_alpha: float = UNSET,
                 cold_start_wall: float = UNSET,
                 slack_margin: float = UNSET,
                 batch_patience: float = UNSET,
                 max_wait: float = UNSET,
                 n_lanes: Optional[int] = UNSET,
                 resize: bool = UNSET,
                 shed: str = UNSET,
                 admit_margin: float = UNSET,
                 max_pending: Optional[int] = UNSET,
                 pressure_threshold: float = UNSET,
                 priority_weight: float = UNSET,
                 autoscale: bool = UNSET,
                 minibatch=UNSET):
        cfg = merge_config(ServeConfig, config, dict(
            clock=clock, ewma_alpha=ewma_alpha,
            cold_start_wall=cold_start_wall, slack_margin=slack_margin,
            batch_patience=batch_patience, max_wait=max_wait,
            n_lanes=n_lanes, resize=resize, shed=shed,
            admit_margin=admit_margin, max_pending=max_pending,
            pressure_threshold=pressure_threshold,
            priority_weight=priority_weight, autoscale=autoscale,
            minibatch=minibatch)).validate()
        if cfg.resize and engine.mesh is None:
            raise ValueError(
                "resize=True needs an engine with a cores mesh to partition")
        self.config = cfg
        self.engine = engine
        self.clock = cfg.clock
        self.ewma_alpha = cfg.ewma_alpha
        self.cold_start_wall = cfg.cold_start_wall
        self.slack_margin = cfg.slack_margin
        self.batch_patience = cfg.batch_patience
        self.max_wait = cfg.max_wait
        self.shed = cfg.shed
        self.admit_margin = cfg.admit_margin
        self.max_pending = cfg.max_pending
        self.pressure_threshold = cfg.pressure_threshold
        self.priority_weight = cfg.priority_weight
        # one lane per device of the engine's mesh by default (1 unsharded)
        self.n_lanes = (engine.lanes if cfg.n_lanes is None
                        else int(cfg.n_lanes))
        # resize mode: the lanes are disjoint device groups of the mesh,
        # replanned every tick (plan_groups), with per-group-SIZE EWMA
        # walls seeded from the engine's group_walls
        self._resize = bool(cfg.resize)
        self._autoscale = bool(cfg.autoscale)
        self.n_devices = engine.lanes
        self._group_ewma: Dict[int, _EwmaWall] = {}
        self.last_group_sizes: List[int] = []
        self.last_auto_lanes: Optional[int] = None
        self._queues: Dict[int, List[QueuedRequest]] = {}
        self._ewma: Dict[int, _EwmaWall] = {}
        # per-lane EWMA of the walls of the waves each lane pulled; the
        # cold start stays pessimistic, keeping a multi-lane wait bound
        # high until every lane has run a wave
        self._lane_ewma: List[_EwmaWall] = [
            _EwmaWall(cfg.ewma_alpha, None, cfg.cold_start_wall)
            for _ in range(self.n_lanes)]
        # round-robin tie-break for idle-lane selection: ticks that cut a
        # single wave would otherwise always pick lane 0
        self._next_lane = 0
        # results harvested in a tick that then failed mid-dispatch: the
        # next poll()/drain() delivers them
        self._undelivered: List[GraphResult] = []
        self._seq = 0
        self.dispatch_log: List[WaveLog] = []
        self.submitted = 0
        self.dispatched = 0
        self.class_stats: Dict[Tuple[str, int], ClassStats] = {}
        self.shed_log: List[Ticket] = []
        self.admitted = 0
        self.shed_at_submit = 0
        self.shed_under_pressure = 0
        self.peak_pressure = 0.0
        # the giant-graph front door: the planner samples one subgraph per
        # seed vertex, answers hot seeds from its cache, and its negative
        # request ids map wave results back to the waiting queries
        # (whole-graph submit() callers keep ids non-negative)
        self.minibatch = cfg.minibatch
        self._query_seq = 0
        self.queries_submitted = 0
        self._query_waiters: Dict[int, List[QueryTicket]] = {}  # rid -> qts
        self._inflight_seed: Dict[int, int] = {}    # vertex -> request_id
        # seconds per Analyzer cost unit, from each dispatched wave's cost
        # against its measured wall: admission floors a request's own wave
        # by its predicted cost even while its bucket's EWMA is cold
        self._calib = perf_model.CostCalibration(alpha=cfg.ewma_alpha)
        # EWMA of each wave's real count (seeded at full occupancy): under
        # deadline pressure waves cut partial, so clearing q requests costs
        # ceil(q / measured-real-per-wave) walls, not ceil(q / slots)
        self._occupancy = _EwmaWall(cfg.ewma_alpha, float(engine.slots),
                                    float(engine.slots))
        # server-level cut -> delivery wall per wave, a floor for the
        # admission and backlog models only: the bucket EWMAs read the
        # launch-to-ready wall, which leaves out the host gather.  Cold
        # start 0.0 = no floor.
        self._wave_floor = _EwmaWall(cfg.ewma_alpha, None, 0.0)
        # EWMA of (actual sojourn / the sojourn the ticket predicted),
        # observed at every delivery; only ratios > 1 scale admission
        # (an optimistic model must be corrected, a pessimistic one errs
        # safe)
        self._model_bias = _EwmaWall(cfg.ewma_alpha, 1.0, 1.0)

    @classmethod
    def from_config(cls, engine: GraphServeEngine,
                    config: ServeConfig) -> "ContinuousGraphServer":
        """``ContinuousGraphServer.from_config(srv.engine, srv.config)``
        builds a server with the same policy."""
        return cls(engine, config=config)

    # -- queue --------------------------------------------------------------
    def submit(self, request: GraphRequest,
               deadline: Optional[float] = None, *,
               priority: int = 0, tenant: str = "default") -> Ticket:
        """Enqueue one request; returns its admission :class:`Ticket`.

        ``deadline`` is an ABSOLUTE time on this server's clock (pass
        ``srv.clock() + budget``); ``None`` means best-effort -- the
        request still dispatches within ``max_wait`` and is never shed by
        prediction.  ``priority`` (higher = more urgent) and ``tenant``
        set the request's class; neither changes numerics.  The request is
        validated here, and a shed ticket's request is NOT queued (check
        ``ticket.admitted``)."""
        self.engine._validate(request)
        bucket = self.engine.bucket_for(request.n_vertices)
        now = self.clock()
        cost = float(self.engine.request_cost(request))
        bound = (self.admission_estimate(bucket, cost)
                 * max(1.0, self._model_bias.value))
        slack = math.inf if deadline is None else deadline - now
        predicted_miss = slack < bound
        if (self.shed == "capacity" and self.max_pending is not None
                and self.pending >= self.max_pending):
            verdict = "shed"
        elif predicted_miss:
            verdict = ("shed" if self.shed == "predicted-miss"
                       else "admit-at-risk")
        elif slack < self.admit_margin * bound:
            verdict = "admit-at-risk"
        else:
            verdict = "admit"
        seq = self._seq
        self._seq += 1
        self.submitted += 1
        ticket = Ticket(seq, bucket=bucket, predicted_wall=bound,
                        verdict=verdict, predicted_miss=predicted_miss,
                        priority=int(priority), tenant=str(tenant),
                        deadline=deadline)
        stats = self._stats_for(ticket.tenant, ticket.priority)
        if verdict == "shed":
            stats.shed += 1
            self.shed_at_submit += 1
            self.shed_log.append(ticket)
            return ticket
        stats.admitted += 1
        self.admitted += 1
        self._queues.setdefault(bucket, []).append(QueuedRequest(
            seq, request, bucket, now, deadline, priority=ticket.priority,
            tenant=ticket.tenant, cost=cost, ticket=ticket))
        return ticket

    def submit_query(self, seeds: Sequence[int],
                     deadline: Optional[float] = None, *,
                     priority: int = 0, tenant: str = "default"
                     ) -> QueryTicket:
        """Enqueue one mini-batch QUERY -- seed vertices of the planner's
        host graph -- alongside whole-graph :meth:`submit` traffic.

        Per unique seed vertex: a cache hit answers at once; a vertex
        already in flight coalesces (one sampled request serves every
        query waiting on it -- exact, because each vertex's subgraph is
        sampled under its own derived seed); otherwise the planner samples
        the vertex's subgraph and the request goes through the admission
        door (deadline, priority and tenant apply per seed request; a shed
        seed is listed on ``ticket.shed_seeds`` and its row is NaN).
        Coalescing is version-checked on both axes of mutation: a query
        does not join an in-flight request that gathered features before a
        store update or was sampled before an edge delta, so no result
        reflects features or topology older than its own submission.

        Returns a :class:`~repro_torch.serving.minibatch.QueryTicket` whose
        rows fill as :meth:`poll`/:meth:`drain` complete waves.  Needs a
        ``minibatch=`` planner.
        """
        planner = self.minibatch
        if planner is None:
            raise ValueError(
                "submit_query needs a minibatch planner: "
                "ContinuousGraphServer(engine, "
                "minibatch=MiniBatchPlanner(graph, store, ...))")
        qt = QueryTicket(self._query_seq, [int(v) for v in seeds],
                         deadline=deadline)
        self._query_seq += 1
        self.queries_submitted += 1
        for v in dict.fromkeys(qt.seeds):
            row = planner.lookup(v)
            if row is not None:
                qt.from_cache += 1
                qt._fill(v, row)
                continue
            qt._pending.add(v)
            rid = self._inflight_seed.get(v)
            if rid is not None and rid in self._query_waiters:
                inflight = planner.inflight_request(rid)
                if (inflight is not None
                        and inflight.store_version == planner.store.version
                        and inflight.graph_version == planner.graph_version):
                    self._query_waiters[rid].append(qt)
                    continue
            req = planner.request_for(v)
            ticket = self.submit(req, deadline, priority=priority,
                                 tenant=tenant)
            qt.tickets.append(ticket)
            if not ticket.admitted:
                planner.abandon(req)
                qt.shed_seeds.append(v)
                qt._fill(v, None)
                continue
            self._query_waiters[req.request_id] = [qt]
            self._inflight_seed[v] = req.request_id
        return qt

    def apply_delta(self, edge_inserts: Sequence = (),
                    edge_deletes: Sequence = ()) -> DeltaReport:
        """Stream an edge delta into the served giant graph: the planner's
        :meth:`~repro_torch.serving.minibatch.MiniBatchPlanner.apply_delta`,
        whose :class:`~repro_torch.serving.minibatch.DeltaReport` it
        returns.  Safe mid-stream: requests in flight were sampled from
        the old topology and still deliver, but their rows are never
        cached and later queries never coalesce onto them."""
        if self.minibatch is None:
            raise ValueError(
                "apply_delta needs a minibatch planner: "
                "ContinuousGraphServer(engine, "
                "minibatch=MiniBatchPlanner(graph, store, ...))")
        return self.minibatch.apply_delta(
            edge_inserts, edge_deletes, strategy=self.engine.strategy,
            cost_model=self.engine.executor.model)

    def _route(self, results: List[GraphResult]) -> List[GraphResult]:
        """Split a tick's delivered results: planner-issued seed requests
        go to their waiting query tickets (filling the vertex cache via
        ``planner.complete``); everything else streams back to the
        whole-graph caller unchanged."""
        if self.minibatch is None or not self._query_waiters:
            return results
        out = []
        for res in results:
            waiters = self._query_waiters.pop(res.request_id, None)
            if waiters is None:
                out.append(res)
                continue
            vertex, row = self.minibatch.complete(res)
            if self._inflight_seed.get(vertex) == res.request_id:
                del self._inflight_seed[vertex]
            for qt in waiters:
                qt._fill(vertex, row, completed_at=res.completed_at)
        return out

    def _stats_for(self, tenant: str, priority: int) -> ClassStats:
        key = (tenant, priority)
        stats = self.class_stats.get(key)
        if stats is None:
            stats = self.class_stats[key] = ClassStats()
        return stats

    def _account_delivery(self, entry: QueuedRequest, done_at: float) -> None:
        stats = self._stats_for(entry.tenant, entry.priority)
        if entry.deadline is None or done_at <= entry.deadline:
            stats.met += 1
        else:
            stats.missed += 1
        # actual sojourn against the sojourn this ticket predicted (clamped:
        # one outlier must not swing the EWMA by orders of magnitude)
        if entry.ticket is not None and entry.ticket.predicted_wall > 1e-9:
            ratio = (done_at - entry.arrival) / entry.ticket.predicted_wall
            self._model_bias.observe(min(8.0, max(0.25, ratio)))

    @staticmethod
    def _wave_classes(wave: List[QueuedRequest]) -> Dict[int, int]:
        classes: Dict[int, int] = {}
        for e in wave:
            classes[e.priority] = classes.get(e.priority, 0) + 1
        return classes

    @property
    def pending(self) -> int:
        """Requests queued but not yet dispatched."""
        return sum(len(q) for q in self._queues.values())

    @property
    def pressure(self) -> float:
        """Current backlog pressure gauge: :meth:`backlog_bound` seconds."""
        return self.backlog_bound()

    def estimate(self, bucket: int) -> float:
        """Current EWMA wave-wall estimate for ``bucket`` (seconds)."""
        return self._ewma_for(bucket).value

    def _ewma_for(self, bucket: int) -> _EwmaWall:
        est = self._ewma.get(bucket)
        if est is None:
            own = self.engine.bucket_walls.get(bucket)
            if own:
                seed = float(np.min(own))
            elif self.engine.wave_walls:
                # a never-run bucket: another bucket's wall is the wrong
                # scale (a small bucket's would defer a large one's
                # deadline cuts past rescue), so clamp to cold_start_wall
                seed = max(float(np.min(self.engine.wave_walls)),
                           self.cold_start_wall)
            else:
                seed = None
            est = _EwmaWall(self.ewma_alpha, seed, self.cold_start_wall)
            self._ewma[bucket] = est
        return est

    def lane_estimate(self, lane: int) -> float:
        """Current EWMA wall (seconds) of the waves ``lane`` has pulled."""
        return self._lane_ewma[lane].value

    def group_estimate(self, size: int) -> float:
        """Current EWMA wall (seconds) of the waves run on a ``size``-device
        group (resize mode)."""
        return self._size_wall(size).value

    def _size_wall(self, size: int) -> _EwmaWall:
        est = self._group_ewma.get(size)
        if est is None:
            own = self.engine.group_walls.get(size)
            seed = float(np.min(own)) if own else None
            est = _EwmaWall(self.ewma_alpha, seed, self.cold_start_wall)
            self._group_ewma[size] = est
        return est

    @property
    def pipeline_depth(self) -> int:
        """Waves kept in flight at once.  Lanes of a shared mesh: ``min(
        n_lanes, 2)`` -- two waves in flight let one wave's host gather
        overlap the other's device work, and deeper queues only pile work
        onto the same devices.  Resize mode: ``n_lanes``, since disjoint
        groups are separate devices and ``_dispatch_groups`` keeps at most
        one wave in flight per group.  ``wait_bound`` packs over this same
        depth."""
        if self._resize:
            return self.n_lanes
        return min(self.n_lanes, 2)

    # -- wave cutting -------------------------------------------------------
    def wait_bound(self, bucket: int) -> float:
        """Worst-case wait (seconds) for a wave cut from ``bucket`` NOW:
        the bucket's estimated wall plus one estimated wave of every OTHER
        bucket with queued work (those may cut in the same tick and go
        first), packed over the dispatch concurrency (:meth:`_pack_bound`)
        and scaled by ``slack_margin``."""
        costs = [self.estimate(bucket)]
        for b, q in self._queues.items():
            if b != bucket and q:
                costs.append(self.estimate(b))
        return self._pack_bound(costs) * self.slack_margin

    def _pack_bound(self, costs: List[float]) -> float:
        """Predicted finish (seconds, unscaled) of ``costs`` estimated wave
        walls: the serial sum with one lane; else the LPT makespan over
        ``pipeline_depth`` with each wave floored by the average per-lane
        EWMA wall (lane walls are launch -> ready, so waves that contend
        inflate them and the bound returns toward the serial sum).  Resize
        mode: longest first over the groups :func:`plan_groups` would cut
        now, each wave floored by its group's per-size EWMA wall (one
        group: the serial sum)."""
        if not costs:
            return 0.0
        if self._resize:
            k = min(len(costs), self.n_devices, self.n_lanes)
            if k == 1:
                return float(sum(costs))
            sizes = plan_groups(self.n_devices,
                                sorted(costs, reverse=True),
                                self.engine.slots, max_groups=self.n_lanes)
            finish = [0.0] * k
            for c in sorted(costs, reverse=True):
                g = min(range(k), key=lambda j: (finish[j], j))
                finish[g] += max(c, self._size_wall(sizes[g]).value)
            return max(finish)
        if self.n_lanes == 1:
            return float(sum(costs))
        lane_wall = float(np.mean([e.value for e in self._lane_ewma]))
        return core_scheduler.schedule_lpt(
            [max(c, lane_wall) for c in costs], self.pipeline_depth).makespan

    def backlog_bound(self) -> float:
        """Predicted seconds to clear the ENTIRE queue as of now: every
        implied wave (``ceil(queued / per-wave)`` per bucket, counted
        against the measured occupancy, :meth:`_per_wave`), each floored
        by the measured cut -> delivery wall, packed over the dispatch
        concurrency.  The pressure gauge; not scaled by ``slack_margin``.
        ``0.0`` with an empty queue."""
        costs: List[float] = []
        per_wave = self._per_wave()
        floor = self._wave_floor.value
        for b, q in self._queues.items():
            if q:
                n_waves = math.ceil(len(q) / per_wave)
                costs.extend([max(self.estimate(b), floor)] * n_waves)
        return self._pack_bound(costs)

    def _per_wave(self) -> float:
        """Effective requests per dispatched wave: the occupancy EWMA,
        clamped to [1, slots]."""
        return min(float(self.engine.slots), max(1.0, self._occupancy.value))

    def admission_estimate(self, bucket: int, cost: float = 0.0) -> float:
        """Predicted seconds until a request submitted to ``bucket`` NOW
        has its result: the backlog's implied waves plus the request's own
        wave, packed over the dispatch concurrency.  The own wave costs the
        bucket's EWMA estimate floored by the request's calibrated
        Analyzer cost and by the measured cut -> delivery wall; in the own
        bucket only the FULL waves queue ahead.  Unscaled (the headroom is
        ``admit_margin``'s job)."""
        floor = self._wave_floor.value
        own = max(self.estimate(bucket), self._calib.seconds(cost, 0.0),
                  floor)
        costs = [own]
        per_wave = self._per_wave()
        for b, q in self._queues.items():
            if not q:
                continue
            n_waves = (int(len(q) // per_wave) if b == bucket
                       else math.ceil(len(q) / per_wave))
            costs.extend([max(self.estimate(b), floor)] * n_waves)
        return self._pack_bound(costs)

    def _shed_pressure(self, now: float, bound: float) -> None:
        """Once the backlog bound exceeds ``pressure_threshold``, shed
        every queued request with a deadline that is predicted to miss at
        the current bound, lowest class first and newest first within a
        class, recomputing the bound after each shed; stop when nobody
        left is predicted to miss.  Shed entries are accounted like door
        sheds; deadline-less requests are never pressure-shed."""
        if bound <= self.pressure_threshold:
            return
        while True:
            at_risk = [e for q in self._queues.values() for e in q
                       if e.deadline is not None and e.deadline - now < bound]
            if not at_risk:
                return
            victim = min(at_risk, key=lambda e: (e.priority, -e.seq))
            self._queues[victim.bucket].remove(victim)
            stats = self._stats_for(victim.tenant, victim.priority)
            stats.shed += 1
            self.shed_under_pressure += 1
            self.shed_log.append(victim.ticket)
            bound = self.backlog_bound()

    def _cut_reason(self, bucket: int, queue: List[QueuedRequest],
                    now: float) -> Optional[str]:
        """Why the FRONT of ``queue`` should be cut right now, if at all."""
        if not queue:
            return None
        if len(queue) >= self.engine.slots:
            return "full"
        # min over ALL arrivals: class ordering may have moved a newer
        # high-priority entry to the front
        oldest = min(e.arrival for e in queue)
        # a forced cut takes the whole (sub-slots) queue, so the tightest
        # deadline of ANY queued request cuts, not just the head's
        deadlines = [e.deadline for e in queue if e.deadline is not None]
        if deadlines:
            slack = min(deadlines) - now
            if slack <= self.wait_bound(bucket):
                return "deadline"
        # a partial wave older than about one wave wall has nothing left to
        # gain from waiting; max_wait is the absolute backstop
        patience = min(self.max_wait,
                       self.batch_patience * self.estimate(bucket))
        if now - oldest >= patience:
            return "age"
        return None

    def _class_order(self, queue: List[QueuedRequest],
                     now: float) -> List[QueuedRequest]:
        """Wave-composition order for one bucket queue: highest effective
        class first, FIFO (seq) within a class.  An entry that has waited
        ``max_wait`` ranks above every real class (the per-class
        starvation backstop).  A single-class un-aged queue comes back
        unchanged."""
        effs = [math.inf if now - e.arrival >= self.max_wait
                else float(e.priority) for e in queue]
        if all(x == effs[0] for x in effs):
            return queue
        order = sorted(range(len(queue)),
                       key=lambda i: (-effs[i], queue[i].seq))
        return [queue[i] for i in order]

    def _shed_doomed(self, bucket: int, queue: List[QueuedRequest],
                     now: float) -> List[QueuedRequest]:
        """Under ``shed="predicted-miss"``, drop queued entries whose
        remaining slack is below their own wave's wall (the EWMA estimate
        floored by the measured cut -> delivery wall, times
        ``slack_margin``): dispatching them would only turn a shed into a
        certain miss and take a slot from a live request.  Accounted like
        pressure sheds; a no-op under every other policy."""
        if self.shed != "predicted-miss":
            return queue
        wall = (max(self.estimate(bucket), self._wave_floor.value)
                * self.slack_margin)
        kept: List[QueuedRequest] = []
        for e in queue:
            if e.deadline is None or e.deadline - now >= wall:
                kept.append(e)
                continue
            stats = self._stats_for(e.tenant, e.priority)
            stats.shed += 1
            self.shed_under_pressure += 1
            self.shed_log.append(e.ticket)
        return kept

    def _cut_ready(self, now: float, *, drain: bool = False
                   ) -> List[tuple]:
        """Cut every currently cuttable wave; returns [(bucket, entries,
        reason, cut_at)] with the queues updated in place."""
        ready = []
        for bucket, queue in self._queues.items():
            queue = self._shed_doomed(bucket, queue, now)
            queue = self._class_order(queue, now)
            while True:
                reason = "drain" if drain and queue else None
                reason = self._cut_reason(bucket, queue, now) or reason
                if reason is None:
                    break
                wave, queue = self.engine.cut_wave(
                    queue, force=reason != "full")
                if not wave:
                    break
                ready.append((bucket, wave, reason, now))
            self._queues[bucket] = queue
        return ready

    def _wave_weight(self, wave: List[QueuedRequest]) -> float:
        """``priority_weight ** p`` for the wave's highest priority ``p``
        (exponent clamped to +-64); all-default waves weigh 1.0."""
        p = max(e.priority for e in wave)
        return float(self.priority_weight) ** max(-64, min(64, p))

    def _pack_order(self, ready: List[tuple]) -> List[tuple]:
        """Urgent (deadline/age) cuts first, then each group in
        ``core.scheduler.schedule_weighted`` order over the EWMA estimates
        and the waves' class weights (all weights 1.0: ``schedule_lpt``'s
        order)."""
        if len(ready) <= 1:
            return ready

        def wlpt(group: List[tuple]) -> List[tuple]:
            if len(group) <= 1:
                return group
            costs = [self.estimate(bucket) for bucket, _, _, _ in group]
            weights = [self._wave_weight(wave) for _, wave, _, _ in group]
            order = core_scheduler.schedule_weighted(
                costs, weights, 1).assignment[0]
            return [group[i] for i in order]

        urgent = [r for r in ready if r[2] in ("deadline", "age")]
        rest = [r for r in ready if r[2] not in ("deadline", "age")]
        return wlpt(urgent) + wlpt(rest)

    # -- scheduler tick -----------------------------------------------------
    def poll(self) -> List[GraphResult]:
        """One scheduler tick: read the pressure gauge (keeping its peak
        on ``peak_pressure``) and shed above ``pressure_threshold``, cut
        every ready wave, dispatch them in packed order and return the
        newly completed results (a query's seed requests go to its
        ticket instead).  ``[]`` when nothing was ready."""
        now = self.clock()
        pressure = self.backlog_bound()
        if pressure > self.peak_pressure:
            self.peak_pressure = pressure
        if pressure > self.pressure_threshold:
            self._shed_pressure(now, pressure)
        return self._route(self._dispatch(self._cut_ready(now)))

    def drain(self) -> List[GraphResult]:
        """Force-flush: cut everything still queued (reason ``"drain"``),
        dispatch in packed order and return the results.  The queue is
        empty afterwards."""
        return self._route(
            self._dispatch(self._cut_ready(self.clock(), drain=True)))

    def _dispatch(self, ready: List[tuple]) -> List[GraphResult]:
        """Dispatch the tick's cut waves over the ``n_lanes`` lanes.

        Each wave is pulled by the earliest-idle lane (ties rotate) and
        kept in flight through the engine's ``begin_wave``/``finish_wave``
        split, at most ``pipeline_depth`` at once, so one wave's host
        gather runs while an earlier wave is on the device.  Waves are
        harvested in launch order; the measured launch -> ready wall feeds
        the bucket's and the lane's EWMA, the cost calibration and the
        occupancy, and the marginal cut -> delivery wall feeds the
        admission floor.  One lane is the serial launch-then-finish loop.
        Resize mode goes to :meth:`_dispatch_groups`.
        """
        if self._resize:
            return self._dispatch_groups(ready)
        # start from results stranded by a failed tick; harvest appends to
        # this same list, so if THIS tick fails, everything harvested stays
        # in _undelivered for the next tick
        results = self._undelivered
        lane_busy = [0.0] * self.n_lanes
        depth = self.pipeline_depth
        in_flight: List[tuple] = []        # (lane, est, wave-entries,
        #                                     reason, cut_at, InFlightWave)
        prev_done = [None]                 # last harvest time THIS tick

        def harvest(item) -> None:
            lane, est, wave, reason, cut_at, handle = item
            wave_results = self.engine.finish_wave(handle)
            lane_busy[lane] -= est
            done_at = self.clock()
            wall = self.engine.bucket_walls[handle.bucket][-1]
            self._ewma_for(handle.bucket).observe(wall)
            self._lane_ewma[lane].observe(wall)
            self._calib.observe(sum(e.cost for e in wave), wall)
            self._occupancy.observe(len(wave))
            # MARGINAL wall-clock: waves of one tick run back to back, so a
            # later wave's (done - cut) includes its predecessors' walls
            start = (cut_at if prev_done[0] is None
                     else max(cut_at, prev_done[0]))
            self._wave_floor.observe(done_at - start)
            prev_done[0] = done_at
            self.dispatch_log.append(WaveLog(
                handle.bucket, len(wave), reason, cut_at, wall, lane,
                group_size=handle.pending.lanes,
                classes=self._wave_classes(wave)))
            self.dispatched += len(wave)
            for entry, res in zip(wave, wave_results):
                res.deadline = entry.deadline
                res.completed_at = done_at
                self._account_delivery(entry, done_at)
                results.append(res)

        try:
            for bucket, wave, reason, cut_at in self._pack_order(ready):
                # last-moment doomed check: earlier waves of this tick may
                # have pushed the clock past this wave's slack
                wave = self._shed_doomed(bucket, wave, self.clock())
                if not wave:
                    continue
                while len(in_flight) >= depth:
                    harvest(in_flight.pop(0))
                lane = min(range(self.n_lanes),
                           key=lambda l: (lane_busy[l],
                                          (l - self._next_lane)
                                          % self.n_lanes))
                self._next_lane = (lane + 1) % self.n_lanes
                est = self.estimate(bucket)
                handle = self.engine.begin_wave(
                    bucket, [e.request for e in wave])
                lane_busy[lane] += est
                in_flight.append((lane, est, wave, reason, cut_at, handle))
        finally:
            # a begin_wave failure must not abandon the waves in flight:
            # harvest them, so their results stream (through _undelivered
            # when the exception propagates)
            while in_flight:
                harvest(in_flight.pop(0))
        self._undelivered = []
        return results

    def _dispatch_groups(self, ready: List[tuple]) -> List[GraphResult]:
        """Resize-mode dispatch: disjoint device groups, replanned every
        tick from the waves cut.

        The tick's waves are costed by their bucket EWMA estimates and
        handed to :func:`plan_groups` (under ``autoscale``, with the group
        count of :func:`plan_lanes`): the i-th largest wave pairs with the
        i-th widest group, and further waves go to the earliest-finishing
        group (the packing ``wait_bound`` models).  Each wave runs through
        ``begin_wave(submesh=...)`` on its group alone, at most one in
        flight per group (a group's next wave first harvests its previous
        one).  Walls feed the bucket EWMA and the group-SIZE EWMA;
        ``dispatch_log`` records the group index and width,
        ``last_group_sizes`` the tick's plan."""
        results = self._undelivered
        packed = self._pack_order(ready)
        if not packed:
            self._undelivered = []
            return results
        ests = [self.estimate(bucket) for bucket, _, _, _ in packed]
        max_lanes = self.n_lanes
        if self._autoscale:
            max_lanes = plan_lanes(self.n_devices, ests, self.engine.slots,
                                   self.n_lanes,
                                   size_wall=self.group_estimate)
            self.last_auto_lanes = max_lanes
        sizes = plan_groups(self.n_devices, sorted(ests, reverse=True),
                            self.engine.slots, max_groups=max_lanes)
        groups = sharding.partition_mesh(self.engine.mesh, sizes)
        self.last_group_sizes = list(sizes)
        k = min(len(packed), self.n_devices, max_lanes)
        # wave -> group: waves by descending estimate take the
        # earliest-finishing of the k demand-assigned groups (ties toward
        # the wider group), so the first k get distinct groups, largest
        # with largest, and the rest pile onto whichever frees up first
        group_busy = [0.0] * k
        assign: Dict[int, int] = {}
        for i in sorted(range(len(packed)), key=lambda i: (-ests[i], i)):
            g = min(range(k), key=lambda j: (group_busy[j], j))
            group_busy[g] += max(ests[i], self._size_wall(sizes[g]).value)
            assign[i] = g
        in_flight: Dict[int, tuple] = {}    # group -> (wave-entries,
        #                                      reason, cut_at, InFlightWave)
        prev_done = [None]                 # last harvest time THIS tick

        def harvest(g: int) -> None:
            wave, reason, cut_at, handle = in_flight.pop(g)
            wave_results = self.engine.finish_wave(handle)
            done_at = self.clock()
            wall = self.engine.bucket_walls[handle.bucket][-1]
            self._ewma_for(handle.bucket).observe(wall)
            self._size_wall(handle.pending.lanes).observe(wall)
            self._calib.observe(sum(e.cost for e in wave), wall)
            self._occupancy.observe(len(wave))
            # marginal wall-clock, as in _dispatch
            start = (cut_at if prev_done[0] is None
                     else max(cut_at, prev_done[0]))
            self._wave_floor.observe(done_at - start)
            prev_done[0] = done_at
            self.dispatch_log.append(WaveLog(
                handle.bucket, len(wave), reason, cut_at, wall, g,
                group_size=handle.pending.lanes,
                classes=self._wave_classes(wave)))
            self.dispatched += len(wave)
            for entry, res in zip(wave, wave_results):
                res.deadline = entry.deadline
                res.completed_at = done_at
                self._account_delivery(entry, done_at)
                results.append(res)

        try:
            for i, (bucket, wave, reason, cut_at) in enumerate(packed):
                # last-moment doomed check (see _dispatch)
                wave = self._shed_doomed(bucket, wave, self.clock())
                if not wave:
                    continue
                g = assign[i]
                if g in in_flight:          # one wave per group at a time
                    harvest(g)
                handle = self.engine.begin_wave(
                    bucket, [e.request for e in wave], submesh=groups[g])
                in_flight[g] = (wave, reason, cut_at, handle)
        finally:
            # as in _dispatch: a begin_wave failure must not abandon the
            # waves in flight
            while in_flight:
                harvest(min(in_flight))
        self._undelivered = []
        return results

    # -- warmup -------------------------------------------------------------
    def warmup(self, sizes: Sequence[int]) -> None:
        """Build the walk plans of the buckets of ``sizes`` vertex counts
        before traffic: two dummy single-request waves per NEW bucket, so
        the first real request does not pay the plan, and the EWMA seeds
        from a steady-state wall (the second; ``_ewma_for`` takes the
        minimum).

        Resize mode also runs every device-group placement the plan can
        reach, for every bucket of ``sizes`` (served before or not), twice
        each: a group size's walk plan is built once, but each group's
        devices get their copy of the weights and its profile, and the
        ``group_walls`` minimum that seeds :meth:`group_estimate` is a
        steady-state wall."""
        req = GraphRequest(np.eye(2, dtype=np.float32),
                           np.zeros((2, self.engine.f_in), np.float32),
                           request_id=-1)
        buckets = sorted({self.engine.bucket_for(int(s)) for s in sizes})
        for n in buckets:
            if n in self.engine.bucket_walls:
                continue
            self.engine.dispatch_wave(n, [req])
            self.engine.dispatch_wave(n, [req])
        if not self._resize:
            return
        size = 1
        while size <= self.n_devices:
            if self.engine.slots % size == 0:
                n_groups = self.n_devices // size
                part = ([size] * n_groups
                        + [1] * (self.n_devices - size * n_groups))
                subs = sharding.partition_mesh(self.engine.mesh, part)
                for sub in subs[:n_groups]:
                    for n in buckets:
                        for _ in range(2):
                            self.engine.finish_wave(self.engine.begin_wave(
                                n, [req], submesh=sub))
            size *= 2
