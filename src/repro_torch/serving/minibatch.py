"""Giant-graph mini-batch serving: sampler -> feature store -> wave.

Port of ``repro.serving.minibatch`` (numpy over the engine, as the
reference is).  The batched and continuous stack
(``serving.graph_engine`` / ``serving.scheduler``) serves WHOLE graphs:
every request carries its own adjacency and features.  Production GNN
traffic queries one giant graph through neighborhood sampling instead --
a query names seed vertices, the host samples a bounded neighborhood per
seed (``data.sampling``), and only the induced subgraph flows through a
wave.  This module is that front end:

* :class:`FeatureStore` -- the giant graph's features, held once in a
  numpy array.  A request gathers its rows at admission, and
  ``GraphServeEngine._fill_slot`` calls ``SeedRequest.fill_features``
  to copy them straight into the wave's slot view (on the card, a view of
  the wave's pinned host buffer; the engine's per-wave
  ``gather_seconds`` measures the cost).  ``update`` bumps a version
  counter and notifies listeners -- the cache invalidation hook.

* :class:`VertexCache` -- LRU over hot-vertex RESULT rows keyed by
  ``(vertex, model, "out")``, with dependency-tracked invalidation: an
  entry records the global vertex set its subgraph touched, and a store
  update evicts every entry whose dependencies intersect the touched
  rows, so no served result ever reflects pre-update features.  Hit /
  miss / eviction / invalidation counters (:class:`CacheStats`) surface
  through the serve report.

* **Exact caching via per-seed subgraphs.**  The planner samples ONE
  subgraph per seed vertex under a seed derived from the vertex id
  (``data.sampling.vertex_seed(SAMPLE_SEED, v)``), so a seed's logits
  row is a pure function of (vertex, model spec, fanouts, store version): cache-on and
  cache-off serving are bitwise identical, and the batching win comes
  from waving many small single-seed subgraphs, not from unioning seeds
  (a union's induced edges would couple seeds' numerics and make caching
  approximate).

* :class:`MiniBatchServeEngine` -- the synchronous front end
  (``serve_queries``), with :meth:`MiniBatchServeEngine.oracle_queries`
  as the slow per-seed ``run_naive`` oracle every result is validated
  against.  The continuous front door is
  ``serving.scheduler.ContinuousGraphServer.submit_query`` (pass the
  planner as ``minibatch=``), which coalesces concurrent queries of the
  same in-flight vertex and fills the cache as waves complete.

Everything here is host work; the device is reached only through the
engine's waves (``begin_wave``/``finish_wave``) and ``run_naive``, on
whatever device the engine has.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import analyzer
from repro_torch.data.sampling import (AdjacencyBlockProfile, GraphDelta,
                                       HostGraph, SampledSubgraph,
                                       sample_subgraph, vertex_seed)
from repro_torch.serving.graph_engine import (GraphRequest, GraphResult,
                                              GraphServeEngine)

# the sampler's base seed: vertex v's neighborhood is drawn under
# vertex_seed(SAMPLE_SEED, v), the reference planner's default
SAMPLE_SEED = 0


class FeatureStore:
    """The giant graph's node features, held once as a float32 numpy array.

    ``gather``/``gather_into`` copy the rows a sampled subgraph needs --
    ``gather_into`` writes straight into a caller-provided view (a wave
    slot) without an intermediate copy.  ``update`` overwrites rows IN
    PLACE, bumps ``version``, and notifies listeners (the planner
    invalidates cache entries depending on the touched vertices).
    Requests gather at submit time, so a request in flight across an
    update keeps its submission-time snapshot -- delivered, but never
    cached (the planner checks the version it gathered under).
    """

    def __init__(self, features: np.ndarray):
        feats = np.ascontiguousarray(features, np.float32)
        if feats.ndim != 2:
            raise ValueError(f"features must be (n_vertices, f_in), got "
                             f"shape {feats.shape}")
        self._features = feats
        self.version = 0
        self._listeners: List = []

    @property
    def n_vertices(self) -> int:
        return int(self._features.shape[0])

    @property
    def f_in(self) -> int:
        return int(self._features.shape[1])

    @property
    def nbytes(self) -> int:
        return int(self._features.nbytes)

    def add_listener(self, callback) -> None:
        """``callback(vertices)`` fires on every :meth:`update` with the
        touched global vertex ids."""
        self._listeners.append(callback)

    def gather(self, vertices: np.ndarray) -> np.ndarray:
        return self._features[np.asarray(vertices, np.int64)]

    def gather_into(self, vertices: np.ndarray, out: np.ndarray) -> None:
        """Copy ``vertices``' feature rows into ``out[:len(vertices)]``
        (a contiguous float32 view of a wave slot; rows past the subgraph
        stay untouched -- the engine's slot buffers are zero-initialized)."""
        idx = np.asarray(vertices, np.int64)
        np.take(self._features, idx, axis=0, out=out[: idx.shape[0]])

    def update(self, vertices: np.ndarray, values: np.ndarray) -> None:
        idx = np.asarray(vertices, np.int64)
        vals = np.asarray(values, np.float32)
        if vals.shape != (idx.shape[0], self.f_in):
            raise ValueError(
                f"update values shape {vals.shape} != "
                f"({idx.shape[0]}, {self.f_in})")
        self._features[idx] = vals
        self.version += 1
        for cb in self._listeners:
            cb(idx)


@dataclasses.dataclass
class CacheStats:
    """Hot-vertex cache counters.  Conservation: ``hits + misses ==
    lookups``, and every entry ever inserted is exactly one of resident /
    evicted / invalidated (``insertions == evictions + invalidations +
    len(cache)``)."""

    lookups: int = 0
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    invalidations: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"lookups": self.lookups, "hits": self.hits,
                "misses": self.misses, "insertions": self.insertions,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": self.hit_rate}


class VertexCache:
    """LRU result cache keyed by ``(vertex, model, layer)`` with
    dependency-tracked invalidation.

    ``put`` records the entry's dependencies -- the global vertex set of
    the subgraph the value was computed from; ``invalidate(touched)``
    evicts every entry whose dependency set intersects the touched
    vertices (a hub's cached result depends on its sampled neighbors'
    features, not just its own row).  Values are stored as-is and
    returned as-is, so a cache hit is bitwise the row the wave produced.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"cache capacity {capacity} < 1")
        self.capacity = int(capacity)
        self._entries: "OrderedDict[Tuple, Tuple[np.ndarray, np.ndarray]]" \
            = OrderedDict()
        # reverse index: dependency vertex -> keys depending on it
        self._by_vertex: Dict[int, set] = {}
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: Tuple) -> Optional[np.ndarray]:
        self.stats.lookups += 1
        hit = self._entries.get(key)
        if hit is None:
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        self._entries.move_to_end(key)
        return hit[0]

    def put(self, key: Tuple, value: np.ndarray,
            deps: Iterable[int]) -> None:
        if key in self._entries:
            self._drop(key)                 # refresh deps + LRU position
        deps_arr = np.asarray(list(deps), np.int64)
        self._entries[key] = (value, deps_arr)
        for v in deps_arr:
            self._by_vertex.setdefault(int(v), set()).add(key)
        self.stats.insertions += 1
        while len(self._entries) > self.capacity:
            victim = next(iter(self._entries))
            self._drop(victim)
            self.stats.evictions += 1

    def invalidate(self, vertices: Iterable[int]) -> int:
        """Evict every entry depending on any of ``vertices``; returns the
        eviction count."""
        doomed = set()
        for v in np.asarray(list(vertices), np.int64):
            doomed |= self._by_vertex.get(int(v), set())
        for key in doomed:
            self._drop(key)
        self.stats.invalidations += len(doomed)
        return len(doomed)

    def _drop(self, key: Tuple) -> None:
        _, deps = self._entries.pop(key)
        for v in deps:
            keys = self._by_vertex.get(int(v))
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_vertex[int(v)]


class SeedRequest(GraphRequest):
    """A single-seed sampled-subgraph request backed by the feature store.

    Duck-types :class:`~repro_torch.serving.graph_engine.GraphRequest`:
    ``adjacency`` is the subgraph's induced adjacency, ``features``
    gathers the subgraph's rows from the store on first access (memoized
    -- the admission edge's validation reads it, so the snapshot is taken
    at submit) and ``store_version`` records the version it was gathered
    under (the planner refuses to cache a result whose gather predates a
    store update).  ``fill_features`` is the per-wave hook: the engine
    fills the request's wave slot from it."""

    def __init__(self, subgraph: SampledSubgraph, store: FeatureStore,
                 request_id: int):
        self.subgraph = subgraph
        self.store = store
        self.adjacency = subgraph.adjacency
        self.request_id = int(request_id)
        self._gathered: Optional[np.ndarray] = None
        self.store_version: Optional[int] = None
        # the planner's graph version this request was SAMPLED under
        # (stamped by ``MiniBatchPlanner.request_for``): a streaming edge
        # delta bumps the planner's version, so a result sampled from the
        # old topology is delivered but never cached
        self.graph_version: Optional[int] = None

    @property
    def vertex(self) -> int:
        """The (single) seed vertex this request answers for."""
        return int(self.subgraph.vertices[0])

    @property
    def n_vertices(self) -> int:
        return self.subgraph.n_vertices

    @property
    def features(self) -> np.ndarray:
        if self._gathered is None:
            self._gathered = self.store.gather(self.subgraph.vertices)
            self.store_version = self.store.version
        return self._gathered

    def fill_features(self, out: np.ndarray) -> None:
        """Per-wave gather: write this request's feature rows into its
        wave-slot view.  Uses the submit-time snapshot when one exists
        (results must reflect features as of submission, even if the
        store updated while the request queued); gathers straight from
        the store otherwise."""
        if self._gathered is not None:
            out[: self._gathered.shape[0]] = self._gathered
        else:
            self.store.gather_into(self.subgraph.vertices, out)
            self.store_version = self.store.version


@dataclasses.dataclass(frozen=True)
class DeltaReport:
    """What one streaming edge delta did to a serving deployment
    (:meth:`MiniBatchPlanner.apply_delta`'s return).

    ``touched_cells`` counts block-profile cells the incremental patch
    rewrote; ``replan_cells`` counts the subset whose K2P decision against
    a dense feature fiber actually CROSSED a primitive boundary -- the only
    cells a planner has to re-decide (``analyzer.delta_replan_mask``).
    ``cache_invalidated`` counts hot-vertex entries evicted because a
    changed edge touched their dependency set.
    """

    delta: GraphDelta
    graph_version: int               # the planner's version AFTER the delta
    cache_invalidated: int
    touched_cells: int
    replan_cells: int
    total_cells: int


class MiniBatchPlanner:
    """Sampling + caching policy for one (graph, store, model) deployment.

    Owns the per-seed determinism contract: :meth:`request_for` samples
    vertex ``v``'s neighborhood under ``vertex_seed(SAMPLE_SEED, v)``, so
    the request -- and its result -- is a pure function of (vertex,
    fanouts, store version).  :meth:`lookup` /
    :meth:`complete` are the cache's two ends: lookup on the query path,
    complete as wave results surface (caching only when the store version
    still matches the request's gather).  Registers itself as a store
    listener so updates invalidate dependent entries immediately.

    Request ids are drawn from a NEGATIVE counter (starting at -2; the
    scheduler's warmup dummy owns -1), so planner-issued requests never
    collide with caller-chosen whole-graph request ids and the continuous
    server can route wave results back to waiting queries by id.
    """

    def __init__(self, graph: HostGraph, store: FeatureStore, *,
                 fanouts: Sequence[int] = (8, 4),
                 cache: Optional[VertexCache] = None,
                 model_key: str = "gnn",
                 profile_block: Tuple[int, int] = (128, 128)):
        self.graph = graph
        self.store = store
        self.fanouts = tuple(int(f) for f in fanouts)
        self.cache = cache
        self.model_key = str(model_key)
        # streaming-delta state: the graph's block-level nnz profile is
        # maintained INCREMENTALLY across apply_delta calls (touched cells
        # only, never a full re-profile), and graph_version gates caching
        # and coalescing the way the store version does for features
        self.graph_version = 0
        self.profile_block = (int(profile_block[0]), int(profile_block[1]))
        self.profile = AdjacencyBlockProfile.from_graph(
            graph, self.profile_block)
        self._next_rid = -2
        self._inflight: Dict[int, SeedRequest] = {}
        if cache is not None:
            store.add_listener(cache.invalidate)

    def cache_key(self, vertex: int) -> Tuple[int, str, str]:
        return (int(vertex), self.model_key, "out")

    def lookup(self, vertex: int) -> Optional[np.ndarray]:
        """Cached result row for ``vertex``, or None (counts a miss)."""
        if self.cache is None:
            return None
        return self.cache.get(self.cache_key(vertex))

    def sample(self, vertex: int) -> SampledSubgraph:
        """Vertex ``v``'s deterministic sampled neighborhood."""
        return sample_subgraph(self.graph, [int(vertex)], self.fanouts,
                               seed=vertex_seed(SAMPLE_SEED, vertex))

    def request_for(self, vertex: int) -> SeedRequest:
        """A fresh store-backed request for ``vertex`` (tracked in flight
        until :meth:`complete` sees its result)."""
        req = SeedRequest(self.sample(vertex), self.store, self._next_rid)
        req.graph_version = self.graph_version
        self._next_rid -= 1
        self._inflight[req.request_id] = req
        return req

    def complete(self, result: GraphResult) -> Tuple[int, np.ndarray]:
        """Consume a wave result for a planner-issued request: returns
        ``(vertex, row)`` and fills the cache -- unless the store updated
        after the request gathered (or an edge delta bumped the graph
        version after it sampled), in which case the (valid,
        snapshot-consistent) row is delivered but NOT cached.  The row is
        a copy, so a cached row does not hold its wave's output alive."""
        req = self._inflight.pop(result.request_id)
        row = np.array(result.logits[0])
        if (self.cache is not None
                and req.store_version == self.store.version
                and req.graph_version == self.graph_version):
            self.cache.put(self.cache_key(req.vertex), row,
                           deps=req.subgraph.vertices)
        return req.vertex, row

    def abandon(self, request: SeedRequest) -> None:
        """Forget an in-flight request that will never complete (its
        admission ticket was shed at the door)."""
        self._inflight.pop(request.request_id, None)

    def inflight_request(self, request_id: int) -> Optional[SeedRequest]:
        """The in-flight request behind a planner-issued id, if any (the
        continuous server's coalescing check reads its gather version)."""
        return self._inflight.get(request_id)

    def apply_delta(self, edge_inserts: Sequence, edge_deletes: Sequence,
                    *, strategy: str, cost_model) -> DeltaReport:
        """Stream an edge delta into the deployment.  ``strategy`` and
        ``cost_model`` are the serving engine's own (its
        ``GraphServeEngine.strategy`` and ``executor.model``), so the
        replan count is that of the plans the engine really makes; the
        engine's owner passes them (:meth:`MiniBatchServeEngine.apply_delta`,
        ``ContinuousGraphServer.apply_delta``).

        Four incremental moves, no full re-profile and no full replan:

        1. ``HostGraph.apply_delta`` rebuilds the CSR and canonicalizes
           the delta down to the undirected edges that actually changed
           (insert-existing / delete-missing are no-ops).
        2. The maintained :class:`AdjacencyBlockProfile` is PATCHED --
           +-1 on the block cells the changed edges land in -- which is
           bitwise what ``from_graph`` on the new topology would count.
        3. ``analyzer.delta_replan_mask`` re-runs the K2P selection on
           the touched cells only and reports which ones crossed a
           primitive boundary -- the cells a planner must re-decide.
        4. ``graph_version`` bumps (only if the delta changed anything),
           so in-flight requests sampled from the old topology are
           delivered but never cached, and the cache evicts exactly the
           entries whose sampled neighborhoods touch a changed vertex.
        """
        new_graph, delta = self.graph.apply_delta(edge_inserts, edge_deletes)
        old_dens = self.profile.densities()
        new_profile, touched = self.profile.apply_delta(delta)
        new_dens = new_profile.densities()
        # the rhs fiber of an Aggregate is a (dense) feature panel; one
        # dense column reproduces plan_codes' selection per lhs cell
        replan = analyzer.delta_replan_mask(
            strategy, old_dens, new_dens,
            np.ones((old_dens.shape[1], 1), np.float32),
            cost_model, touched=touched)
        self.graph = new_graph
        self.profile = new_profile
        invalidated = 0
        if delta.n_changed:
            self.graph_version += 1
            if self.cache is not None:
                invalidated = self.cache.invalidate(delta.touched_vertices)
        return DeltaReport(
            delta=delta, graph_version=self.graph_version,
            cache_invalidated=invalidated,
            touched_cells=int(np.count_nonzero(touched)),
            replan_cells=int(np.count_nonzero(replan)),
            total_cells=int(touched.size))

    @property
    def inflight(self) -> int:
        return len(self._inflight)


@dataclasses.dataclass
class QueryTicket:
    """One mini-batch query's handle: seed vertices in, one logits row per
    seed out.  The synchronous engine returns it complete; the continuous
    front door (``ContinuousGraphServer.submit_query``) returns it
    immediately and fills rows as waves finish -- check :attr:`done`, then
    :meth:`result`.  ``from_cache`` counts seeds answered by the cache at
    submit; ``shed_seeds`` lists seeds whose requests the admission door
    rejected (their rows stay missing and the ticket still completes)."""

    query_id: int
    seeds: List[int]
    deadline: Optional[float] = None
    tickets: List = dataclasses.field(default_factory=list)
    from_cache: int = 0
    shed_seeds: List[int] = dataclasses.field(default_factory=list)
    completed_at: Optional[float] = None
    _rows: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    _pending: set = dataclasses.field(default_factory=set)

    @property
    def done(self) -> bool:
        return not self._pending

    def result(self) -> np.ndarray:
        """(len(seeds), n_classes) logits, row i for seeds[i] (duplicate
        seeds share a row).  Raises until :attr:`done`; shed seeds' rows
        are NaN (explicitly absent, never silently zero)."""
        if not self.done:
            raise RuntimeError(
                f"query {self.query_id} still waiting on "
                f"{len(self._pending)} seed(s); poll the server")
        rows = [self._rows[v] for v in self.seeds]
        width = max((r.shape[0] for r in rows if r is not None), default=1)
        out = np.full((len(rows), width), np.nan, np.float32)
        for i, r in enumerate(rows):
            if r is not None:
                out[i] = r
        return out

    def _fill(self, vertex: int, row: Optional[np.ndarray],
              completed_at: Optional[float] = None) -> None:
        self._rows[int(vertex)] = row
        self._pending.discard(int(vertex))
        if completed_at is not None:
            self.completed_at = (completed_at if self.completed_at is None
                                 else max(self.completed_at, completed_at))


class MiniBatchServeEngine:
    """Synchronous mini-batch serving over a :class:`GraphServeEngine`.

    >>> graph = powerlaw_host_graph(100_000)
    >>> store = FeatureStore(features)          # (100_000, f_in), held once
    >>> eng = GraphServeEngine("gcn", f_in=store.f_in, n_classes=7)
    >>> mb = MiniBatchServeEngine(eng, graph, store, fanouts=(8, 4))
    >>> out = mb.serve_queries([[3, 17], [17, 99_000]])   # seeds per query
    >>> out[0].result().shape
    (2, 7)

    One wave-batched pass answers every uncached seed across the batch of
    queries (duplicate vertices collapse to one request); results are
    bitwise equal to :meth:`oracle_queries` (per-seed ``run_naive``, a
    per-request ``DynasparseEngine`` run) whatever the cache state.  The
    engine's device is the serving device (CUDA unless it was built with
    ``device="cpu"``).
    """

    def __init__(self, engine: GraphServeEngine, graph: HostGraph,
                 store: FeatureStore, *, fanouts: Sequence[int] = (8, 4),
                 cache_capacity: Optional[int] = 4096):
        if store.f_in != engine.f_in:
            raise ValueError(
                f"store f_in {store.f_in} != engine f_in {engine.f_in}")
        if store.n_vertices != graph.n_vertices:
            raise ValueError(
                f"store holds {store.n_vertices} vertices, graph has "
                f"{graph.n_vertices}")
        self.engine = engine
        self.planner = MiniBatchPlanner(
            graph, store, fanouts=fanouts,
            cache=(None if cache_capacity is None
                   else VertexCache(cache_capacity)),
            model_key=engine.spec.model)
        self.queries = 0

    @property
    def cache(self) -> Optional[VertexCache]:
        return self.planner.cache

    def serve_queries(self, queries: Sequence[Sequence[int]]
                      ) -> List[QueryTicket]:
        """Serve a batch of seed-set queries; tickets come back complete,
        in query order."""
        out: List[QueryTicket] = []
        misses: Dict[int, SeedRequest] = {}       # vertex -> request
        waiting: Dict[int, List[QueryTicket]] = {}
        for seeds in queries:
            qt = QueryTicket(self.queries, [int(v) for v in seeds])
            self.queries += 1
            out.append(qt)
            for v in dict.fromkeys(qt.seeds):
                row = self.planner.lookup(v)
                if row is not None:
                    qt.from_cache += 1
                    qt._fill(v, row)
                    continue
                qt._pending.add(v)
                if v not in misses:
                    misses[v] = self.planner.request_for(v)
                waiting.setdefault(v, []).append(qt)
        if misses:
            for res in self.engine.serve(list(misses.values())):
                vertex, row = self.planner.complete(res)
                for qt in waiting[vertex]:
                    qt._fill(vertex, row)
        return out

    def apply_delta(self, edge_inserts: Sequence = (),
                    edge_deletes: Sequence = ()) -> DeltaReport:
        """Stream an edge delta into the served graph; see
        :meth:`MiniBatchPlanner.apply_delta`.  Later queries sample the
        new topology; cached rows whose neighborhoods touched a changed
        edge are already evicted when this returns."""
        return self.planner.apply_delta(
            edge_inserts, edge_deletes, strategy=self.engine.strategy,
            cost_model=self.engine.executor.model)

    def oracle_queries(self, queries: Sequence[Sequence[int]]
                       ) -> List[np.ndarray]:
        """Slow full-fidelity oracle: every seed sampled identically, run
        one at a time through the engine's ``run_naive`` (a per-request
        ``DynasparseEngine.run`` on the same padded tensors) -- no waves,
        no cache."""
        planner = self.planner
        out = []
        for seeds in queries:
            rows = {}
            for v in dict.fromkeys(int(s) for s in seeds):
                req = SeedRequest(planner.sample(v), planner.store,
                                  request_id=-1)
                res = self.engine.run_naive([req])[0]
                rows[v] = np.array(res.logits[0])
            out.append(np.stack([rows[int(s)] for s in seeds]))
        return out

    def report(self) -> Dict[str, object]:
        """Serving observability row: the engine's wave counters plus the
        cache counters."""
        rep: Dict[str, object] = {
            "queries": self.queries,
            "served_requests": self.engine.served,
            "waves": self.engine.waves,
            "fanouts": list(self.planner.fanouts),
        }
        walls = self.engine.wave_walls
        rep["wave_wall_seconds"] = float(np.sum(walls)) if walls else 0.0
        last = self.engine.last_wave_report
        if last is not None and getattr(last, "gather_seconds", None):
            rep["last_gather_seconds"] = float(last.gather_seconds)
        if self.cache is not None:
            rep["cache"] = self.cache.stats.as_dict()
        return rep
