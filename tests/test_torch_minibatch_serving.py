"""The port's mini-batch serving against the JAX package's, on the CPU.

Parity with the reference, on the same host graph, feature store and
weights: ``serve_queries`` for all five models (cache counters and
``from_cache`` exactly, rows within 3e-4, the float32 tolerance of
``tests/test_kernels.py``, which ``tests/test_torch_gat.py`` uses for GAT
too), and a scripted ``submit_query`` stream through both continuous
servers -- one fake clock each and the walls scripted, as in
``tests/torch_scripted_stream.py`` -- with an edge delta and a store
update midway: equal dispatch logs, tickets, issued-request counts and
shed seeds.  Then the reference's mini-batch cases
(``tests/test_minibatch_serving.py``) run inside the port, where every
served row must equal the per-seed ``run_naive`` oracle bit for bit and
cache-on must equal cache-off.
"""
import functools

import numpy as np
import pytest

from conftest import HAVE_HYPOTHESIS, given, settings, st
from repro.data import sampling as j_smp
from repro.serving import graph_engine as j_ge
from repro.serving import minibatch as j_mb
from repro.serving import scheduler as j_sch
from repro_torch.data.sampling import powerlaw_host_graph
from repro_torch.launch import serve_gnn
from repro_torch.models.gnn import GNN_MODELS
from repro_torch.serving.graph_engine import GraphRequest, GraphServeEngine
from repro_torch.serving.minibatch import (FeatureStore, MiniBatchPlanner,
                                           MiniBatchServeEngine,
                                           QueryTicket, SeedRequest,
                                           VertexCache)
from repro_torch.serving.scheduler import ContinuousGraphServer
from torch_scripted_stream import (POLICIES, SERVER_KW, script_walls,
                                   stream_clock)

N_V, F_IN, N_CLASSES = 400, 12, 5
FANOUTS = (3, 2)
QUERIES = [[7, 3], [3, 11, 7], [120], [11, 11, 55]]
TOL = dict(atol=3e-4, rtol=3e-4)
ENGINE_KW = dict(f_in=F_IN, hidden=8, n_classes=N_CLASSES, slots=4,
                 min_bucket=32)


@functools.lru_cache(maxsize=None)
def _host():
    g = powerlaw_host_graph(N_V, avg_degree=6, seed=0)
    feats = np.random.default_rng(7).standard_normal(
        (N_V, F_IN)).astype(np.float32)
    return g, feats


@functools.lru_cache(maxsize=None)
def _graph_engine(model):
    # shared per model so the walk plans amortize across tests; its
    # counters drift but numerics are stateless
    return GraphServeEngine(model, device="cpu", **ENGINE_KW)


def _mb(model, *, cache_capacity=4096, store=None):
    g, feats = _host()
    if store is None:
        store = FeatureStore(feats.copy())   # tests may update in place
    return MiniBatchServeEngine(_graph_engine(model), g, store,
                                fanouts=FANOUTS,
                                cache_capacity=cache_capacity), store


def _engines(model):
    """A reference engine and the port's on the CPU with its weights."""
    je = j_ge.GraphServeEngine(model, **ENGINE_KW)
    te = GraphServeEngine(model, device="cpu", **ENGINE_KW,
                          weights={k: np.asarray(v)
                                   for k, v in je.weights.items()})
    return je, te


def _deployments(model, cache_capacity=4096):
    """(reference MiniBatchServeEngine, port's, reference store, port's)
    over each package's own host graph and a copy of the features."""
    je, te = _engines(model)
    feats = _host()[1]
    j_store, t_store = (j_mb.FeatureStore(feats.copy()),
                        FeatureStore(feats.copy()))
    jm = j_mb.MiniBatchServeEngine(
        je, j_smp.powerlaw_host_graph(N_V, avg_degree=6, seed=0), j_store,
        fanouts=FANOUTS, cache_capacity=cache_capacity)
    tm = MiniBatchServeEngine(te, _host()[0], t_store, fanouts=FANOUTS,
                              cache_capacity=cache_capacity)
    return jm, tm, j_store, t_store


# -- parity with the reference ----------------------------------------------

@pytest.mark.parametrize("model", GNN_MODELS)
def test_serve_queries_matches_the_reference(model):
    """Cold pass, warm pass, a store update, a small cache that evicts:
    cache counters, ``from_cache`` and waves exactly the reference's, rows
    within 3e-4 and bitwise the port's oracle."""
    jm, tm, j_store, t_store = _deployments(model, cache_capacity=6)
    touched = tm.planner.sample(7).vertices
    batches = [QUERIES, QUERIES[::-1], None, QUERIES + [[200, 201], [7]]]
    for queries in batches:
        if queries is None:
            for store in (j_store, t_store):
                store.update(touched, store.gather(touched) * 0.5 + 1.0)
            continue
        j_w, t_w = jm.engine.waves, tm.engine.waves
        j_out = jm.serve_queries(queries)
        t_out = tm.serve_queries(queries)
        assert tm.engine.waves - t_w == jm.engine.waves - j_w
        want = tm.oracle_queries(queries)
        for t, j, w in zip(t_out, j_out, want):
            assert (t.query_id, t.seeds, t.from_cache, t.done) == (
                j.query_id, j.seeds, j.from_cache, j.done)
            np.testing.assert_allclose(t.result(), np.asarray(j.result()),
                                       **TOL)
            np.testing.assert_array_equal(t.result(), w)
        assert tm.cache.stats.as_dict() == jm.cache.stats.as_dict()
        assert len(tm.cache) == len(jm.cache)
    s = tm.cache.stats
    assert s.hits and s.evictions and s.invalidations
    rep, ref = tm.report(), jm.report()
    for key in ("queries", "served_requests", "fanouts", "cache"):
        assert rep[key] == ref[key], key


def _query_stream(srv, clk, store, graph, rng, n_queries=24):
    """Seed-set queries over a hot vertex range with drawn deadlines,
    classes and gaps, polling in between; an edge delta after a third of
    the stream and a store update after two thirds; then drains until
    every query is done.  Returns the query tickets."""
    queries = []
    for i in range(n_queries):
        if i == n_queries // 3:
            v = 7
            u = next(w for w in range(N_V)
                     if w != v and w not in set(graph().neighbors(v)))
            srv.apply_delta([(v, u), (3, 150)],
                            [(11, int(graph().neighbors(11)[0]))])
        if i == 2 * n_queries // 3:
            rows = np.array([3, 7, 11, 55])
            store.update(rows, store.gather(rows) + 0.25)
        seeds = rng.integers(0, 40, size=int(rng.integers(1, 4))).tolist()
        u = rng.random()
        deadline = (None if u < 0.3 else clk.t + float(rng.uniform(0.0, 0.01))
                    if u < 0.55 else clk.t + float(rng.uniform(0.01, 0.2)))
        queries.append(srv.submit_query(
            seeds, deadline=deadline, priority=int(rng.integers(0, 2)),
            tenant=str(rng.integers(0, 2))))
        if rng.random() < 0.5:
            clk.advance(float(rng.uniform(0.0, 0.006)))
            srv.poll()
    clk.advance(0.002)
    srv.poll()
    for _ in range(20):
        srv.drain()
        if all(q.done for q in queries):
            break
    return queries


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_scripted_query_stream_matches_the_reference(policy):
    je, te = _engines("gcn")
    feats = _host()[1]
    j_store, t_store = (j_mb.FeatureStore(feats.copy()),
                        FeatureStore(feats.copy()))
    jp = j_mb.MiniBatchPlanner(
        j_smp.powerlaw_host_graph(N_V, avg_degree=6, seed=0), j_store,
        fanouts=FANOUTS, cache=j_mb.VertexCache(16), model_key="gcn")
    tp = MiniBatchPlanner(_host()[0], t_store, fanouts=FANOUTS,
                          cache=VertexCache(16), model_key="gcn")
    j_clk, t_clk = stream_clock(), stream_clock()
    script_walls(je, j_clk)
    script_walls(te, t_clk)
    kw = dict(**SERVER_KW, **POLICIES[policy])
    j_srv = j_sch.ContinuousGraphServer(je, clock=j_clk, minibatch=jp, **kw)
    t_srv = ContinuousGraphServer(te, clock=t_clk, minibatch=tp, **kw)
    j_srv.warmup((10,))
    t_srv.warmup((10,))
    j_q = _query_stream(j_srv, j_clk, j_store, lambda: jp.graph,
                        np.random.default_rng(4))
    t_q = _query_stream(t_srv, t_clk, t_store, lambda: tp.graph,
                        np.random.default_rng(4))
    assert t_clk.t == j_clk.t
    # a seed request shed from the queue after admission (the pressure
    # and doomed-request sheds of "predicted-miss") never delivers, and
    # the reference leaves its query waiting; the port does the same
    assert [q.done for q in t_q] == [q.done for q in j_q]
    shed_late = {int(t) for t in t_srv.shed_log} - {
        int(a) for q in t_q for a in q.tickets if not a.admitted}
    assert all(q.done == (not {int(a) for a in q.tickets} & shed_late)
               for q in t_q)
    assert all(q.done for q in t_q) or policy == "predicted-miss"

    def log(srv):
        return [(w.bucket, w.n_real, w.reason, w.cut_at, w.wall, w.lane,
                 w.classes) for w in srv.dispatch_log]

    assert log(t_srv) == log(j_srv)
    for t, j in zip(t_q, j_q):
        assert (t.query_id, t.seeds, t.deadline, t.from_cache,
                t.shed_seeds, t.completed_at) == (
            j.query_id, j.seeds, j.deadline, j.from_cache, j.shed_seeds,
            j.completed_at)
        assert [(int(a), a.verdict, a.predicted_miss, a.bucket, a.priority,
                 a.tenant) for a in t.tickets] == [
            (int(b), b.verdict, b.predicted_miss, b.bucket, b.priority,
             b.tenant) for b in j.tickets]
        if t.done:
            np.testing.assert_allclose(t.result(), np.asarray(j.result()),
                                       **TOL)
    # issued requests (ids count down from -2), coalescing and the cache
    assert tp._next_rid == jp._next_rid < -2
    assert tp.inflight == jp.inflight == len(shed_late)
    for name in ("queries_submitted", "submitted", "admitted",
                 "dispatched", "shed_at_submit", "shed_under_pressure"):
        assert getattr(t_srv, name) == getattr(j_srv, name), name
    assert [int(t) for t in t_srv.shed_log] == [int(t) for t in j_srv.shed_log]
    assert tp.cache.stats.as_dict() == jp.cache.stats.as_dict()
    assert tp.graph_version == jp.graph_version == 1
    assert sum(q.from_cache for q in t_q) > 0
    # queries submitted after the last mutation: bitwise the port's oracle
    oracle = MiniBatchServeEngine(te, tp.graph, t_store, fanouts=FANOUTS,
                                  cache_capacity=None)
    late = [q for q in t_q[2 * len(t_q) // 3:] if q.done]
    for q, w in zip(late, oracle.oracle_queries([q.seeds for q in late])):
        live = [i for i, s in enumerate(q.seeds) if s not in q.shed_seeds]
        if live:                          # an all-shed query has no rows
            np.testing.assert_array_equal(q.result()[live], w[live])


def _late_shed(srv, clk, planner, store, unblock):
    """Plant a late shed of hot vertex 7: its request is admitted, then
    shed from the queue as doomed; later queries of 7 coalesce onto the
    dead request.  Then ``unblock`` (a store update or an edge delta)
    bumps a version, and a fresh query of 7 completes.  Returns the
    queries in submission order."""
    srv.warmup((10,))
    first = srv.submit_query([7], deadline=clk.t + 0.02)
    clk.advance(0.019)                   # slack now below one wave wall
    srv.poll()
    later = [srv.submit_query([7]), srv.submit_query([7, 3])]
    for _ in range(5):
        srv.drain()
    if unblock == "store":
        store.update(np.array([399]), store.gather(np.array([399])))
    else:
        v = 399
        u = next(w for w in range(N_V)
                 if w != v and w not in set(planner.graph.neighbors(v)))
        srv.apply_delta([(v, u)], [])
    fresh = srv.submit_query([7])
    for _ in range(5):
        srv.drain()
    return [first] + later + [fresh]


@pytest.mark.parametrize("unblock", ["store", "delta"])
def test_late_shed_leaves_the_vertex_waiting_as_the_reference(unblock):
    """The reference's fault, kept on purpose: a seed request shed after
    admission never delivers, and every later query of that vertex joins
    it and waits too, until a store update or an edge delta lets a new
    query sample afresh.  Both packages leave the same queries pending."""
    je, te = _engines("gcn")
    feats = _host()[1]
    j_store, t_store = (j_mb.FeatureStore(feats.copy()),
                        FeatureStore(feats.copy()))
    jp = j_mb.MiniBatchPlanner(
        j_smp.powerlaw_host_graph(N_V, avg_degree=6, seed=0), j_store,
        fanouts=FANOUTS, cache=j_mb.VertexCache(16), model_key="gcn")
    tp = MiniBatchPlanner(_host()[0], t_store, fanouts=FANOUTS,
                          cache=VertexCache(16), model_key="gcn")
    j_clk, t_clk = stream_clock(), stream_clock()
    script_walls(je, j_clk)
    script_walls(te, t_clk)
    kw = dict(**SERVER_KW, **POLICIES["predicted-miss"])
    j_srv = j_sch.ContinuousGraphServer(je, clock=j_clk, minibatch=jp, **kw)
    t_srv = ContinuousGraphServer(te, clock=t_clk, minibatch=tp, **kw)
    j_q = _late_shed(j_srv, j_clk, jp, j_store, unblock)
    t_q = _late_shed(t_srv, t_clk, tp, t_store, unblock)
    assert t_clk.t == j_clk.t
    # the first query's request was admitted and then shed from the queue
    assert [a.admitted for a in t_q[0].tickets] == [True]
    assert [int(t) for t in t_srv.shed_log] == [
        int(t) for t in j_srv.shed_log] == [int(t_q[0].tickets[0])]
    assert not t_q[0].shed_seeds
    # it and both later queries of vertex 7 wait; the fresh one completes
    assert [q.done for q in t_q] == [q.done for q in j_q] == [
        False, False, False, True]
    assert [len(q.tickets) for q in t_q] == [len(q.tickets) for q in j_q]
    assert not t_q[1].tickets                  # it joined the dead request
    assert ([sorted(q._pending) for q in t_q]
            == [sorted(q._pending) for q in j_q] == [[7], [7], [7], []])
    assert tp.inflight == jp.inflight == 1
    assert t_srv._inflight_seed == j_srv._inflight_seed
    assert ({r: [q.query_id for q in w]
             for r, w in t_srv._query_waiters.items()}
            == {r: [q.query_id for q in w]
                for r, w in j_srv._query_waiters.items()}
            == {-2: [0, 1, 2]})
    np.testing.assert_allclose(t_q[3].result(), np.asarray(j_q[3].result()),
                               **TOL)


# -- the reference's mini-batch cases, inside the port ----------------------

@pytest.mark.parametrize("model", GNN_MODELS)
def test_oracle_parity_and_arrival_order(model):
    """serve_queries == the per-seed run_naive oracle, bitwise, whatever
    the arrival order, batching or cache state."""
    mb, _ = _mb(model)
    want = mb.oracle_queries(QUERIES)
    got = mb.serve_queries(QUERIES)
    assert [t.done for t in got] == [True] * len(QUERIES)
    for t, w in zip(got, want):
        np.testing.assert_array_equal(t.result(), w)
    order = [2, 0, 3, 1]
    again = mb.serve_queries([QUERIES[i] for i in order])
    for t, i in zip(again, order):
        np.testing.assert_array_equal(t.result(), want[i])


def test_cache_on_equals_cache_off():
    mb_on, _ = _mb("gcn")
    mb_off, _ = _mb("gcn", cache_capacity=None)
    assert mb_off.cache is None
    for _ in range(2):                       # 2nd pass: mb_on all hits
        on = mb_on.serve_queries(QUERIES)
        off = mb_off.serve_queries(QUERIES)
        for a, b in zip(on, off):
            np.testing.assert_array_equal(a.result(), b.result())
    assert mb_on.cache.stats.hits > 0


def test_repeat_queries_hit_cache_bitwise():
    mb, _ = _mb("sage")
    first = mb.serve_queries(QUERIES)
    waves_before = mb.engine.waves
    second = mb.serve_queries(QUERIES)
    assert mb.engine.waves == waves_before   # nothing re-ran
    assert all(t.from_cache == len(dict.fromkeys(t.seeds)) for t in second)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a.result(), b.result())
    rep = mb.report()
    assert rep["cache"]["hits"] > 0
    assert rep["cache"]["hit_rate"] > 0.0


def test_store_update_invalidates_dependents():
    mb, store = _mb("gcn")
    pre = {t.seeds[0]: t.result()[0]
           for t in mb.serve_queries([[v] for v in (7, 3, 120)])}
    touched = mb.planner.sample(7).vertices
    store.update(touched, store.gather(touched) + 1.0)
    assert mb.cache.stats.invalidations >= 1
    assert mb.planner.lookup(7) is None      # the stale entry is gone
    post = mb.serve_queries([[7]])[0].result()[0]
    np.testing.assert_array_equal(post, mb.oracle_queries([[7]])[0][0])
    assert not np.array_equal(post, pre[7]), (
        "post-update serve returned the pre-update row")


def test_inflight_snapshot_is_delivered_but_not_cached():
    """A request that gathered before an update keeps its submission-time
    snapshot but must not populate the cache."""
    mb, store = _mb("gin")
    planner = mb.planner
    req = planner.request_for(7)
    pre_snapshot = req.features.copy()       # gather -> version stamped
    store.update(np.array([7]), store.gather(np.array([7])) - 2.0)
    res = mb.engine.serve([req])[0]
    vertex, row = planner.complete(res)
    assert vertex == 7
    np.testing.assert_array_equal(req.features, pre_snapshot)
    assert planner.lookup(7) is None, "stale in-flight result was cached"
    fresh = mb.serve_queries([[7]])[0].result()[0]
    np.testing.assert_array_equal(fresh, mb.oracle_queries([[7]])[0][0])
    assert not np.array_equal(fresh, row)


def test_cache_accounting_conserves():
    mb, store = _mb("sgc")
    mb.serve_queries(QUERIES)
    mb.serve_queries(QUERIES)
    store.update(np.arange(N_V), store.gather(np.arange(N_V)) * 1.5)
    mb.serve_queries(QUERIES[:2])
    s = mb.cache.stats
    assert s.lookups == s.hits + s.misses
    assert s.insertions == (s.evictions + s.invalidations + len(mb.cache))


def test_vertex_cache_lru_eviction_and_reverse_index():
    c = VertexCache(capacity=2)
    r = {k: np.full(3, float(k), np.float32) for k in range(4)}
    c.put(("a",), r[0], deps=[0, 1])
    c.put(("b",), r[1], deps=[1, 2])
    assert c.get(("a",)) is not None         # "a" is now most recent
    c.put(("c",), r[2], deps=[3])            # evicts LRU = "b"
    assert c.stats.evictions == 1
    assert c.get(("b",)) is None
    np.testing.assert_array_equal(c.get(("a",)), r[0])
    assert c.invalidate([2]) == 0            # only "b" depended on 2
    assert c.invalidate([1]) == 1            # kills "a"
    assert c.get(("a",)) is None
    s = c.stats
    assert s.lookups == s.hits + s.misses
    assert s.insertions == s.evictions + s.invalidations + len(c)
    with pytest.raises(ValueError):
        VertexCache(capacity=0)


def test_query_ticket_shed_rows_are_nan():
    qt = QueryTicket(0, [5, 9, 5])
    qt._pending = {5, 9}
    qt._fill(5, np.array([1.0, 2.0], np.float32))
    assert not qt.done
    with pytest.raises(RuntimeError):
        qt.result()
    qt.shed_seeds.append(9)
    qt._fill(9, None)                        # shed: explicitly absent
    assert qt.done
    out = qt.result()
    np.testing.assert_array_equal(out[0], [1.0, 2.0])
    assert np.isnan(out[1]).all()
    np.testing.assert_array_equal(out[2], out[0])   # duplicate seed shares


def test_gather_seconds_surfaces_in_report():
    mb, _ = _mb("gcn")
    mb.serve_queries([[3, 7, 11]])
    rep = mb.engine.last_wave_report
    assert rep is not None and rep.gather_seconds > 0.0
    assert mb.report()["last_gather_seconds"] == rep.gather_seconds


def _drain_all(srv, tickets, rounds=50):
    for _ in range(rounds):
        srv.poll()
        srv.drain()
        if all(t.done for t in tickets):
            return
    raise AssertionError("queries never completed")


def test_submit_query_parity_coalescing_and_cache():
    mb, store = _mb("gcn")
    srv = ContinuousGraphServer(_graph_engine("gcn"), minibatch=mb.planner)
    q1 = srv.submit_query([7, 3])
    q2 = srv.submit_query([3, 11, 7])        # 3 and 7 coalesce with q1
    assert mb.planner.inflight == 3          # unique vertices, not 5
    _drain_all(srv, [q1, q2])
    want = mb.oracle_queries([[7, 3], [3, 11, 7]])
    np.testing.assert_array_equal(q1.result(), want[0])
    np.testing.assert_array_equal(q2.result(), want[1])
    q3 = srv.submit_query([7, 3, 11])        # all cached: done at submit
    assert q3.done and q3.from_cache == 3
    np.testing.assert_array_equal(q3.result(), want[1][[2, 0, 1]])
    assert srv.queries_submitted == 3
    # whole-graph traffic streams back past the router untouched
    sub = mb.planner.sample(55)
    req = GraphRequest(adjacency=sub.adjacency,
                       features=store.gather(sub.vertices), request_id=123)
    srv.submit(req)
    for _ in range(50):
        done = srv.poll() + srv.drain()
        if done:
            break
    assert [r.request_id for r in done] == [123]


def test_submit_query_requires_planner():
    srv = ContinuousGraphServer(_graph_engine("gcn"))
    with pytest.raises(ValueError):
        srv.submit_query([0])


def test_submit_query_version_checked_coalescing():
    """A query arriving after a store update must not join an in-flight
    request that gathered before it."""
    mb, store = _mb("sage")
    srv = ContinuousGraphServer(_graph_engine("sage"), minibatch=mb.planner)
    q1 = srv.submit_query([7])
    assert q1.tickets and mb.planner.inflight == 1
    store.update(np.array([7]), store.gather(np.array([7])) + 3.0)
    q2 = srv.submit_query([7])               # fresh post-update request
    assert mb.planner.inflight == 2
    _drain_all(srv, [q1, q2])
    np.testing.assert_array_equal(q2.result(), mb.oracle_queries([[7]])[0])
    assert not np.array_equal(q1.result(), q2.result())
    # q2's gather matches the current version, so it is cached
    assert mb.planner.lookup(7) is not None


def _check_query_parity(seed, model):
    rng = np.random.default_rng(seed)
    queries = [rng.integers(0, N_V, size=rng.integers(1, 4)).tolist()
               for _ in range(rng.integers(1, 4))]
    mb, _ = _mb(model)
    for t, w in zip(mb.serve_queries(queries), mb.oracle_queries(queries)):
        np.testing.assert_array_equal(t.result(), w)


@pytest.mark.parametrize("seed,model", [(1, "gcn"), (2, "gat"),
                                        (3, "gin")])
def test_query_parity_sweep(seed, model):
    _check_query_parity(seed, model)


if HAVE_HYPOTHESIS:

    @settings(max_examples=5, deadline=None)
    @given(seed=st.integers(0, 2**16), model=st.sampled_from(GNN_MODELS))
    def test_fuzzed_query_parity(seed, model):
        _check_query_parity(seed, model)


# -- the port's own ends: the slot hook and the CLI -------------------------

def test_fill_features_writes_the_snapshot_into_the_slot_view():
    """``_fill_slot`` hands the request's hook the (n, f_in) slot view:
    the submit-time snapshot lands there (not the store's current rows),
    the padding rows stay zero, and a request never gathered copies
    straight from the store."""
    mb, store = _mb("gcn")
    eng = mb.engine
    req = mb.planner.request_for(7)
    snap = req.features.copy()
    store.update(req.subgraph.vertices,
                 store.gather(req.subgraph.vertices) + 9.0)
    bucket = eng.bucket_for(req.n_vertices)
    padded = eng._padded(req, bucket)
    n = req.n_vertices
    np.testing.assert_array_equal(padded["H0"][:n], snap)
    assert not padded["H0"][n:].any()
    fresh = SeedRequest(mb.planner.sample(7), store, request_id=-9)
    out = np.zeros((bucket, F_IN), np.float32)
    fresh.fill_features(out)
    np.testing.assert_array_equal(out[:n], store.gather(
        fresh.subgraph.vertices))
    assert not out[n:].any() and fresh.store_version == store.version
    mb.planner.abandon(req)


def test_serve_gnn_cli_acts_on_the_cpu(capsys):
    """``--smoke`` runs every act -- batch, continuous, overload and the
    giant-graph finale -- and exits 0 only if each one's parity holds."""
    assert serve_gnn.main(["--device", "cpu", "--smoke"]) == 0
    out = capsys.readouterr().out
    for line in ("continuous:", "overload:", "delta: +1 edge",
                 "post-delta bitwise==oracle: True"):
        assert line in out, line
    assert out.count("bitwise==naive: True") == 3
    assert "smoke OK: ['batched', 'continuous', 'minibatch', 'overload']" \
        in out
