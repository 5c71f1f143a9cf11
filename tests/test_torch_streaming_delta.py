"""Streaming edge deltas in the port against the JAX package, on the CPU.

Parity with the reference: ``DeltaReport`` s of both packages equal
exactly over a chain of deltas served between queries (the canonical
delta, graph version, cache invalidations, touched and replanned cells),
and the port's ``analyzer.delta_replan_mask`` equals the reference's on
fuzzed touched cells, for the FPGA and TPU cost models, under ``dynamic``
and a static strategy, float32 and float64 inputs, at the default block
dims (128, 128, 128) the serving path uses.  Then the reference's
streaming-delta cases (``tests/test_streaming_delta.py``) run inside the
port, where serving after a delta must equal the port's own oracle bit
for bit.
"""
import functools

import numpy as np
import pytest
import torch

from conftest import HAVE_HYPOTHESIS, given, settings, st
from repro.core import analyzer as j_an
from repro.core import perf_model as j_pm
from repro.data import sampling as j_smp
from repro.serving import graph_engine as j_ge
from repro.serving import minibatch as j_mb
from repro_torch.core import analyzer
from repro_torch.core import perf_model as t_pm
from repro_torch.core.perf_model import FPGACostModel
from repro_torch.data.sampling import (AdjacencyBlockProfile, HostGraph,
                                       powerlaw_host_graph)
from repro_torch.serving.graph_engine import GraphServeEngine
from repro_torch.serving.minibatch import (DeltaReport, FeatureStore,
                                           MiniBatchPlanner,
                                           MiniBatchServeEngine, VertexCache)
from repro_torch.serving.scheduler import ContinuousGraphServer

N_V, F_IN, N_CLASSES = 400, 12, 5
FANOUTS = (3, 2)
COST_MODELS = {"fpga": (j_pm.FPGACostModel, t_pm.FPGACostModel),
               "tpu": (j_pm.TPUCostModel, t_pm.TPUCostModel)}


@functools.lru_cache(maxsize=None)
def _host():
    g = powerlaw_host_graph(N_V, avg_degree=6, seed=0)
    feats = np.random.default_rng(7).standard_normal(
        (N_V, F_IN)).astype(np.float32)
    return g, feats


@functools.lru_cache(maxsize=None)
def _graph_engine(model):
    return GraphServeEngine(model, f_in=F_IN, hidden=8, n_classes=N_CLASSES,
                            slots=4, min_bucket=32, device="cpu")


def _mb(model="gcn"):
    g, feats = _host()
    store = FeatureStore(feats.copy())
    return MiniBatchServeEngine(_graph_engine(model), g, store,
                                fanouts=FANOUTS), store


def _random_pairs(rng, n, k):
    return rng.integers(0, n, size=(k, 2))


# -- parity with the reference ----------------------------------------------

def _assert_report_equal(got, want):
    for name in ("inserted", "deleted"):
        a, b = getattr(got.delta, name), getattr(want.delta, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)
    for name in ("graph_version", "cache_invalidated", "touched_cells",
                 "replan_cells", "total_cells"):
        assert getattr(got, name) == getattr(want, name), name


def test_delta_reports_match_the_reference():
    """One deployment per package, the same weights, queries served
    between deltas (so the caches hold entries to invalidate): every
    DeltaReport, profile, cache counter and served row agrees -- the
    reports and counters exactly, the rows within 3e-4."""
    je = j_ge.GraphServeEngine("gcn", f_in=F_IN, hidden=8,
                               n_classes=N_CLASSES, slots=4, min_bucket=32)
    te = GraphServeEngine("gcn", f_in=F_IN, hidden=8, n_classes=N_CLASSES,
                          slots=4, min_bucket=32, device="cpu",
                          weights={k: np.asarray(v)
                                   for k, v in je.weights.items()})
    feats = _host()[1]
    jg = j_smp.powerlaw_host_graph(N_V, avg_degree=6, seed=0)
    tg = powerlaw_host_graph(N_V, avg_degree=6, seed=0)
    js, ts = j_mb.FeatureStore(feats.copy()), FeatureStore(feats.copy())
    jm = j_mb.MiniBatchServeEngine(je, jg, js, fanouts=FANOUTS,
                                   cache_capacity=None)
    tm = MiniBatchServeEngine(te, tg, ts, fanouts=FANOUTS,
                              cache_capacity=None)
    # (16, 16) profile blocks leave cells empty, so deltas cross SKIP
    jm.planner = j_mb.MiniBatchPlanner(
        jg, js, fanouts=FANOUTS, cache=j_mb.VertexCache(4096),
        model_key="gcn", profile_block=(16, 16))
    tm.planner = MiniBatchPlanner(tg, ts, fanouts=FANOUTS,
                                  cache=VertexCache(4096), model_key="gcn",
                                  profile_block=(16, 16))
    rng = np.random.default_rng(11)
    replanned = 0
    for step in range(6):
        queries = [rng.integers(0, N_V, size=int(rng.integers(1, 4))
                                ).tolist() for _ in range(3)]
        for t, j in zip(tm.serve_queries(queries), jm.serve_queries(queries)):
            assert t.from_cache == j.from_cache
            np.testing.assert_allclose(t.result(), np.asarray(j.result()),
                                       atol=3e-4, rtol=3e-4)
        g = tm.planner.graph
        ins = _random_pairs(rng, N_V, int(rng.integers(0, 10)))
        # deletes of present edges next to seeds just served, so cached
        # rows depend on them
        dele = [(v, int(g.neighbors(v)[0])) for q in queries for v in q
                if g.neighbors(v).size]
        insk = {tuple(sorted(p)) for p in ins.tolist()}
        dele = [d for d in dele if tuple(sorted(d)) not in insk]
        got = tm.apply_delta(ins, dele)
        want = jm.apply_delta(ins, dele)
        _assert_report_equal(got, want)
        replanned += got.replan_cells
        np.testing.assert_array_equal(tm.planner.profile.counts,
                                      jm.planner.profile.counts)
        assert tm.cache.stats.as_dict() == jm.cache.stats.as_dict()
    assert tm.planner.graph_version == jm.planner.graph_version > 0
    assert tm.cache.stats.invalidations > 0 and replanned > 0


def _fuzz_densities(rng, shape, block):
    """Block densities as a profile makes them (count / block size), with
    zero cells, full cells and cells on both sides of the FPGA bands."""
    size = block[0] * block[1]
    counts = rng.integers(0, size + 1, size=shape)
    counts[rng.random(shape) < 0.3] = 0
    counts[rng.random(shape) < 0.1] = rng.integers(1, 4)
    counts[rng.random(shape) < 0.05] = size
    return counts / size


@pytest.mark.parametrize("model", sorted(COST_MODELS))
@pytest.mark.parametrize("strategy", ["dynamic", "s2"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_delta_replan_mask_matches_the_reference(model, strategy, dtype):
    j_cls, t_cls = COST_MODELS[model]
    rng = np.random.default_rng(5)
    for block in ((128, 128), (16, 16), (64, 64)):
        old = _fuzz_densities(rng, (40, 30), block).astype(dtype)
        new = old.copy()
        moved = rng.random(old.shape) < 0.4
        new[moved] = _fuzz_densities(rng, old.shape, block)[moved]
        dens_y = np.ones((old.shape[1], 1), dtype)
        touched = old != new
        touched[rng.random(old.shape) < 0.05] = True   # unchanged, touched
        for kw in (dict(touched=touched), dict()):
            got = analyzer.delta_replan_mask(strategy, old, new, dens_y,
                                             t_cls(), **kw)
            want = np.asarray(j_an.delta_replan_mask(
                strategy, old, new, dens_y, j_cls(), **kw))
            assert got.dtype == np.bool_ and got.shape == old.shape
            np.testing.assert_array_equal(got, want)
        if strategy == "dynamic":
            assert got.any()
        else:
            assert not got.any()
    # random (unquantized) densities against a multi-column rhs
    old = rng.random((25, 20)).astype(dtype)
    new = np.where(rng.random(old.shape) < 0.5,
                   rng.random(old.shape), old).astype(dtype)
    dens_y = rng.random((20, 4)).astype(dtype)
    np.testing.assert_array_equal(
        analyzer.delta_replan_mask(strategy, old, new, dens_y, t_cls()),
        np.asarray(j_an.delta_replan_mask(strategy, old, new, dens_y,
                                          j_cls())))


def test_replan_mask_equals_two_full_port_replans():
    """On the planner's own (128, 128) profile after a delta: the mask
    equals the diff of two full ``plan_codes`` replans on CPU tensors."""
    mb, _ = _mb("gcn")
    planner = mb.planner
    old = planner.profile.densities()
    g = planner.graph
    ins = [(v, (v * 7 + 3) % N_V) for v in range(0, N_V, 9)]
    dele = [(v, int(g.neighbors(v)[0])) for v in range(1, N_V, 13)
            if g.neighbors(v).size]
    insk = {tuple(sorted(p)) for p in ins}
    dele = [d for d in dele if tuple(sorted(d)) not in insk]
    rep = mb.apply_delta(ins, dele)
    new = planner.profile.densities()
    ones = torch.ones((old.shape[1], 1))
    model = mb.engine.executor.model
    full = [analyzer.plan_codes(mb.engine.strategy, torch.from_numpy(
        d.astype(np.float32)), ones, model).numpy()
        for d in (old, new)]
    want = np.any(full[0] != full[1], axis=1)
    mask = analyzer.delta_replan_mask(
        mb.engine.strategy, old, new, np.ones((old.shape[1], 1), np.float32),
        model, touched=old != new)
    np.testing.assert_array_equal(mask, want)
    assert rep.replan_cells == int(want.sum())


@pytest.mark.parametrize("strategy,cost", [("dynamic", "tpu"),
                                           ("dynamic", "fpga"),
                                           ("s2", "fpga")])
def test_replan_cells_follow_the_serving_engine(strategy, cost):
    """A delta through the continuous server re-decides cells under the
    engine's own strategy and cost model: each ``replan_cells`` equals the
    reference's mask under those, and a static engine replans nothing."""
    j_cls, t_cls = COST_MODELS[cost]
    eng = GraphServeEngine("gcn", f_in=F_IN, hidden=8, n_classes=N_CLASSES,
                           slots=4, min_bucket=32, device="cpu",
                           strategy=strategy, cost_model=t_cls())
    g, feats = _host()
    # (16, 16) profile blocks leave cells empty, so deltas cross SKIP
    planner = MiniBatchPlanner(g, FeatureStore(feats.copy()),
                               fanouts=FANOUTS, profile_block=(16, 16))
    srv = ContinuousGraphServer(eng, minibatch=planner)
    rng = np.random.default_rng(13)
    replanned = 0
    for _ in range(3):
        old = planner.profile.densities()
        ins = [tuple(int(x) for x in p)
               for p in _random_pairs(rng, N_V, 12) if p[0] != p[1]]
        rep = srv.apply_delta(ins, [])
        new = planner.profile.densities()
        want = np.asarray(j_an.delta_replan_mask(
            strategy, old, new, np.ones((old.shape[1], 1), np.float32),
            j_cls(), touched=old != new))
        assert rep.touched_cells > 0
        assert rep.replan_cells == int(want.sum())
        replanned += rep.replan_cells
    assert (replanned > 0) == (strategy == "dynamic")


# -- the reference's streaming-delta cases, inside the port -------------------

def test_apply_delta_inserts_both_directions_and_is_pure():
    g, _ = _host()
    v = next(u for u in range(N_V) if u != 0 and u not in set(g.neighbors(0)))
    before = (g.indptr.copy(), g.indices.copy())
    new, delta = g.apply_delta([(0, v)], [])
    assert v in new.neighbors(0) and 0 in new.neighbors(v)
    assert delta.n_changed == 2              # both CSR directions
    np.testing.assert_array_equal(delta.touched_vertices, sorted({0, v}))
    np.testing.assert_array_equal(g.indptr, before[0])
    np.testing.assert_array_equal(g.indices, before[1])
    back, d2 = new.apply_delta([], [(v, 0)])  # reversed orientation is fine
    np.testing.assert_array_equal(back.indptr, g.indptr)
    np.testing.assert_array_equal(back.indices, g.indices)
    assert d2.n_changed == 2


def test_apply_delta_noops_and_errors():
    g, _ = _host()
    u = int(g.neighbors(0)[0])
    new, delta = g.apply_delta([(0, u)], [])  # insert-existing: no-op
    assert delta.n_changed == 0
    np.testing.assert_array_equal(new.indices, g.indices)
    miss = next(w for w in range(N_V)
                if w != 0 and w not in set(g.neighbors(0)))
    _, delta = g.apply_delta([], [(0, miss)])  # delete-missing: no-op
    assert delta.n_changed == 0
    _, delta = g.apply_delta([(5, 5)], [])     # self loop: dropped
    assert delta.n_changed == 0
    with pytest.raises(ValueError):            # same pair on both sides
        g.apply_delta([(0, miss)], [(miss, 0)])
    with pytest.raises(ValueError):            # out of range
        g.apply_delta([(0, N_V)], [])


def _fuzz_profile_chain(seed, steps=6, block=(64, 96)):
    rng = np.random.default_rng(seed)
    g = powerlaw_host_graph(N_V, avg_degree=5, seed=seed)
    prof = AdjacencyBlockProfile.from_graph(g, block)
    for _ in range(steps):
        ins = _random_pairs(rng, N_V, int(rng.integers(0, 12)))
        dele = []
        for _ in range(int(rng.integers(0, 8))):
            v = int(rng.integers(0, N_V))
            nb = g.neighbors(v)
            if nb.size:
                dele.append((v, int(nb[rng.integers(0, nb.size)])))
        dele.extend(_random_pairs(rng, N_V, int(rng.integers(0, 4))))
        ins_set = set(map(tuple, np.sort(np.asarray(ins).reshape(-1, 2))))
        dele = [d for d in dele if tuple(sorted(d)) not in
                {tuple(sorted(p)) for p in ins_set}]
        g, delta = g.apply_delta(ins, dele)
        prof, touched = prof.apply_delta(delta)
        scratch = AdjacencyBlockProfile.from_graph(g, block)
        np.testing.assert_array_equal(prof.counts, scratch.counts)
        assert prof.counts.sum() == g.n_edges
        if delta.n_changed == 0:
            assert not touched.any()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_patched_profile_matches_scratch_fuzzed(seed):
    _fuzz_profile_chain(seed)


def test_profile_delta_rejects_foreign_delta():
    g, _ = _host()
    empty = HostGraph(indptr=np.zeros(N_V + 1, np.int64),
                      indices=np.zeros(0, np.int64))
    prof = AdjacencyBlockProfile.from_graph(empty, (64, 64))
    u = int(g.neighbors(0)[0])
    _, delta = g.apply_delta([], [(0, u)])   # a real deletion...
    with pytest.raises(ValueError):          # ...against the wrong profile
        prof.apply_delta(delta)


def test_delta_replan_mask_equals_full_replan_diff():
    rng = np.random.default_rng(3)
    model = FPGACostModel()
    old = rng.uniform(0.0, 1.0, size=(6, 5)).astype(np.float64)
    old[rng.random((6, 5)) < 0.3] = 0.0
    new = old.copy()
    wiggle = rng.random((6, 5)) < 0.5
    new[wiggle] = np.clip(new[wiggle] * (1 + rng.uniform(
        -0.05, 0.05, size=int(wiggle.sum()))), 0.0, 1.0)
    old[0, 0], new[0, 0] = 0.8, 0.0          # cross INTO the SKIP band
    old[0, 1], new[0, 1] = 0.0, 0.9          # and back out of it
    dens_y = rng.uniform(0.1, 1.0, size=(5, 3))
    got = analyzer.delta_replan_mask("dynamic", old, new, dens_y, model)

    def codes(d):
        return analyzer.plan_codes(
            "dynamic", torch.from_numpy(d.astype(np.float32)),
            torch.from_numpy(dens_y.astype(np.float32)), model).numpy()

    want = np.any(codes(old) != codes(new), axis=1)   # (I, J, K) -> (I, K)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] and got[0, 1]


def test_delta_replan_mask_band_wiggle_is_free():
    model = FPGACostModel()
    old = np.full((4, 4), 0.7)               # deep inside the GEMM band
    new = np.full((4, 4), 0.72)
    dens_y = np.ones((4, 2))
    mask = analyzer.delta_replan_mask("dynamic", old, new, dens_y, model)
    assert not mask.any()
    for strategy in ("s2", "gemm"):
        m = analyzer.delta_replan_mask(strategy, old, np.zeros_like(new),
                                       dens_y, model)
        assert not m.any()


def _fresh_edge_at(g, v):
    """An absent edge incident to ``v`` (changes v's own neighborhood)."""
    have = set(g.neighbors(v))
    u = next(w for w in range(N_V) if w != v and w not in have)
    return (v, u)


def test_serve_after_delta_matches_fresh_oracle():
    mb, _ = _mb("gcn")
    mb.serve_queries([[7], [3]])
    assert mb.planner.lookup(7) is not None
    v0 = mb.planner.graph_version
    rep = mb.apply_delta([_fresh_edge_at(mb.planner.graph, 7)], [])
    assert isinstance(rep, DeltaReport)
    assert rep.graph_version == v0 + 1 == mb.planner.graph_version
    assert rep.delta.n_changed == 2 and rep.touched_cells >= 1
    assert rep.total_cells == mb.planner.profile.counts.size
    assert mb.planner.lookup(7) is None
    post = mb.serve_queries([[7]])[0].result()
    np.testing.assert_array_equal(post, mb.oracle_queries([[7]])[0])
    scratch = AdjacencyBlockProfile.from_graph(mb.planner.graph,
                                               mb.planner.profile_block)
    np.testing.assert_array_equal(mb.planner.profile.counts, scratch.counts)


def test_noop_delta_keeps_version_and_cache():
    mb, _ = _mb("sage")
    mb.serve_queries([[11]])
    assert mb.planner.lookup(11) is not None
    u = int(mb.planner.graph.neighbors(11)[0])
    rep = mb.apply_delta([(11, u)], [])      # insert-existing: pure no-op
    assert rep.delta.n_changed == 0
    assert rep.graph_version == 0 and rep.cache_invalidated == 0
    assert rep.touched_cells == 0 and rep.replan_cells == 0
    assert mb.planner.lookup(11) is not None


def test_inflight_across_delta_delivered_not_cached():
    mb, _ = _mb("gin")
    planner = mb.planner
    req = planner.request_for(7)
    _ = req.features                          # gather under current store
    mb.apply_delta([_fresh_edge_at(planner.graph, 7)], [])
    res = mb.engine.serve([req])[0]
    vertex, row = planner.complete(res)       # old-topology snapshot...
    assert vertex == 7 and row.shape[0] == N_CLASSES
    assert planner.lookup(7) is None, (
        "result sampled pre-delta was cached post-delta")
    fresh = mb.serve_queries([[7]])[0].result()[0]
    np.testing.assert_array_equal(fresh, mb.oracle_queries([[7]])[0][0])


def test_server_apply_delta_front_door_and_coalescing():
    mb, _ = _mb("gcn")
    srv = ContinuousGraphServer(_graph_engine("gcn"), minibatch=mb.planner)
    q1 = srv.submit_query([7])
    assert mb.planner.inflight == 1
    rep = srv.apply_delta([_fresh_edge_at(mb.planner.graph, 7)], [])
    assert rep.graph_version == 1
    q2 = srv.submit_query([7])                # must NOT coalesce onto q1
    assert mb.planner.inflight == 2
    for _ in range(50):
        srv.poll()
        srv.drain()
        if q1.done and q2.done:
            break
    assert q1.done and q2.done
    want = mb.oracle_queries([[7]])[0]        # post-delta oracle
    np.testing.assert_array_equal(q2.result(), want)
    cached = mb.planner.lookup(7)
    assert cached is not None
    np.testing.assert_array_equal(cached, q2.result()[0])


def test_server_apply_delta_requires_planner():
    srv = ContinuousGraphServer(_graph_engine("gcn"))
    with pytest.raises(ValueError):
        srv.apply_delta([(0, 1)], [])


if HAVE_HYPOTHESIS:

    @settings(max_examples=8, deadline=None)
    @given(seed=st.integers(0, 2**16))
    def test_fuzzed_profile_chain(seed):
        _fuzz_profile_chain(seed, steps=4, block=(96, 64))
