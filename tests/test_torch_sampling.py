"""The port's neighbor sampler against the JAX package's, on the CPU.

``repro_torch.data.sampling`` is a numpy copy of ``repro.data.sampling``,
so everything it makes must equal the reference's bit for bit: host
graphs, sampled subgraphs (vertices, induced adjacency, hops), per-vertex
seeds, streaming deltas and the incremental block profile, on seeded
sweeps.  Then the reference's sampler cases (``tests/test_sampling.py``)
run inside the port, with their hypothesis properties where hypothesis is
installed.
"""
import numpy as np
import pytest

from conftest import HAVE_HYPOTHESIS, given, settings, st
from repro.data import sampling as j_smp
from repro_torch.data import sampling as t_smp
from repro_torch.data.sampling import (AdjacencyBlockProfile, HostGraph,
                                       powerlaw_host_graph, sample_subgraph,
                                       vertex_seed)


def _graph(n, seed, avg_degree=6):
    return powerlaw_host_graph(n, avg_degree=avg_degree, seed=seed)


def _assert_graph_equal(got, want):
    for name in ("indptr", "indices"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_subgraph_equal(got, want):
    np.testing.assert_array_equal(got.vertices, want.vertices)
    assert got.vertices.dtype == want.vertices.dtype
    assert got.adjacency.dtype == want.adjacency.dtype == np.float32
    np.testing.assert_array_equal(got.adjacency, want.adjacency)
    assert len(got.hops) == len(want.hops)
    for a, b in zip(got.hops, want.hops):
        np.testing.assert_array_equal(a, b)
    assert (got.fanouts, got.seed) == (want.fanouts, want.seed)


# -- parity with the reference ----------------------------------------------

@pytest.mark.parametrize("n,avg_degree,alpha,seed", [
    (2, 8, 1.6, 0), (50, 6, 1.6, 0), (400, 6, 1.6, 0), (400, 5, 1.6, 3),
    (1000, 12, 2.1, 7), (3000, 8, 1.6, 11)])
def test_powerlaw_host_graph_matches_the_reference(n, avg_degree, alpha,
                                                   seed):
    got = powerlaw_host_graph(n, avg_degree=avg_degree, alpha=alpha,
                              seed=seed)
    want = j_smp.powerlaw_host_graph(n, avg_degree=avg_degree, alpha=alpha,
                                     seed=seed)
    _assert_graph_equal(got, want)
    assert (got.n_vertices, got.n_edges) == (want.n_vertices, want.n_edges)
    np.testing.assert_array_equal(got.degrees, want.degrees)


@pytest.mark.parametrize("case", range(6))
def test_sample_subgraph_matches_the_reference(case):
    rng = np.random.default_rng(100 + case)
    n = int(rng.integers(40, 600))
    got_g = _graph(n, case)
    want_g = j_smp.powerlaw_host_graph(n, avg_degree=6, seed=case)
    for _ in range(6):
        seeds = rng.integers(0, n, size=int(rng.integers(1, 5))).tolist()
        fanouts = tuple(int(f) for f in
                        rng.integers(0, 9, size=int(rng.integers(0, 4))))
        seed = int(rng.integers(1 << 20))
        _assert_subgraph_equal(
            sample_subgraph(got_g, seeds, fanouts, seed=seed),
            j_smp.sample_subgraph(want_g, seeds, fanouts, seed=seed))
    # the planner's per-vertex draw
    for v in rng.integers(0, n, size=8).tolist():
        s = vertex_seed(5, v)
        assert s == j_smp.vertex_seed(5, v)
        _assert_subgraph_equal(
            sample_subgraph(got_g, [v], (3, 2), seed=s),
            j_smp.sample_subgraph(want_g, [v], (3, 2), seed=s))


def test_vertex_seed_matches_the_reference():
    for seed in (0, 3, 1 << 30):
        for v in list(range(300)) + [2**31 + 5, 10**9]:
            assert vertex_seed(seed, v) == j_smp.vertex_seed(seed, v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_delta_chain_and_profile_match_the_reference(seed):
    """A chain of deltas through both packages: the mutated graphs, the
    canonical deltas, the patched profiles and their touched masks and
    densities, equal exactly."""
    rng = np.random.default_rng(seed)
    n = 400
    tg = _graph(n, seed, avg_degree=5)
    jg = j_smp.powerlaw_host_graph(n, avg_degree=5, seed=seed)
    block = ((64, 96), (128, 128), (50, 50))[seed]
    tp = AdjacencyBlockProfile.from_graph(tg, block)
    jp = j_smp.AdjacencyBlockProfile.from_graph(jg, block)
    np.testing.assert_array_equal(tp.counts, jp.counts)
    for _ in range(5):
        ins = rng.integers(0, n, size=(int(rng.integers(0, 10)), 2))
        dele = [(v, int(tg.neighbors(v)[0])) for v in
                rng.integers(0, n, size=int(rng.integers(0, 6))).tolist()
                if tg.neighbors(v).size]
        insk = {tuple(sorted(p)) for p in ins.tolist()}
        dele = [d for d in dele if tuple(sorted(d)) not in insk]
        tg, td = tg.apply_delta(ins, dele)
        jg, jd = jg.apply_delta(ins, dele)
        _assert_graph_equal(tg, jg)
        for name in ("inserted", "deleted"):
            a, b = getattr(td, name), getattr(jd, name)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(td.touched_vertices,
                                      jd.touched_vertices)
        assert td.n_changed == jd.n_changed
        tp, t_touched = tp.apply_delta(td)
        jp, j_touched = jp.apply_delta(jd)
        np.testing.assert_array_equal(tp.counts, jp.counts)
        np.testing.assert_array_equal(t_touched, j_touched)
        np.testing.assert_array_equal(tp.densities(), jp.densities())
        assert (tp.shape, tp.block) == (jp.shape, jp.block)


def test_errors_match_the_reference():
    tg, jg = _graph(60, 0), j_smp.powerlaw_host_graph(60, avg_degree=6,
                                                       seed=0)
    miss = next(w for w in range(1, 60) if w not in set(tg.neighbors(0)))
    calls = [lambda m, g: m.sample_subgraph(g, [], (2,)),
             lambda m, g: m.sample_subgraph(g, [60], (2,)),
             lambda m, g: m.sample_subgraph(g, [0], (-1,)),
             lambda m, g: m.powerlaw_host_graph(1),
             lambda m, g: g.apply_delta([(0, miss)], [(miss, 0)]),
             lambda m, g: g.apply_delta([(0, 60)], [])]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(j_smp, jg)
        with pytest.raises(ValueError) as got:
            call(t_smp, tg)
        assert str(got.value) == str(want.value)


# -- the reference's sampler cases, inside the port --------------------------

def check_host_graph_valid(n, seed):
    g = _graph(n, seed)
    g.validate()
    # no self loops, per-row sorted unique neighbor lists
    for v in range(min(n, 64)):
        nbrs = g.neighbors(v)
        assert np.all(nbrs != v)
        assert np.all(np.diff(nbrs) > 0), f"row {v} not sorted-unique"
    # symmetric: (u, v) present iff (v, u) present
    flat = set()
    for v in range(g.n_vertices):
        for u in g.neighbors(v):
            flat.add((v, int(u)))
    assert all((u, v) in flat for v, u in flat)
    # deterministic under seed
    _assert_graph_equal(g, _graph(n, seed))


def check_sampled_subgraph_valid(graph, seeds, fanouts, seed):
    """Vertex-induced and valid: the local->global map is injective and in
    range, seeds hold the first local slots, the hop lists partition the
    vertex set under the per-hop fanout bound, and the dense adjacency is
    exactly the host graph's restriction to the sampled vertices."""
    sub = sample_subgraph(graph, seeds, fanouts, seed=seed)
    uniq = list(dict.fromkeys(int(v) for v in seeds))
    k = sub.n_vertices
    assert len(np.unique(sub.vertices)) == k, "local->global not injective"
    assert sub.vertices.min() >= 0 and sub.vertices.max() < graph.n_vertices
    np.testing.assert_array_equal(sub.vertices[: len(uniq)], uniq)
    assert sub.n_seeds == len(uniq)
    assert len(sub.hops) == len(tuple(fanouts)) + 1
    np.testing.assert_array_equal(np.sort(np.concatenate(sub.hops)),
                                  np.sort(sub.vertices))
    for h, f in enumerate(tuple(fanouts)):
        assert len(sub.hops[h + 1]) <= len(sub.hops[h]) * int(f), (
            f"hop {h + 1} exceeds fanout bound")
    local = {int(v): i for i, v in enumerate(sub.vertices)}
    want = np.zeros((k, k), np.float32)
    for i, v in enumerate(sub.vertices):
        for u in graph.neighbors(int(v)):
            j = local.get(int(u))
            if j is not None:
                want[i, j] = 1.0
    np.testing.assert_array_equal(sub.adjacency, want)
    np.testing.assert_array_equal(sub.adjacency, sub.adjacency.T)
    assert set(np.unique(sub.adjacency)) <= {0.0, 1.0}
    return sub


def check_deterministic_under_seed(graph, seeds, fanouts, seed):
    _assert_subgraph_equal(sample_subgraph(graph, seeds, fanouts, seed=seed),
                           sample_subgraph(graph, seeds, fanouts, seed=seed))


@pytest.mark.parametrize("n,seed", [(50, 0), (200, 1), (500, 2)])
def test_host_graph_valid_sweep(n, seed):
    check_host_graph_valid(n, seed)


@pytest.mark.parametrize("case", range(8))
def test_sampled_subgraph_valid_sweep(case):
    rng = np.random.default_rng(case)
    g = _graph(int(rng.integers(40, 400)), case)
    n_seeds = int(rng.integers(1, 5))
    seeds = rng.integers(0, g.n_vertices, size=n_seeds).tolist()
    fanouts = tuple(int(f) for f in
                    rng.integers(0, 6, size=int(rng.integers(1, 4))))
    check_sampled_subgraph_valid(g, seeds, fanouts, int(rng.integers(1000)))
    check_deterministic_under_seed(g, seeds, fanouts,
                                   int(rng.integers(1000)))


def test_fanout_zero_is_seeds_only():
    g = _graph(100, 3)
    for fanouts in ((), (0,), (0, 0)):
        sub = sample_subgraph(g, [7, 3, 11], fanouts, seed=5)
        np.testing.assert_array_equal(sub.vertices, [7, 3, 11])
        check_sampled_subgraph_valid(g, [7, 3, 11], fanouts, 5)


def test_full_fanout_is_exact_neighborhood_and_seed_independent():
    """A fanout >= the max degree takes the whole h-hop neighborhood,
    whatever the sampling seed (full rows consume no randomness)."""
    g = _graph(120, 4)
    f = int(g.degrees.max())
    seeds = [int(np.argmax(g.degrees))]          # the biggest hub
    a = sample_subgraph(g, seeds, (f, f), seed=0)
    b = sample_subgraph(g, seeds, (f, f), seed=12345)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.adjacency, b.adjacency)
    want = set(seeds)
    frontier = set(seeds)
    for _ in range(2):
        nxt = set()
        for v in frontier:
            nxt |= {int(u) for u in g.neighbors(v)}
        frontier = nxt - want
        want |= nxt
    assert set(int(v) for v in a.vertices) == want


def test_duplicate_seeds_deduplicate():
    g = _graph(80, 6)
    sub = sample_subgraph(g, [5, 5, 9, 5], (2,), seed=1)
    assert sub.n_seeds == 2
    np.testing.assert_array_equal(sub.vertices[:2], [5, 9])


def test_isolated_seed_is_fine():
    """A degree-0 vertex samples to a 1-vertex, 0-edge subgraph."""
    g = HostGraph(indptr=np.array([0, 1, 2, 2], np.int64),
                  indices=np.array([1, 0], np.int64)).validate()
    sub = sample_subgraph(g, [2], (4, 4), seed=0)
    assert sub.n_vertices == 1
    np.testing.assert_array_equal(sub.adjacency, np.zeros((1, 1)))


def test_sampler_rejects_bad_input():
    g = _graph(50, 0)
    with pytest.raises(ValueError):
        sample_subgraph(g, [], (2,))
    with pytest.raises(ValueError):
        sample_subgraph(g, [50], (2,))
    with pytest.raises(ValueError):
        sample_subgraph(g, [-1], (2,))
    with pytest.raises(ValueError):
        sample_subgraph(g, [0], (-1,))
    with pytest.raises(ValueError):
        powerlaw_host_graph(1)


def test_vertex_seed_is_stable_and_distinct():
    assert vertex_seed(3, 17) == vertex_seed(3, 17)
    seeds = {vertex_seed(0, v) for v in range(2048)}
    assert len(seeds) > 2000            # crc32 collisions are rare


if HAVE_HYPOTHESIS:

    @settings(max_examples=20, deadline=None)
    @given(n=st.integers(40, 300), seed=st.integers(0, 2**16))
    def test_host_graph_valid_property(n, seed):
        check_host_graph_valid(n, seed)

    @settings(max_examples=25, deadline=None)
    @given(n=st.integers(40, 300), gseed=st.integers(0, 2**8),
           n_seeds=st.integers(1, 4),
           fanouts=st.lists(st.integers(0, 6), min_size=1, max_size=3),
           seed=st.integers(0, 2**16))
    def test_sampled_subgraph_property(n, gseed, n_seeds, fanouts, seed):
        g = _graph(n, gseed)
        rng = np.random.default_rng(seed)
        seeds = rng.integers(0, g.n_vertices, size=n_seeds).tolist()
        check_sampled_subgraph_valid(g, seeds, tuple(fanouts), seed)
        check_deterministic_under_seed(g, seeds, tuple(fanouts), seed)
