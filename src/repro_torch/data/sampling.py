"""Host-side neighbor sampling over a giant CSR graph.

Port of ``repro.data.sampling`` (numpy and ``zlib`` only, so a copy; the
samples, graphs, deltas and profiles are bitwise the reference's).
Production GNN traffic (recommendation, fraud) queries ONE graph with up
to ~10^8 vertices through neighborhood sampling: a query names a few seed
vertices, the host samples a bounded-fanout neighborhood around them, and
only that induced subgraph flows through the device.  This module is the
host half of that pipeline: a compressed-sparse-row :class:`HostGraph`
that never materializes |V|^2 anything, a power-law generator at serving
scale (:func:`powerlaw_host_graph`), and the fanout sampler
(:func:`sample_subgraph`) whose output rides the serving stack unchanged
-- a :class:`SampledSubgraph` is a small dense adjacency plus a
local->global index map, exactly the shape
``serving.graph_engine.GraphRequest`` admits, so density is profiled and
the K2P plan re-made per sampled batch.

Everything here is numpy only and off the device: sampling happens at
submit time, the device only ever sees the bucket-padded wave tensors.

Determinism contract: ``sample_subgraph(graph, seeds, fanouts, seed=s)``
is a pure function of its arguments -- same call, bitwise-same subgraph.
``serving.minibatch`` leans on this: it derives a per-seed-vertex seed
(:func:`vertex_seed`), making each seed vertex's sampled neighborhood --
and therefore its inference result -- a pure function of (vertex, model,
fanouts, feature-store version), which is what makes the hot-vertex
result cache exact instead of approximate.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data import graphs as graph_data


def vertex_seed(seed: int, vertex: int) -> int:
    """Process-stable per-vertex derived seed (``data.graphs._name_seed``
    idiom: ``hash()`` is salted per run, crc32 is not).  The mini-batch
    planner samples vertex ``v``'s neighborhood under
    ``vertex_seed(sample_seed, v)``, so the subgraph -- hence the result
    row a cache entry stores -- never depends on which other seeds share
    the query or how traffic was batched."""
    return int(seed) + zlib.crc32(int(vertex).to_bytes(8, "little")) % (1 << 20)


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """A giant undirected graph in CSR form: ``indices[indptr[v]:
    indptr[v+1]]`` are vertex ``v``'s neighbors (sorted, deduplicated, no
    self loops -- the serving engine forces self loops during
    normalization, like ``data.graphs.materialize``)."""

    indptr: np.ndarray               # (n_vertices + 1,) int64
    indices: np.ndarray              # (n_edges,) int64

    @property
    def n_vertices(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def validate(self) -> "HostGraph":
        indptr, indices = self.indptr, self.indices
        if indptr.ndim != 1 or indptr.shape[0] < 1:
            raise ValueError(f"indptr shape {indptr.shape}")
        if indptr[0] != 0 or indptr[-1] != indices.shape[0]:
            raise ValueError("indptr does not span indices")
        if np.any(np.diff(indptr) < 0):
            raise ValueError("indptr not monotone")
        n = self.n_vertices
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            raise ValueError(f"neighbor index out of range [0, {n})")
        return self

    def _flat_edges(self) -> np.ndarray:
        """Sorted flat keys ``u * n + v`` of every directed CSR entry."""
        n = self.n_vertices
        u = np.repeat(np.arange(n, dtype=np.int64), self.degrees)
        return u * n + self.indices

    def apply_delta(self, edge_inserts, edge_deletes
                    ) -> Tuple["HostGraph", "GraphDelta"]:
        """Streaming update: returns ``(new_graph, delta)``; self is frozen.

        ``edge_inserts``/``edge_deletes`` are ``(k, 2)``-shaped undirected
        vertex pairs (any iterable of pairs).  Both are symmetrized,
        self loops dropped, duplicates collapsed; inserting an existing
        edge or deleting a missing one is a no-op.  A pair in both lists
        is an error (the net effect would be order-defined).  The returned
        :class:`GraphDelta` records only the edges that ACTUALLY changed
        -- in both CSR directions -- which is what the incremental profile
        patch (:meth:`AdjacencyBlockProfile.apply_delta`) and the serving
        cache invalidation (``serving.minibatch``) consume.
        """
        n = self.n_vertices

        def _canon(pairs) -> np.ndarray:
            p = np.asarray(list(pairs), np.int64).reshape(-1, 2)
            if p.size and (p.min() < 0 or p.max() >= n):
                raise ValueError(f"delta vertex out of range [0, {n})")
            p = p[p[:, 0] != p[:, 1]]
            u = np.concatenate([p[:, 0], p[:, 1]])
            v = np.concatenate([p[:, 1], p[:, 0]])
            return np.unique(u * n + v)

        ins, dele = _canon(edge_inserts), _canon(edge_deletes)
        both = np.intersect1d(ins, dele)
        if both.size:
            raise ValueError(
                f"{both.size // 2} edge(s) appear in both inserts and "
                f"deletes")
        cur = self._flat_edges()
        ins = np.setdiff1d(ins, cur)         # only edges actually new
        dele = np.intersect1d(dele, cur)     # only edges actually present
        flat = np.setdiff1d(np.concatenate([cur, ins]), dele)
        u, v = flat // n, flat % n
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, u + 1, 1)
        np.cumsum(indptr, out=indptr)
        new = HostGraph(indptr=indptr, indices=v).validate()
        delta = GraphDelta(
            inserted=np.stack([ins // n, ins % n], axis=1),
            deleted=np.stack([dele // n, dele % n], axis=1))
        return new, delta


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """The edges a :meth:`HostGraph.apply_delta` call ACTUALLY changed.

    Both arrays are ``(k, 2)`` int64 DIRECTED pairs (each undirected edge
    appears in both orientations, matching the CSR's storage), already
    filtered down to real changes: inserts that existed and deletes that
    did not are gone.  ``touched_vertices`` is the invalidation set for
    serving caches -- a sampled neighborhood can only have changed if it
    contains a touched vertex, because the sampler reads nothing but the
    neighbor rows of the vertices it visits.
    """

    inserted: np.ndarray             # (k_i, 2) int64 directed pairs
    deleted: np.ndarray              # (k_d, 2) int64 directed pairs

    @property
    def n_changed(self) -> int:
        return int(self.inserted.shape[0] + self.deleted.shape[0])

    @property
    def touched_vertices(self) -> np.ndarray:
        """Sorted unique endpoints of every changed edge."""
        return np.unique(np.concatenate(
            [self.inserted.reshape(-1), self.deleted.reshape(-1)]))


@dataclasses.dataclass(frozen=True)
class AdjacencyBlockProfile:
    """Host-side block-sparsity profile of a :class:`HostGraph`'s structure.

    ``counts[i, j]`` is the number of directed CSR edges landing in block
    ``(i, j)`` of the (|V|, |V|) 0/1 adjacency STRUCTURE (no self loops,
    no normalization -- the raw support whose density drives K2P planning).
    The point of the class is :meth:`apply_delta`: a streaming edge update
    patches ONLY the touched cells (``np.add.at`` over the changed edges'
    block coordinates), bitwise equal to re-profiling the mutated graph
    from scratch -- integer counts, same sums in a different order.
    """

    counts: np.ndarray               # (Mb, Nb) int64
    shape: Tuple[int, int]           # (|V|, |V|)
    block: Tuple[int, int]           # (bm, bn)

    @classmethod
    def from_graph(cls, graph: HostGraph,
                   block: Tuple[int, int]) -> "AdjacencyBlockProfile":
        n = graph.n_vertices
        bm, bn = block
        mb, nb = -(-n // bm), -(-n // bn)
        u = np.repeat(np.arange(n, dtype=np.int64), graph.degrees)
        cells = (u // bm) * nb + graph.indices // bn
        counts = np.bincount(cells, minlength=mb * nb).reshape(mb, nb)
        return cls(counts=counts.astype(np.int64), shape=(n, n),
                   block=(bm, bn))

    def apply_delta(self, delta: GraphDelta
                    ) -> Tuple["AdjacencyBlockProfile", np.ndarray]:
        """Patch the profile with a :class:`GraphDelta`.

        Returns ``(new_profile, touched)`` where ``touched`` is the (Mb,
        Nb) bool mask of cells whose count changed -- the only cells whose
        K2P decision can have moved, which is what
        ``analyzer.delta_replan_mask`` narrows its re-``select``
        to.  O(changed edges), never O(|V|^2 / block^2).
        """
        bm, bn = self.block
        counts = self.counts.copy()
        touched = np.zeros_like(counts, dtype=bool)
        for pairs, sign in ((delta.inserted, 1), (delta.deleted, -1)):
            if pairs.shape[0] == 0:
                continue
            bi, bj = pairs[:, 0] // bm, pairs[:, 1] // bn
            np.add.at(counts, (bi, bj), sign)
            touched[bi, bj] = True
        if counts.min(initial=0) < 0:
            raise ValueError("profile drove a block count negative "
                             "(delta does not match this profile's graph)")
        return (AdjacencyBlockProfile(counts=counts, shape=self.shape,
                                      block=self.block),
                touched)

    def densities(self) -> np.ndarray:
        """(Mb, Nb) densities normalized to the unpadded elements in each
        block (the ``profiler.density_from_counts`` rule, host-side)."""
        m, n = self.shape
        bm, bn = self.block
        mb, nb = self.counts.shape
        rows = np.clip(m - np.arange(mb) * bm, 0, bm)
        cols = np.clip(n - np.arange(nb) * bn, 0, bn)
        sizes = rows[:, None] * cols[None, :]
        return self.counts / np.maximum(sizes, 1)


def powerlaw_host_graph(n_vertices: int, *, avg_degree: int = 8,
                        alpha: float = 1.6, seed: int = 0) -> HostGraph:
    """A serving-scale synthetic host graph (10^5+ vertices in well under a
    second): undirected edges drawn with power-law degree weights on both
    endpoints (``data.graphs.powerlaw_marginal`` -- the same recipe the
    Table VI generators use), symmetrized and deduplicated into CSR.  Hub
    vertices end up with degrees orders of magnitude above the mean, which
    is exactly what makes a hot-vertex cache worth having."""
    if n_vertices < 2:
        raise ValueError(f"n_vertices {n_vertices} < 2")
    rng = np.random.default_rng(seed)
    e = max(int(n_vertices) * int(avg_degree) // 2, 1)
    w = graph_data.powerlaw_marginal(n_vertices, rng, alpha=alpha)
    src = rng.choice(n_vertices, size=e, p=w)
    # half the endpoints uniform (the ``data.graphs.materialize`` mix): a
    # pure power-law x power-law product concentrates both endpoints on
    # the same few hubs and deduplication collapses the edge count; the
    # mix keeps hubs hot while realizing the requested average degree
    dst = rng.choice(n_vertices, size=e, p=w)
    mix = rng.random(e) < 0.5
    dst = np.where(mix, rng.integers(0, n_vertices, size=e), dst)
    keep = src != dst                       # no self loops in the host CSR
    src, dst = src[keep], dst[keep]
    # symmetrize, then dedupe via the flat edge key
    u = np.concatenate([src, dst]).astype(np.int64)
    v = np.concatenate([dst, src]).astype(np.int64)
    flat = np.unique(u * n_vertices + v)
    u, v = flat // n_vertices, flat % n_vertices
    order = np.lexsort((v, u))
    u, v = u[order], v[order]
    indptr = np.zeros(n_vertices + 1, np.int64)
    np.add.at(indptr, u + 1, 1)
    np.cumsum(indptr, out=indptr)
    return HostGraph(indptr=indptr, indices=v).validate()


@dataclasses.dataclass
class SampledSubgraph:
    """A vertex-induced subgraph around a seed set.

    ``vertices`` is the local->global index map: local vertex ``i`` is
    global vertex ``vertices[i]``; the (deduplicated) seeds occupy locals
    ``0..len(seeds)-1`` in submission order, so a seed's result row is
    always row ``i`` of the request's logits.  ``adjacency`` is the dense
    0/1 INDUCED adjacency over those vertices -- every host edge between
    two sampled vertices is present, whether or not the sampler walked it,
    so the subgraph is a faithful restriction of the host graph (what the
    oracle-parity tests lean on).  ``hops[h]`` lists the global vertices
    first reached at hop ``h`` (``hops[0]`` = the seeds), which is how the
    property tests check the per-hop fanout bound.
    """

    vertices: np.ndarray             # (k,) int64 global ids, seeds first
    adjacency: np.ndarray            # (k, k) float32 0/1, induced, symmetric
    hops: List[np.ndarray]           # per-hop newly-reached global ids
    fanouts: tuple                   # the fanout schedule that was sampled
    seed: int                        # the sampling seed that was used

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def n_seeds(self) -> int:
        return int(self.hops[0].shape[0])


def sample_subgraph(graph: HostGraph, seeds: Sequence[int],
                    fanouts: Sequence[int], *,
                    seed: int = 0) -> SampledSubgraph:
    """Fanout neighbor sampling: hop ``h`` samples at most ``fanouts[h]``
    neighbors (without replacement; all of them when the degree fits) of
    every vertex in the hop's frontier, and the subgraph is the induced
    restriction of the host graph to everything reached.

    Deterministic under ``seed`` (one ``default_rng(seed)`` consumed in
    frontier order), NumPy-only, never materializes more than the sampled
    vertex set.  ``fanouts=()`` or all-zero fanouts give the seeds-only
    subgraph; a fanout >= the max degree takes the exact h-hop
    neighborhood (no randomness consumed for full rows, so full-fanout
    sampling is seed-independent).  Duplicate seeds are deduplicated
    (first occurrence wins the local slot).
    """
    seeds = np.asarray(list(dict.fromkeys(int(v) for v in seeds)), np.int64)
    if seeds.size == 0:
        raise ValueError("sample_subgraph with no seeds")
    n = graph.n_vertices
    if seeds.min() < 0 or seeds.max() >= n:
        raise ValueError(f"seed vertex out of range [0, {n})")
    fanouts = tuple(int(f) for f in fanouts)
    if any(f < 0 for f in fanouts):
        raise ValueError(f"negative fanout in {fanouts}")
    rng = np.random.default_rng(seed)
    local_of = {int(v): i for i, v in enumerate(seeds)}
    vertices = list(seeds)
    hops = [seeds.copy()]
    frontier = seeds
    for f in fanouts:
        new: List[int] = []
        if f > 0:
            for v in frontier:
                nbrs = graph.neighbors(int(v))
                if nbrs.shape[0] > f:
                    nbrs = rng.choice(nbrs, size=f, replace=False)
                for u in nbrs:
                    u = int(u)
                    if u not in local_of:
                        local_of[u] = len(vertices)
                        vertices.append(u)
                        new.append(u)
        frontier = np.asarray(new, np.int64)
        hops.append(frontier)
        if frontier.size == 0:
            # every remaining hop is empty too; record them so
            # len(hops) == len(fanouts) + 1 always holds
            hops.extend(np.zeros(0, np.int64)
                        for _ in range(len(fanouts) - len(hops) + 1))
            break
    verts = np.asarray(vertices, np.int64)
    k = verts.shape[0]
    # vectorized induced-adjacency build (the per-vertex Python loop here
    # dominated high-fanout sampling): gather every sampled vertex's full
    # neighbor row in one flat take, then map global neighbor ids to local
    # slots with a sorted lookup.  Bitwise-identical to the loop -- the
    # rng is untouched and 0/1 assignment is order-free.
    starts = graph.indptr[verts]
    counts = (graph.indptr[verts + 1] - starts).astype(np.int64)
    total = int(counts.sum())
    adj = np.zeros((k, k), np.float32)
    if total:
        offs = np.cumsum(counts) - counts          # row start in flat gather
        idx = (np.arange(total) - np.repeat(offs, counts)
               + np.repeat(starts, counts))
        nbrs = graph.indices[idx]
        rows = np.repeat(np.arange(k), counts)
        order = np.argsort(verts, kind="stable")
        sorted_v = verts[order]
        pos = np.searchsorted(sorted_v, nbrs)
        valid = (pos < k) & (sorted_v[np.minimum(pos, k - 1)] == nbrs)
        adj[rows[valid], order[pos[valid]]] = 1.0
    return SampledSubgraph(vertices=verts, adjacency=adj, hops=hops,
                           fanouts=fanouts, seed=int(seed))
