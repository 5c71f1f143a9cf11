"""Synthetic graphs matching the paper's Table VI statistics.

No internet in this container, so the six benchmark graphs (CiteSeer, Cora,
PubMed, Flickr, NELL, Reddit) are regenerated synthetically with matched
|V|, |E|, feature width, class count, adjacency density, and H0 density.
Degree distributions are power-law with a locality boost (real graphs have
block-diagonal mass after community ordering -- what makes per-PARTITION
density vary, the property Dynasparse exploits).

Two granularities:

* :func:`block_stats` / :func:`weight_stats` -- block-level density grids
  generated directly (a multinomial over block probabilities), never
  materializing |V|^2 anything.  They feed the cost-model simulator
  (``core.runtime.simulate_inference``) at full Table VI scale.
* :func:`materialize` -- dense graphs (optionally scaled down) for the
  real-numerics engines.

This module is numpy only and draws from the same seeded generators, in
the same order, as ``repro.data.graphs``, so both packages generate
bitwise-identical statistics and graphs.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.profiler import SparsityStats

def _name_seed(name: str, seed: int) -> int:
    """Process-stable per-dataset seed (``hash(str)`` is salted per run)."""
    return seed + zlib.crc32(name.encode()) % 65536


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    """Table VI row."""

    name: str
    n_vertices: int
    n_edges: int
    f_in: int
    n_classes: int
    density_a: float          # fraction (Table VI given in %)
    density_h0: float
    hidden: int               # paper Section VIII-A: 16 small / 128 large


TABLE_VI: Dict[str, GraphSpec] = {
    "CI": GraphSpec("CI", 3327, 4732, 3703, 6, 0.0008, 0.0085, 16),
    "CO": GraphSpec("CO", 2708, 5429, 1433, 7, 0.0014, 0.0127, 16),
    "PU": GraphSpec("PU", 19717, 44338, 500, 3, 0.0002, 0.100, 16),
    "FL": GraphSpec("FL", 89250, 899756, 500, 7, 0.0001, 0.464, 128),
    "NE": GraphSpec("NE", 65755, 251550, 61278, 186, 0.000058, 0.0001, 128),
    "RE": GraphSpec("RE", 232965, 110_000_000, 602, 41, 0.0021, 1.0, 128),
}


def powerlaw_marginal(n: int, rng: np.random.Generator,
                      alpha: float = 1.6) -> np.ndarray:
    """Normalized power-law block mass (heavy hubs first, shuffled).

    """
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    rng.shuffle(w)
    return w / w.sum()


_powerlaw_marginal = powerlaw_marginal       # internal callers' name


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def block_stats(name: str, n1: int, n2: int, *, seed: int = 0,
                locality: float = 4.0) -> Dict[str, SparsityStats]:
    """Density statistics for A (at N1xN1) and H0 (at N2xN2).

    The adjacency block-count matrix is a multinomial over block
    probabilities p_ij ~ r_i * c_j * (1 + locality * 1[i==j]) with power-law
    marginals; H0 density is column-skewed lognormal around the Table VI
    mean (real feature matrices have hot/cold feature columns).
    """
    spec = TABLE_VI[name]
    rng = np.random.default_rng(_name_seed(name, seed))
    gb = _ceil_div(spec.n_vertices, n1)
    r = _powerlaw_marginal(gb, rng)
    c = _powerlaw_marginal(gb, rng)
    p = np.outer(r, c)
    p[np.diag_indices(gb)] *= (1.0 + locality)
    p /= p.sum()
    # expected edge count per block; Poisson-dispersed for realism
    lam = spec.n_edges * p
    counts = rng.poisson(lam).astype(np.float64)
    # self-loops (A-hat = A + I) make diagonal blocks nonzero
    counts[np.diag_indices(gb)] += n1
    sizes = _block_sizes(spec.n_vertices, n1)
    area = np.outer(sizes, sizes)
    dens_a = np.minimum(counts / np.maximum(area, 1), 1.0)
    a_stats = SparsityStats.from_predicted(
        (spec.n_vertices, spec.n_vertices), (n1, n1), dens_a)

    fb = _ceil_div(spec.f_in, n2)
    vb = _ceil_div(spec.n_vertices, n2)
    col_skew = _cold_column_skew(fb, rng, spec.density_h0)
    dens_h = np.clip(spec.density_h0 * np.outer(np.ones(vb), col_skew), 0, 1)
    h_stats = SparsityStats.from_predicted(
        (spec.n_vertices, spec.f_in), (n2, n2), dens_h)
    return {"A": a_stats, "A_mean": a_stats, "H0": h_stats}


def weight_stats(dims, n2: int, density: float = 1.0, *, seed: int = 0,
                 names=None) -> Dict[str, SparsityStats]:
    """Stats for (optionally pruned) weight matrices at N2xN2 blocks.

    Magnitude pruning leaves roughly uniform per-block density; a mild skew
    models structured pruning artifacts.  Every call draws from a fresh
    ``default_rng(seed)``.
    """
    rng = np.random.default_rng(seed)
    out = {}
    names = names or [f"W{l}" for l in range(1, len(dims))]
    for l, wname in enumerate(names, start=1):
        fi, fo = dims[l - 1], dims[l]
        gb_i, gb_o = _ceil_div(fi, n2), _ceil_div(fo, n2)
        skew = rng.lognormal(0.0, 0.25, size=(gb_i, gb_o))
        skew /= skew.mean()
        dens = np.clip(density * skew, 0, 1) if density < 1.0 else np.ones(
            (gb_i, gb_o))
        out[wname] = SparsityStats.from_predicted((fi, fo), (n2, n2), dens)
    return out


def _cold_column_skew(n: int, rng: np.random.Generator,
                      density: float) -> np.ndarray:
    """Hot/cold feature-column profile with mean 1.

    Real bag-of-words features (CiteSeer/Cora/NELL) have entirely-zero
    column groups; Algorithm 7 SKIPs those partitions, which is part of the
    paper's dynamic win.  The colder the matrix, the larger the dead share.
    """
    skew = rng.lognormal(0.0, 1.0, size=(n,))
    dead_frac = float(np.clip(0.45 * (1.0 - density) ** 4, 0.0, 0.9))
    dead = rng.random(n) < dead_frac
    skew[dead] = 0.0
    mean = skew.mean()
    return skew / mean if mean > 0 else np.ones(n)


def _block_sizes(n: int, b: int) -> np.ndarray:
    gb = _ceil_div(n, b)
    sizes = np.full(gb, b)
    if n % b:
        sizes[-1] = n % b
    return sizes


def normalize_adjacency(a: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(A + I)`` under both aggregation normalizations.

    Returns ``(a_gcn, a_mean)``: ``D^-1/2 (A+I) D^-1/2`` (GCN sum
    aggregation) and ``D^-1 (A+I)`` (mean aggregation).  Self loops are
    forced so every degree is >= 1.
    """
    a = np.asarray(a, np.float32).copy()
    np.fill_diagonal(a, 1.0)
    deg = a.sum(1)
    a_gcn = a / np.sqrt(np.outer(deg, deg))
    a_mean = a / deg[:, None]
    return a_gcn, a_mean


@dataclasses.dataclass
class DenseGraph:
    """Materialized small graph for real-numerics runs."""

    spec: GraphSpec
    a: np.ndarray           # binary adjacency + self loops
    a_gcn: np.ndarray       # D^-1/2 (A+I) D^-1/2
    a_mean: np.ndarray      # D^-1 (A+I)
    h0: np.ndarray          # sparse features
    labels: np.ndarray


def materialize(name: str, *, scale: float = 1.0, seed: int = 0,
                max_vertices: int = 4096) -> DenseGraph:
    """Small dense instance of a Table VI graph (scaled to fit memory).

    Keeps densities and the power-law/locality structure; scales |V| and
    |E| by ``scale`` (and caps |V|).  Feature width is scaled too so CI's
    3703-wide features do not dominate test runtime.
    """
    spec = TABLE_VI[name]
    v = min(int(spec.n_vertices * scale), max_vertices)
    e = max(int(spec.n_edges * (v / spec.n_vertices) ** 2), v)
    f = min(spec.f_in, max(32, int(spec.f_in * scale)))
    rng = np.random.default_rng(_name_seed(name, seed))
    # power-law degree-weighted edge sampling with locality
    w = _powerlaw_marginal(v, rng)
    src = rng.choice(v, size=e, p=w)
    off = np.round(rng.standard_cauchy(e) * max(v // 64, 1)).astype(np.int64)
    dst = np.clip(src + off, 0, v - 1)
    mix = rng.random(e) < 0.5
    dst = np.where(mix, rng.choice(v, size=e, p=w), dst)
    a = np.zeros((v, v), np.float32)
    a[src, dst] = 1.0
    a[dst, src] = 1.0
    np.fill_diagonal(a, 1.0)
    a_gcn, a_mean = normalize_adjacency(a)
    col_skew = np.clip(
        spec.density_h0 * _cold_column_skew(f, rng, spec.density_h0), 0, 1)
    mask = rng.random((v, f)) < col_skew[None, :]
    h0 = (rng.normal(size=(v, f)).astype(np.float32) ** 2) * mask  # >=0 like
    labels = rng.integers(0, spec.n_classes, size=(v,))
    out_spec = GraphSpec(spec.name, v, int(a.sum()), f, spec.n_classes,
                         float(a.mean()), float((h0 != 0).mean()), spec.hidden)
    return DenseGraph(out_spec, a, a_gcn, a_mean, h0, labels)


def prune_weights(w: np.ndarray, density: float,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Magnitude pruning to a target density (paper Section VIII-B)."""
    if density >= 1.0:
        return w
    k = int(np.round(w.size * density))
    if k == 0:
        return np.zeros_like(w)
    thresh = np.partition(np.abs(w).ravel(), w.size - k)[w.size - k]
    return np.where(np.abs(w) >= thresh, w, 0.0)
