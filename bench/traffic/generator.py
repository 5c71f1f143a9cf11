"""The one generator of the benchmark's inputs: the graph, feature
snapshots and weights, each from a seed.  The traffic kinds
(``kinds/<kind>.py``) and the harness draw from it; a model's reference
gives the adjacency's normalized values (``normalize``).

The edge mix is a frozen numpy copy of ``repro_torch.data.graphs``
``materialize`` (``powerlaw_marginal``, Cauchy offsets around the source,
half the endpoints drawn again by weight) and of its ``_cold_column_skew``,
written as an edge list in the manner of ``repro_torch.data.sampling``
``powerlaw_host_graph``: no |V|^2 array is built on the host.  The dense
normalized adjacency, the feature snapshots and the weights are made on
the card (``device``), the features and weights with a ``torch.Generator``
there.  Copied, not imported, so that a later change to the program
cannot move the inputs.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# the stream of each input, mixed with ``--seed`` by ``sub_seed``
STREAMS = {"graph": 1, "columns": 2, "snapshots": 3, "weights": 4,
           "sample": 5}


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one input stream; any whole ``seed`` is taken."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def powerlaw_marginal(n: int, rng: np.random.Generator,
                      alpha: float = 1.6) -> np.ndarray:
    """Copy of ``repro_torch.data.graphs.powerlaw_marginal``: normalized
    power-law mass, heavy hubs shuffled among the vertices."""
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-alpha)
    rng.shuffle(w)
    return w / w.sum()


def cold_column_skew(n: int, rng: np.random.Generator,
                     density: float) -> np.ndarray:
    """Copy of ``repro_torch.data.graphs._cold_column_skew``: a lognormal
    hot/cold profile of the feature columns with mean 1, a share of the
    columns dead (all zero) that grows as the matrix gets colder."""
    skew = rng.lognormal(0.0, 1.0, size=(n,))
    dead_frac = float(np.clip(0.45 * (1.0 - density) ** 4, 0.0, 0.9))
    dead = rng.random(n) < dead_frac
    skew[dead] = 0.0
    mean = skew.mean()
    return skew / mean if mean > 0 else np.ones(n)


def _draw(rng: np.random.Generator, w: np.ndarray, n: int, count: int,
          spread: int, mix: float) -> Tuple[np.ndarray, np.ndarray]:
    """``count`` endpoint pairs as ``materialize`` draws them: sources by
    power-law weight, destinations at a Cauchy offset of scale ``n //
    spread`` around the source, and a share ``mix`` of the destinations
    drawn again by weight.  Offsets are clipped to +-n before the cast,
    which changes no pair (the sum is clipped to [0, n) after) and keeps a
    far draw from overflowing int64."""
    src = rng.choice(n, size=count, p=w)
    off = np.clip(np.round(rng.standard_cauchy(count)
                           * max(n // spread, 1)), -n, n).astype(np.int64)
    dst = np.clip(src + off, 0, n - 1)
    again = rng.random(count) < mix
    dst = np.where(again, rng.choice(n, size=count, p=w), dst)
    return src, dst


def edge_list(n: int, n_edges: int, seed: int, *, alpha: float = 1.6,
              spread: int = 64, mix: float = 0.5
              ) -> Tuple[np.ndarray, np.ndarray]:
    """The support of A + I: sorted unique (row, col) int64 pairs,
    symmetric, every self loop present, and ``n_edges`` (rounded down to
    even) nonzeros off the diagonal, as Table VI counts edges.

    Pairs are drawn by ``materialize``'s mix (``_draw``).  The mix piles
    its draws onto a few hubs, so one draw per edge leaves only about a
    fifth of them distinct; pairs are drawn in batches that double until
    ``n_edges / 2`` distinct undirected pairs exist, and the first that
    many in the order drawn are kept."""
    want = n_edges // 2
    if want > n * (n - 1) // 2:
        raise ValueError(f"{n_edges} edges do not fit {n} vertices")
    rng = np.random.default_rng(sub_seed(seed, "graph"))
    w = powerlaw_marginal(n, rng, alpha)
    keys = np.empty(0, np.int64)
    batch = max(want, 1)
    while True:
        src, dst = _draw(rng, w, n, batch, spread, mix)
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        keys = np.concatenate([keys, (lo * n + hi)[lo != hi]])
        uniq, first = np.unique(keys, return_index=True)
        if uniq.size >= want:
            break
        batch *= 2
    kept = uniq[np.argsort(first, kind="stable")[:want]]
    lo, hi = kept // n, kept % n
    loops = np.arange(n, dtype=np.int64)
    u = np.concatenate([lo, hi, loops])
    v = np.concatenate([hi, lo, loops])
    flat = np.unique(u * n + v)
    return flat // n, flat % n


def dense_adjacency(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    n: int, device) -> torch.Tensor:
    """The dense (n, n) float32 adjacency, built on ``device``."""
    a = torch.zeros((n, n), dtype=torch.float32, device=device)
    flat = torch.from_numpy(rows * n + cols).to(device)
    a.view(-1).index_copy_(0, flat, torch.from_numpy(vals).to(device))
    return a


def column_probabilities(f: int, density: float, seed: int) -> np.ndarray:
    """Each feature column's chance of a nonzero: ``density`` times the
    column's cold/hot skew, clipped to [0, 1] (``materialize``'s rule)."""
    rng = np.random.default_rng(sub_seed(seed, "columns"))
    return np.clip(density * cold_column_skew(f, rng, density), 0.0, 1.0)


def feature_snapshots(n: int, col_p: np.ndarray, count: int, seed: int,
                      device, chunk_elems: int = 1 << 27
                      ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``count`` feature snapshots of an (n, f) matrix as (flat int64
    indices, float32 values) on ``device``: each element nonzero with its
    column's probability, the value a squared normal (``materialize``'s
    ``h0``, nonnegative).  Drawn in row chunks of about ``chunk_elems``
    elements by one ``torch.Generator`` on ``device``."""
    f = int(col_p.shape[0])
    p = torch.from_numpy(col_p.astype(np.float32)).to(device)
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "snapshots"))
    rows = max(1, chunk_elems // f)
    out = []
    for _ in range(count):
        parts = []
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            u = torch.rand((r1 - r0, f), generator=g, device=device)
            parts.append((u < p).view(-1).nonzero().squeeze(1) + r0 * f)
            del u
        idx = torch.cat(parts)
        vals = torch.randn(idx.numel(), generator=g, device=device) ** 2
        out.append((idx, vals))
    return out


def write_snapshot(buf: torch.Tensor, prev, snap) -> None:
    """Rewrite the dense feature buffer in place from snapshot ``prev``
    (or all zeros, ``None``) to ``snap``."""
    flat = buf.view(-1)
    if prev is not None:
        flat.index_fill_(0, prev[0], 0.0)
    flat.index_copy_(0, snap[0], snap[1])


def glorot_weights(shapes: Dict[str, Tuple[int, int]], seed: int, device
                   ) -> Dict[str, torch.Tensor]:
    """Glorot-uniform float32 weights, unpruned, drawn in one call of a
    ``torch.Generator`` on ``device`` and cut in the order of ``shapes``,
    each into an allocation of its own."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, "weights"))
    total = sum(fi * fo for fi, fo in shapes.values())
    u = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, (fi, fo) in shapes.items():
        lim = float(np.sqrt(6.0 / (fi + fo)))
        w = (u[at:at + fi * fo] * 2.0 - 1.0) * lim
        out[name] = w.view(fi, fo).clone()
        at += fi * fo
    return out
