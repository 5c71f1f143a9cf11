"""The input generator: determinism, the edge mix, the feature density."""
import numpy as np
import pytest
import torch

from bench.reference import gnn
from bench.traffic import generator


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 64 + 5])
def test_edge_list_is_a_function_of_the_seed(seed):
    a = generator.edge_list(2000, 9000, seed)
    b = generator.edge_list(2000, 9000, seed)
    c = generator.edge_list(2000, 9000, seed + 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) or not np.array_equal(a[1], c[1])


def test_edge_list_is_symmetric_with_every_self_loop():
    n = 3000
    rows, cols = generator.edge_list(n, 30000, 3)
    keys = set((rows * n + cols).tolist())
    assert all(v * n + v in keys for v in range(n))
    assert all(c * n + r in keys for r, c in zip(rows[:5000], cols[:5000]))
    assert np.all(np.diff(rows * n + cols) > 0)     # sorted, unique


@pytest.mark.parametrize("n,e", [(4096, 41300), (3000, 11476), (50, 1224)])
def test_the_edge_count_and_mean_degree_are_the_configured_ones(n, e):
    # Flickr's mean degree 10.08 and NELL's 3.83; the last fills the graph
    rows, cols = generator.edge_list(n, e, 5)
    assert int((rows != cols).sum()) == e - e % 2


def test_too_many_edges_raise():
    with pytest.raises(ValueError):
        generator.edge_list(10, 92, 0)


@pytest.mark.parametrize("density", [0.464, 0.01])
def test_feature_density_and_determinism(density):
    n, f = 512, 400
    p = generator.column_probabilities(f, density, 9)
    snaps = generator.feature_snapshots(n, p, 3, 9, "cpu", chunk_elems=50000)
    again = generator.feature_snapshots(n, p, 3, 9, "cpu", chunk_elems=50000)
    for (i1, v1), (i2, v2) in zip(snaps, again):
        assert torch.equal(i1, i2) and torch.equal(v1, v2)
    assert not torch.equal(snaps[0][0], snaps[1][0])
    for idx, vals in snaps:
        assert torch.all(vals >= 0)
        assert idx.unique().numel() == idx.numel()
        got = idx.numel() / (n * f)
        assert abs(got - p.mean()) < 4 * np.sqrt(p.mean() / (n * f)) + 1e-4
    assert abs(p.mean() - density) < density * 0.5


def test_snapshot_rewrite_gives_each_snapshot_exactly():
    n, f = 64, 50
    p = generator.column_probabilities(f, 0.3, 1)
    snaps = generator.feature_snapshots(n, p, 3, 1, "cpu")
    buf = torch.zeros((n, f))
    prev = None
    for s in (0, 1, 2, 0):
        generator.write_snapshot(buf, prev, snaps[s])
        want = torch.zeros(n * f)
        want[snaps[s][0]] = snaps[s][1]
        assert torch.equal(buf.view(-1), want)
        prev = snaps[s]


def test_adjacency_normalizations():
    n = 300
    rows, cols = generator.edge_list(n, 1500, 2)
    a_sym = generator.dense_adjacency(
        rows, cols, gnn.model("gcn").normalize(rows, cols, n), n,
        "cpu").double()
    a_mean = generator.dense_adjacency(
        rows, cols, gnn.model("sage").normalize(rows, cols, n), n,
        "cpu").double()
    binary = (a_sym != 0).double()
    deg = binary.sum(1)
    assert torch.all(torch.diagonal(binary) == 1)
    assert torch.allclose(a_sym, binary / torch.sqrt(deg[:, None] * deg),
                          rtol=1e-6)
    assert torch.allclose(a_mean.sum(1), torch.ones(n, dtype=torch.float64),
                          rtol=1e-6)


def test_glorot_weights():
    shapes = {"W1": (300, 32), "W2": (32, 7)}
    w = generator.glorot_weights(shapes, 4, "cpu")
    w2 = generator.glorot_weights(shapes, 4, "cpu")
    for name, (fi, fo) in shapes.items():
        assert w[name].shape == (fi, fo) and w[name].is_contiguous()
        assert torch.equal(w[name], w2[name])
        assert w[name].abs().max() <= np.sqrt(6.0 / (fi + fo))
