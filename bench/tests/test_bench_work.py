"""``reference/work.py`` against brute-force counts."""
import itertools

import pytest
import torch

from bench.reference import gnn, work


def sparse(m, n, density, g, nonneg=True):
    x = torch.rand((m, n), generator=g)
    x = torch.where(torch.rand((m, n), generator=g) < density, x, 0.0)
    return x if nonneg else x - 0.5 * (x != 0)


def brute_macs(p, q):
    """Multiply-adds of P Q with both operands nonzero, element by element."""
    m, k = p.shape
    n = q.shape[1]
    return sum(1 for i, kk, j in itertools.product(range(m), range(k),
                                                   range(n))
               if p[i, kk] != 0 and q[kk, j] != 0)


@pytest.mark.parametrize("shape,dp,dq", [((7, 9, 5), 0.3, 0.5),
                                         ((12, 6, 8), 0.1, 1.0),
                                         ((5, 11, 3), 0.0, 0.7)])
def test_macs_is_the_brute_force_count(shape, dp, dq):
    g = torch.Generator().manual_seed(sum(shape))
    m, k, n = shape
    p, q = sparse(m, k, dp, g), sparse(k, n, dq, g, nonneg=False)
    assert work.macs(work.colnnz(p, rows=3), work.rownnz(q)) \
        == brute_macs(p, q)


def test_pattern_colnnz_is_the_product_pattern():
    g = torch.Generator().manual_seed(1)
    p, q = sparse(40, 30, 0.08, g), sparse(30, 20, 0.1, g)
    want = ((p != 0).double() @ (q != 0).double() > 0).sum(0)
    assert torch.equal(work.pattern_colnnz(p, q, rows=7), want)


@pytest.mark.parametrize("dh,dw", [(0.02, 1.0), (0.6, 1.0), (0.3, 0.2)])
def test_aggregate_macs_takes_the_cheaper_association(dh, dw):
    g = torch.Generator().manual_seed(int(dh * 100 + dw * 10))
    n, f, o = 24, 18, 6
    adj = sparse(n, n, 0.15, g) + torch.eye(n)
    h, w = sparse(n, f, dh, g), sparse(f, o, dw, g, nonneg=False)
    hw_first = brute_macs(h, w) + brute_macs(adj, h @ w)
    ah_first = brute_macs(adj, h) + brute_macs(adj @ h, w)
    got = work.aggregate_macs(work.colnnz(adj), adj, h, w)
    assert got == min(hw_first, ah_first)


@pytest.mark.parametrize("model", gnn.MODELS)
def test_inference_work_adds_the_layers(model):
    g = torch.Generator().manual_seed(3)
    n, dims = 20, [15, 8, 4]
    adj = sparse(n, n, 0.2, g) + torch.eye(n)
    x = sparse(n, dims[0], 0.2, g)
    weights = {k: sparse(*s, 1.0, g, nonneg=False)
               for k, s in gnn.weight_shapes(model, dims).items()}
    hs = gnn.forward(model, adj, x, weights)
    got = work.inference_work(model, adj, work.colnnz(adj), x, weights, hs)
    want, h = 0, x
    for l in (1, 2):
        wn = weights[f"W{l}" if model == "gcn" else f"Wneigh{l}"]
        want += min(brute_macs(h, wn) + brute_macs(adj, h @ wn),
                    brute_macs(adj, h) + brute_macs(adj @ h, wn))
        if model == "sage":
            want += brute_macs(h, weights[f"Wself{l}"])
        h = hs[l - 1]
    assert got["flops"] == 2 * want
    nw = sum(w.numel() for w in weights.values())
    assert got["bytes"] == 4 * (x.numel() + int((adj != 0).sum()) + nw
                                + n * dims[-1])


def test_bound_takes_the_larger_side():
    peak = {"fp32_flops": 1e12, "bf16_flops": 4e12, "hbm_bytes_per_s": 1e11}
    f32 = {"flops": 2e9, "bytes": 1e8, "precision": "float32"}
    assert work.bound_seconds(f32, peak) == 2e-3
    assert work.bound_seconds({"flops": 1e6, "bytes": 5e8,
                               "precision": "float32"}, peak) == 5e-3
    # the same operations at the bf16 rate: a quarter of the time
    assert work.bound_seconds({**f32, "precision": "bfloat16"},
                              peak) == 1e-3
    h100 = work.peaks("NVIDIA H100 80GB HBM3")
    assert h100["fp32_flops"] == 67e12 and h100["bf16_flops"] == 989e12


@pytest.mark.parametrize("bad", [{"flops": 1.0, "bytes": 1.0},
                                 {"flops": 1.0, "bytes": 1.0,
                                  "precision": "float8"}],
                         ids=["no precision", "unknown precision"])
def test_work_of_no_known_precision_is_refused(bad):
    with pytest.raises(LookupError):
        work.bound_seconds(bad, work.peaks("NVIDIA H100 80GB HBM3"))


def test_resident_features_count_their_nonzeros():
    """Features that stay resident are read by their nonzero values, as
    the adjacency is; the operations do not change."""
    g = torch.Generator().manual_seed(5)
    n, dims = 20, [15, 8, 4]
    adj = sparse(n, n, 0.2, g) + torch.eye(n)
    x = sparse(n, dims[0], 0.1, g)
    weights = {k: sparse(*s, 1.0, g, nonneg=False)
               for k, s in gnn.weight_shapes("gcn", dims).items()}
    hs = gnn.forward("gcn", adj, x, weights)
    fresh = work.inference_work("gcn", adj, work.colnnz(adj), x, weights, hs)
    kept = work.inference_work("gcn", adj, work.colnnz(adj), x, weights, hs,
                               x_resident=True)
    assert kept["flops"] == fresh["flops"]
    assert fresh["bytes"] - kept["bytes"] == 4 * (x.numel()
                                                  - int((x != 0).sum()))
