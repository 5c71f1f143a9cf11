"""GraphSAGE with the mean aggregator (Hamilton et al., arXiv:1706.02216):
``H_l = act((A_mean H_{l-1}) Wneigh_l + H_{l-1} Wself_l)`` with A_mean =
D^-1 (A+I), D the degrees of A + I, separate self and neighbour weights,
ReLU between the layers and none after the last, as PyG's ``SAGEConv``
(aggregate, then transform).  No bias: the program has none; A_mean counts
the vertex among its own neighbours, as the program is given it."""
import numpy as np
import torch

from bench.reference import work


def normalize(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """A_mean's values at the support (rows, cols) of A + I, float32 from
    float64."""
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    return (1.0 / deg[rows]).astype(np.float32)


def weight_shapes(dims):
    """The weights for layer widths ``dims``, in the order they are drawn."""
    out = {}
    for l in range(1, len(dims)):
        out[f"Wself{l}"] = (dims[l - 1], dims[l])
        out[f"Wneigh{l}"] = (dims[l - 1], dims[l])
    return out


def forward(adj, x, weights, mm):
    """Every layer's output; ``mm`` is the reference's product."""
    n_layers = len(weights) // 2
    hs, h = [], x
    for l in range(1, n_layers + 1):
        z = mm(mm(adj, h), weights[f"Wneigh{l}"]) + mm(h, weights[f"Wself{l}"])
        h = torch.relu(z) if l < n_layers else z
        hs.append(h)
    return hs


def needed_macs(adj, adj_colnnz, x, weights, hs) -> int:
    """Multiply-adds with both operands nonzero: the self Update, and the
    neighbour side in its cheaper association (``work.aggregate_macs``)."""
    total, h = 0, x
    for l in range(1, len(hs) + 1):
        total += work.macs(work.colnnz(h), work.rownnz(weights[f"Wself{l}"]))
        total += work.aggregate_macs(adj_colnnz, adj, h,
                                     weights[f"Wneigh{l}"])
        h = hs[l - 1]
    return total
