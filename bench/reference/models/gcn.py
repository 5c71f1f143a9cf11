"""GCN (Kipf & Welling, arXiv:1609.02907): ``H_l = act(A (H_{l-1} W_l))``
with A = D^-1/2 (A+I) D^-1/2, D the degrees of A + I, ReLU between the
layers and none after the last, as PyG's ``GCNConv`` (transform, then
propagate).  No bias: the program has none."""
import numpy as np
import torch

from bench.reference import work


def normalize(rows: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """A's values at the support (rows, cols) of A + I, float32 from
    float64."""
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    return (1.0 / np.sqrt(deg[rows] * deg[cols])).astype(np.float32)


def weight_shapes(dims):
    """The weights for layer widths ``dims``, in the order they are drawn."""
    return {f"W{l}": (dims[l - 1], dims[l]) for l in range(1, len(dims))}


def forward(adj, x, weights, mm):
    """Every layer's output; ``mm`` is the reference's product."""
    n_layers = len(weights)
    hs, h = [], x
    for l in range(1, n_layers + 1):
        z = mm(adj, mm(h, weights[f"W{l}"]))
        h = torch.relu(z) if l < n_layers else z
        hs.append(h)
    return hs


def needed_macs(adj, adj_colnnz, x, weights, hs) -> int:
    """Multiply-adds with both operands nonzero, each layer in its cheaper
    association (``work.aggregate_macs``)."""
    total, h = 0, x
    for l in range(1, len(hs) + 1):
        total += work.aggregate_macs(adj_colnnz, adj, h, weights[f"W{l}"])
        h = hs[l - 1]
    return total
