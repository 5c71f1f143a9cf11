"""The work one inference needs, from its inputs alone: the yardstick of
``kernels_roofline`` and ``mfu``.  Whatever implements the model, these
numbers read the same.

* Operations: 2 x the multiply-adds whose two operands are both nonzero,
  over the snapshot's features, the adjacency, the weights and the ReLU'd
  intermediates as the reference computes them.  A product P Q needs
  sum_k colnnz(P)[k] * rownnz(Q)[k] of them.  Each aggregation layer is
  taken in its cheaper association, A (H W) or (A H) W, so that a program
  that reorders is not penalised.  The nonzeros of A H are counted on the
  patterns (``pattern_colnnz``): A and H are nonnegative here (squared
  normal features, ReLU'd intermediates), so no sum cancels.
* Bytes: the feature matrix as handed (dense) read once, the adjacency's
  nonzero values, the weights, and the output written once, 4 bytes each.
  Features that stay resident across inferences, as the adjacency does,
  count their nonzero values alone (``x_resident``).
* Bound: max(operations / peak FLOP/s, bytes / peak bytes/s), the
  published peaks in ``peaks.json``, the FLOP/s of the work's own
  ``precision`` (``RATES``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import torch

from .gnn import model, precision_of

PEAKS = Path(__file__).resolve().parent / "peaks.json"
# the key of ``peaks.json`` that holds the FLOP/s of each precision
RATES = {"float32": "fp32_flops", "bfloat16": "bf16_flops"}


def peaks(device_name: str) -> dict:
    """The published peaks of the card whose name ``device_name`` holds."""
    table = json.loads(PEAKS.read_text())
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no published peaks for {device_name!r} in {PEAKS}")


def rate(work: Dict[str, object], peak: dict) -> float:
    """The published FLOP/s of ``work``'s precision; an unknown precision
    raises."""
    precision = work["precision"]
    if precision not in RATES:
        raise LookupError(f"no published rate for precision {precision!r};"
                          f" known: {sorted(RATES)}")
    return peak[RATES[precision]]


def colnnz(x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
    """Nonzeros of each column, int64, counted in blocks of ``rows``."""
    out = torch.zeros(x.shape[1], dtype=torch.int64, device=x.device)
    for r0 in range(0, x.shape[0], rows):
        out += (x[r0:r0 + rows] != 0).sum(0)
    return out


def rownnz(x: torch.Tensor) -> torch.Tensor:
    return (x != 0).sum(1)


def macs(p_colnnz: torch.Tensor, q_rownnz: torch.Tensor) -> int:
    """Multiply-adds of P Q with both operands nonzero."""
    return int((p_colnnz.long() * q_rownnz.long()).sum())


def pattern_colnnz(p: torch.Tensor, q: torch.Tensor,
                   rows: int = 4096) -> torch.Tensor:
    """Nonzeros of each column of pattern(P) @ pattern(Q), the patterns in
    bfloat16 (0 or 1; sums accumulate in float32 and any positive sum
    stays positive), in blocks of ``rows`` rows of P."""
    qb = (q != 0).to(torch.bfloat16)
    out = torch.zeros(q.shape[1], dtype=torch.int64, device=q.device)
    for r0 in range(0, p.shape[0], rows):
        pb = (p[r0:r0 + rows] != 0).to(torch.bfloat16)
        out += ((pb @ qb) > 0).sum(0)
    return out


def aggregate_macs(adj_colnnz: torch.Tensor, adj: torch.Tensor,
                   h: torch.Tensor, w: torch.Tensor) -> int:
    """Multiply-adds of A H W in its cheaper association.  (A H) W is
    counted only when its lower bound, which takes colnnz(A H) >=
    colnnz(H) (A holds every self loop), is below A (H W)."""
    t = h @ w
    first_hw = macs(colnnz(h), rownnz(w)) + macs(adj_colnnz, rownnz(t))
    ah = macs(adj_colnnz, rownnz(h))
    if ah + macs(colnnz(h), rownnz(w)) >= first_hw:
        return first_hw
    return min(first_hw, ah + macs(pattern_colnnz(adj, h), rownnz(w)))


@torch.no_grad()
def inference_work(name: str, adj: torch.Tensor, adj_colnnz: torch.Tensor,
                   x: torch.Tensor, weights: Dict[str, torch.Tensor],
                   hs: List[torch.Tensor], *, x_resident: bool = False
                   ) -> Dict[str, float]:
    """``{"flops", "bytes"}`` one inference of model ``name`` needs on these
    inputs; the model counts its multiply-adds (``needed_macs``), ``hs``
    are the reference's layer outputs (``gnn.forward``) and
    ``adj_colnnz`` is ``colnnz(adj)``; ``x_resident``: the features stay
    resident, so only their nonzero values count."""
    with precision_of("float32", x.device):
        total = model(name).needed_macs(adj, adj_colnnz, x, weights, hs)
    x_elems = int(colnnz(x).sum()) if x_resident else x.numel()
    nbytes = 4 * (x_elems + int(adj_colnnz.sum())
                  + sum(w.numel() for w in weights.values())
                  + hs[-1].numel())
    return {"flops": 2.0 * total, "bytes": float(nbytes)}


def bound_seconds(work: Dict[str, object], peak: dict) -> float:
    """The least time the card could take: max(operations / the peak of
    the work's precision, bytes / HBM peak)."""
    return max(work["flops"] / rate(work, peak),
               work["bytes"] / peak["hbm_bytes_per_s"])

