"""Plain oracles (port of ``repro.kernels.ref``): the block primitives'
``ref_matmul``, the profiler's ``ref_tile_nnz`` and ``ref_attention``."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ref_matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """GEMM, SpDMM and SPMM differ only in which zeros they skip, never in
    the value they compute: float32 ``x @ y`` in the promoted dtype."""
    out = torch.matmul(x.float(), y.float())
    return out.to(torch.promote_types(x.dtype, y.dtype))


def ref_tile_nnz(x: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    """Per-tile nonzero counts: (..., M, N) -> (..., Mb, Nb) int32, each
    matrix of a stack counted alone (pads with zeros, which add no
    count)."""
    m, n = x.shape[-2:]
    tm, tn = tile
    pm, pn = (-m) % tm, (-n) % tn
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    mb, nb = x.shape[-2] // tm, x.shape[-1] // tn
    nz = (x != 0).reshape(*x.shape[:-2], mb, tm, nb, tn)
    return nz.sum(dim=(-3, -1), dtype=torch.int32)


def ref_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = False,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention oracle.  q, k, v: (B, H, S, D) (kv may differ in
    S); causal queries are the LAST sq positions of the kv sequence."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        qpos = torch.arange(sq, device=s.device)[:, None] + (sk - sq)
        kpos = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
