"""Masked edge-softmax: the attention matrix of one GAT head.

Port of the jnp body of ``repro.core.dynasparse.attention_adjacency``
(``src/repro/core/dynasparse.py:311``, lines 353-373; the reference has no
Pallas kernel for it).  For the (n, n) adjacency ``a`` (only its support
``a != 0`` matters), the head's (n, f) features ``z`` and its (f, 1)
attention vectors::

    score[i, j] = LeakyReLU(att_src . z[i] + att_dst . z[j], slope)
    alpha[i]    = softmax of score[i] over row i's support, 0 elsewhere
    out         = alpha where alpha > threshold, else exactly 0

A row with no support (bucket padding) is exactly zero.  The CUDA kernel
is ``csrc/edge_softmax.cu`` (one fmaf chain per projection, one warp per
row, three passes, no atomics, so the result is deterministic);
:func:`edge_softmax_plain` follows the reference's formula line for line.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

launches = 0


def edge_softmax_plain(a: torch.Tensor, z: torch.Tensor,
                       att_src: torch.Tensor, att_dst: torch.Tensor, *,
                       slope: float = 0.2, threshold: float = 0.0
                       ) -> torch.Tensor:
    """The reference's formula in torch ops, in float32; the result takes
    ``promote_types(a, z)``.  The projection is an elementwise product and
    a sum, so it does not depend on the TF32 setting."""
    n = a.shape[0]
    out_dtype = torch.promote_types(a.dtype, z.dtype)
    if n == 0:
        return torch.zeros((0, 0), dtype=out_dtype, device=a.device)
    support = a != 0
    att = torch.cat([att_src, att_dst], dim=1).float()          # (f, 2)
    s = (z.float()[:, :, None] * att[None]).sum(dim=1)          # (n, 2)
    scores = s[:, :1] + s[:, 1:2].T
    scores = torch.where(scores >= 0, scores, slope * scores)
    row_max = torch.where(support, scores, float("-inf")).amax(
        dim=1, keepdim=True)
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    ex = torch.where(support, torch.exp(scores - row_max), 0.0)
    denom = torch.clamp(ex.sum(dim=1, keepdim=True), min=1e-30)
    alpha = ex / denom
    return torch.where(alpha > threshold, alpha, 0.0).to(out_dtype)


def edge_softmax(a: torch.Tensor, z: torch.Tensor, att_src: torch.Tensor,
                 att_dst: torch.Tensor, *, slope: float = 0.2,
                 threshold: float = 0.0) -> torch.Tensor:
    """``alpha`` (n, n).  A CPU ``a`` takes the plain version; a CUDA one
    launches the kernel on contiguous float32 operands or raises."""
    if not a.is_cuda:
        return edge_softmax_plain(a, z, att_src, att_dst, slope=slope,
                                  threshold=threshold)
    global launches
    n, f = check_shapes(a, z, att_src, att_dst)
    for name, t in (("a", a), ("z", z), ("att_src", att_src),
                    ("att_dst", att_dst)):
        build.require(f"edge_softmax {name}", t, torch.float32)
    out = torch.empty((n, n), dtype=torch.float32, device=a.device)
    if n == 0:
        return out
    s = torch.empty(2 * n, dtype=torch.float32, device=a.device)
    fn = build.function(
        "edge_softmax", "rt_edge_softmax",
        [ctypes.c_void_p, ctypes.c_long] + [ctypes.c_void_p] * 5
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
           ctypes.c_void_p])
    build.check(fn(a.data_ptr(), a.stride(0), z.data_ptr(),
                   att_src.data_ptr(), att_dst.data_ptr(), s.data_ptr(),
                   out.data_ptr(), n, f, slope, threshold, build.stream(a)),
                "edge_softmax")
    launches += 1
    return out


def check_shapes(a, z, att_src, att_dst) -> Tuple[int, int]:
    """(n, f), or ``ValueError`` unless ``a`` is (n, n), ``z`` (n, f) and
    both attention vectors (f, 1)."""
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"edge_softmax: a must be square, got "
                         f"{tuple(a.shape)}")
    if z.dim() != 2 or z.shape[0] != a.shape[0]:
        raise ValueError(f"edge_softmax: z {tuple(z.shape)} must have a's "
                         f"{a.shape[0]} rows")
    f = z.shape[1]
    for name, t in (("att_src", att_src), ("att_dst", att_dst)):
        if tuple(t.shape) != (f, 1):
            raise ValueError(f"edge_softmax: {name} {tuple(t.shape)} must "
                             f"be ({f}, 1)")
    return a.shape[0], f


def support_flips(got: torch.Tensor, want: torch.Tensor, threshold: float
                  ) -> Tuple[int, float]:
    """Entries zero on one side and nonzero on the other: their count and
    the largest distance of the nonzero side's value from ``threshold``
    (0.0 when there is none).  A flip within a rounding step of the
    threshold comes from the order of a sum or the last ulp of ``exp``;
    one further out is a bug."""
    flip = (got != 0) != (want != 0)
    if not bool(flip.any()):
        return 0, 0.0
    kept = torch.where(got != 0, got, want)[flip].double()
    return int(flip.sum()), float((kept - threshold).abs().max())
