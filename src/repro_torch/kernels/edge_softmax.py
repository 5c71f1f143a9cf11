"""Masked edge-softmax: the attention matrix of one GAT head, with its
block counts.

Port of the jnp body of ``repro.core.dynasparse.attention_adjacency``
(``src/repro/core/dynasparse.py:311``, lines 353-375; the reference has no
Pallas kernel for it).  For the (n, n) adjacency ``a`` (only its support
``a != 0`` matters), the head's (n, f) features ``z`` and its (f, 1)
attention vectors::

    score[i, j] = LeakyReLU(att_src . z[i] + att_dst . z[j], slope)
    alpha[i]    = softmax of score[i] over row i's support, 0 elsewhere
    out         = alpha where alpha > threshold, else exactly 0
    counts      = out's nonzeros per ``out_block`` tile

``out`` takes ``promote_types(a, z)`` (the arithmetic is float32 and the
threshold compares before the cast; the counts are taken after it).  A
row with no support (bucket padding) is exactly zero.  The CUDA kernel is
``csrc/edge_softmax.cu``: one fmaf chain per projection, one warp per
row, ``a`` read once (its chunks with support listed in shared memory;
rows longer than :data:`LIST_COLS` read ``a`` again instead), the counts
fused into the pass that writes ``out``, no atomics in the arithmetic, so
the result is deterministic; :func:`edge_launch` gives its launch shape.
:func:`edge_softmax_plain` follows the reference's formula line for line,
then counts with ``profile.tile_nnz_plain``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.profile import tile_nnz_plain

launches = 0
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("list", "reread")
MAX_ROWS = 16            # rows of a CTA, one warp each (csrc MAX_WARPS)
LIST_COLS = 32768        # rows this long list their chunks with support in
                         # shared memory; longer rows re-read a
STAGE_COLS = 16384       # s_dst is staged in shared memory up to this
COUNT_TILES = 8192       # a tile row's counters live in shared memory up
                         # to this many tiles, else in the zeroed output


@dataclasses.dataclass(frozen=True)
class EdgeLaunch:
    """Launch shape of ``edge_softmax``: ``chunks`` CTAs a tile row, each
    of ``rows`` warps on ``rows`` rows of it; the ``route`` (an index into
    :data:`ROUTES`); whether ``s_dst`` and the counters sit in shared
    memory, and its bytes.  ``zero_counts``: the counts start from zero in
    device memory (several CTAs add to a tile row, or the counters do not
    fit)."""
    route: int
    rows: int
    chunks: int
    stage_dst: bool
    smem_counts: bool
    smem_bytes: int

    @property
    def zero_counts(self) -> bool:
        return not (self.smem_counts and self.chunks == 1)


@functools.lru_cache(maxsize=256)
def edge_launch(n: int, out_block: Tuple[int, int]) -> EdgeLaunch:
    """The kernel's shape for an (n, n) ``a`` counted at ``out_block``.
    No shape changes a value: a row's max and sum are one warp's, in
    column order, and pass 3's elements are independent."""
    bm, bn = out_block
    route = 0 if n <= LIST_COLS else 1
    rows = min(bm, MAX_ROWS)
    chunks = -(-bm // rows)
    nb = -(-n // bn)
    stage = n <= STAGE_COLS
    smem_counts = nb <= COUNT_TILES
    # a list entry (chunk, word) is 8 bytes, a row state 16
    lists = rows * (8 * -(-n // 32) + 16) if route == 0 else 0
    smem = lists + 4 * ((n if stage else 0) + (nb if smem_counts else 0))
    return EdgeLaunch(route, rows, chunks, stage, smem_counts, smem)


def edge_softmax_plain(a: torch.Tensor, z: torch.Tensor,
                       att_src: torch.Tensor, att_dst: torch.Tensor, *,
                       slope: float = 0.2, threshold: float = 0.0,
                       out_block: Tuple[int, int] = (128, 128)
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, counts)``: the reference's formula in torch ops, in float32,
    the result in ``promote_types(a, z)``, then its nonzero counts per
    ``out_block`` tile.  The projection is an elementwise product and a
    sum, so it does not depend on the TF32 setting."""
    n = a.shape[0]
    out_dtype = torch.promote_types(a.dtype, z.dtype)
    if n == 0:
        out = torch.zeros((0, 0), dtype=out_dtype, device=a.device)
        return out, tile_nnz_plain(out, tuple(out_block))
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
    out = torch.where(alpha > threshold, alpha, 0.0).to(out_dtype)
    return out, tile_nnz_plain(out, tuple(out_block))


def edge_softmax(a: torch.Tensor, z: torch.Tensor, att_src: torch.Tensor,
                 att_dst: torch.Tensor, *, slope: float = 0.2,
                 threshold: float = 0.0,
                 out_block: Tuple[int, int] = (128, 128)
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, counts)``: alpha (n, n) and its (ceil(n/bm), ceil(n/bn))
    int32 nonzero counts.  A CPU ``a`` takes the plain version; a CUDA one
    launches the kernel on contiguous float32 or bf16 ``a`` and ``z``
    (attention vectors float32 or bf16) or raises."""
    if not a.is_cuda:
        return edge_softmax_plain(a, z, att_src, att_dst, slope=slope,
                                  threshold=threshold, out_block=out_block)
    build.refuse_grad("edge_softmax", a, z, att_src, att_dst)
    global launches
    n, f = check_shapes(a, z, att_src, att_dst)
    bm, bn = out_block
    if bm <= 0 or bn <= 0:
        raise ValueError(f"edge_softmax: out_block {out_block} must be "
                         "positive")
    for name, t in (("a", a), ("z", z), ("att_src", att_src),
                    ("att_dst", att_dst)):
        if t.dtype not in DTYPES:
            raise ValueError(f"edge_softmax: {name} is {t.dtype}; the "
                             "kernel takes float32 or bfloat16")
        build.require(f"edge_softmax {name}", t, t.dtype)
    att_src, att_dst = att_src.float(), att_dst.float()
    out = torch.empty((n, n), dtype=torch.promote_types(a.dtype, z.dtype),
                      device=a.device)
    shape = edge_launch(n, (bm, bn))
    counts = (torch.zeros if shape.zero_counts else torch.empty)(
        (-(-n // bm), -(-n // bn)), dtype=torch.int32, device=a.device)
    if n == 0:
        return out, counts
    s = torch.empty(2 * n, dtype=torch.float32, device=a.device)
    fn = build.function(
        "edge_softmax", "rt_edge_softmax",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_void_p,
         ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    build.check(fn(a.data_ptr(), DTYPES[a.dtype], a.stride(0), z.data_ptr(),
                   DTYPES[z.dtype], att_src.data_ptr(), att_dst.data_ptr(),
                   s.data_ptr(), out.data_ptr(), counts.data_ptr(), n, f, bm,
                   bn, shape.route, shape.rows, shape.chunks,
                   int(shape.stage_dst), int(shape.smem_counts),
                   shape.smem_bytes, slope, threshold, build.stream(a)),
                "edge_softmax")
    launches += 1
    return out, counts


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
