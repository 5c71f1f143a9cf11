"""The masked ``dispatch`` VJP on bf16 grids, as one Hopper kernel per product.

The forward ``x @ w`` walks the planner's (I, J, K) code grid at ``block =
(bm, bk, bn)`` (``kernels/dispatch.py``).  The reference's gradient of that
walk (``jax.grad`` through the ``lax.switch`` of
``src/repro/core/dynasparse.py:239``, whose SKIP branch returns ``acc``)
is masked per block step:

* ``dx = g @ w.T`` (the ``nt`` layout): dx[i, k] sums g[i, j] @ w[k, j].T
  over the j with ``codes[i, j, k] != SKIP``;
* ``dw = x.T @ g`` (the ``tn`` layout): dw[k, j] sums x[i, k].T @ g[i, j]
  over the i with ``codes[i, j, k] != SKIP``.

An output block with no active step is exactly 0, and each result is
rounded once from its float32 sum to the operands' type.

On CUDA, ``csrc/dispatch_bwd.cu`` computes both from the forward's operands
and code grid as they are: no transposed copy, no permuted grid.  Its CTAs
walk ``tile_m x tile_n`` output tiles, each inside one output block
(:func:`bwd_launch` picks them), loading that block's active contraction
blocks (:func:`tile_walk` lists them) in 64-deep stages.  The kernel takes
bf16 operands with every block edge in :data:`EDGES`; the plain versions
take any type and edge.  :func:`takes` is the route rule of
``core/dynasparse.BlockMatmulFn``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

launches = 0
EDGES = (64, 128, 256)      # block edges the kernel takes
LAYOUTS = ("nt", "tn")
GROUP = 8                   # tile rows of a group in the tiles' order
                            # (8 x 16 of a 16 x 32 grid in flight at once)
# rt_dispatch_bwd's arguments: layout; a and b (pointer, rows, columns,
# row stride); codes, queue, out, out_f32; rows, cols; tile_m, tile_n,
# row_tiles, col_tiles, ctas, group, row_edge, col_edge, depth, steps;
# rs, cs, ts; stream
C_ARGS = ([ctypes.c_int]
          + [ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_long] * 2
          + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_long] * 2
          + [ctypes.c_int] * 10 + [ctypes.c_long] * 3 + [ctypes.c_void_p])


def takes(dtype: torch.dtype, block: Tuple[int, int, int]) -> bool:
    """Whether the backward of a ``dtype`` forward at ``block`` runs on
    this module (bf16 with every edge in :data:`EDGES`); anything else
    keeps the two ``dispatch`` launches over the permuted grids."""
    return dtype == torch.bfloat16 and all(b in EDGES for b in block)


@dataclasses.dataclass(frozen=True)
class BwdLaunch:
    """Launch shape of one product: ``row_tiles`` x ``col_tiles`` tiles
    of ``tile_m`` x ``tile_n`` outputs, shared by ``ctas`` persistent CTAs
    (CTA b starts with tile b and takes the next one from a queue in
    :meth:`tile_rc`'s order when it has issued its loads, so tiles that
    SKIP most of their steps go faster); output blocks of ``row_edge`` x
    ``col_edge``; ``steps`` contraction blocks of ``depth``.  The code of
    contraction block t of output block (r, c) is ``codes.flatten()[r *
    rs + c * cs + t * ts]``."""
    layout: str
    tile_m: int
    tile_n: int
    row_tiles: int
    col_tiles: int
    ctas: int
    group: int
    row_edge: int
    col_edge: int
    depth: int
    steps: int
    rs: int
    cs: int
    ts: int

    def tile_rc(self, tile: int) -> Tuple[int, int]:
        """The (row, column) tile of tile index ``tile``: groups of
        ``group`` tile rows, column-major inside a group, so that the
        tiles in flight at once share operand rows and columns in L2 (the
        kernel takes them in this order)."""
        per_group = self.group * self.col_tiles
        first = tile // per_group * self.group
        rows = min(self.row_tiles - first, self.group)
        return first + tile % per_group % rows, tile % per_group // rows

    def tile_block(self, tile: int) -> Tuple[int, int]:
        """The output block (r, c) that tile index ``tile`` lies in."""
        tr, tc = self.tile_rc(tile)
        return (tr * self.tile_m // self.row_edge,
                tc * self.tile_n // self.col_edge)


@functools.lru_cache(maxsize=1024)
def bwd_launch(layout: str, rows: int, cols: int,
               grid: Tuple[int, int, int],
               block: Tuple[int, int, int],
               sms: int = build.H100_SMS) -> BwdLaunch:
    """The launch shape of the ``layout`` product with a ``rows`` x
    ``cols`` output, for the forward's code grid shape ``grid`` = (I, J,
    K) at ``block`` = (bm, bk, bn), on a card of ``sms`` SMs.

    A tile never crosses an output block: 128 x 256 where the block's rows
    are at least 128 and its columns 256 (two consumer warpgroups, one 64
    x 256 wgmma each), else 64 rows and min(columns, 128).  One CTA per
    SM at most (its ring takes most of the shared memory), as few as give
    each the same number of tiles when all cost the same (512 tiles on
    132 SMs: 128 CTAs)."""
    bm, bk, bn = block
    I, J, K = grid
    if layout == "nt":     # dx (m, kd): blocks (bm, bk), contraction bn
        row_edge, col_edge, depth, steps = bm, bk, bn, J
        rs, cs, ts = J * K, 1, K
    elif layout == "tn":   # dw (kd, n): blocks (bk, bn), contraction bm
        row_edge, col_edge, depth, steps = bk, bn, bm, I
        rs, cs, ts = 1, K, J * K
    else:
        raise ValueError(f"layout {layout!r} not in {LAYOUTS}")
    if row_edge >= 128 and col_edge == 256:
        tile_m, tile_n = 128, 256
    else:
        tile_m, tile_n = 64, min(col_edge, 128)
    row_tiles, col_tiles = -(-rows // tile_m), -(-cols // tile_n)
    tiles = max(1, row_tiles * col_tiles)
    ctas = -(-tiles // -(-tiles // sms))
    return BwdLaunch(layout, tile_m, tile_n, row_tiles, col_tiles, ctas,
                     GROUP, row_edge, col_edge, depth, steps, rs, cs, ts)


def tile_walk(codes: torch.Tensor, launch: BwdLaunch) -> List[List[int]]:
    """The contraction blocks loaded for each tile index (blocks
    ascending, as the kernel walks them): those whose code is not SKIP."""
    flat = codes.detach().reshape(-1).cpu().tolist()
    walks = []
    for tile in range(launch.row_tiles * launch.col_tiles):
        r, c = launch.tile_block(tile)
        base = r * launch.rs + c * launch.cs
        walks.append([t for t in range(launch.steps)
                      if flat[base + t * launch.ts] != 0])
    return walks


def _check(name, a_rows, a_cols, b_rows, b_cols, codes, block, layout):
    bm, bk, bn = block
    I, J, K = codes.shape
    if layout == "nt":    # g (m, n) @ w (kd, n).T
        fits = (a_rows <= I * bm and a_cols <= J * bn and b_rows <= K * bk
                and b_cols == a_cols)
    else:                 # x (m, kd).T @ g (m, n)
        fits = (a_rows <= I * bm and a_cols <= K * bk and b_cols <= J * bn
                and b_rows == a_rows)
    if not fits:
        raise ValueError(f"{name}: {(a_rows, a_cols)} and "
                         f"{(b_rows, b_cols)} do not fit codes "
                         f"{tuple(codes.shape)} at {block}")


def _grid_steps(a: torch.Tensor, b: torch.Tensor, codes: torch.Tensor,
                run: torch.Tensor, out_shape, dtype) -> torch.Tensor:
    """acc[r, c] += a[r, t] @ b[t, c] for t in order where run[r, c, t]:
    ``a`` (R, T, rm, d), ``b`` (T, C, d, cn) float32 blocks, ``run`` (R, C,
    T) bool; the result cut to ``out_shape`` and cast to ``dtype``."""
    R, T = a.shape[:2]
    C = b.shape[1]
    acc = torch.zeros((R, C, a.shape[2], b.shape[3]), dtype=torch.float32,
                      device=codes.device)
    for t in range(T):
        step = torch.matmul(a[:, t, None], b[t][None])      # (R, C, rm, cn)
        acc = torch.where(run[:, :, t, None, None], acc + step, acc)
    full = acc.permute(0, 2, 1, 3).reshape(R * a.shape[2], C * b.shape[3])
    return full[:out_shape[0], :out_shape[1]].to(dtype)


def _blocks(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` in float32, zero-padded to ``rows`` x ``cols`` (whole
    blocks)."""
    t = t.float()
    return F.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def block_matmul_nt_plain(g: torch.Tensor, w: torch.Tensor,
                          codes: torch.Tensor, block: Tuple[int, int, int],
                          *, out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """dx = g @ w.T masked by the forward's ``codes`` at ``block``: per
    (bm, bk) block (i, k), the float32 block products g[i, j] @ w[k, j].T
    added in j order over the j whose code is not SKIP, then cast to
    ``out_dtype`` (default ``g``'s)."""
    bm, bk, bn = block
    I, J, K = codes.shape
    _check("block_matmul_nt", *g.shape, *w.shape, codes, block, "nt")
    a = _blocks(g, I * bm, J * bn).reshape(I, bm, J, bn).permute(0, 2, 1, 3)
    b = _blocks(w.T, J * bn, K * bk).reshape(J, bn, K, bk).permute(
        0, 2, 1, 3)
    run = (codes != 0).permute(0, 2, 1)                      # (I, K, J)
    return _grid_steps(a, b, codes, run, (g.shape[0], w.shape[0]),
                       out_dtype or g.dtype)


def block_matmul_tn_plain(x: torch.Tensor, g: torch.Tensor,
                          codes: torch.Tensor, block: Tuple[int, int, int],
                          *, out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """dw = x.T @ g masked by the forward's ``codes`` at ``block``: per
    (bk, bn) block (k, j), the float32 block products x[i, k].T @ g[i, j]
    added in i order over the i whose code is not SKIP, then cast to
    ``out_dtype`` (default ``x``'s)."""
    bm, bk, bn = block
    I, J, K = codes.shape
    _check("block_matmul_tn", *x.shape, *g.shape, codes, block, "tn")
    a = _blocks(x.T, K * bk, I * bm).reshape(K, bk, I, bm).permute(
        0, 2, 1, 3)
    b = _blocks(g, I * bm, J * bn).reshape(I, bm, J, bn).permute(0, 2, 1, 3)
    run = (codes != 0).permute(2, 1, 0)                      # (K, J, I)
    return _grid_steps(a, b, codes, run, (x.shape[1], g.shape[1]),
                       out_dtype or x.dtype)


def _require_tma(name: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` is a CUDA bf16 matrix the kernel's TMA loads can
    read in place: unit stride along rows, 16-byte aligned base and row
    stride."""
    if (not t.is_cuda or t.dtype != torch.bfloat16 or t.dim() != 2
            or t.stride(1) != 1 or (t.stride(0) * 2) % 16
            or t.data_ptr() % 16):
        raise ValueError(
            f"{name}: expected a CUDA bf16 matrix with unit column stride "
            f"and 16-byte aligned base and rows, got {t.dtype} on "
            f"{t.device}, strides {tuple(t.stride())}, data at "
            f"{t.data_ptr():#x}")


def _launch(layout, a, b, codes, block, out_dtype):
    global launches
    name = f"block_matmul_{layout}"
    build.refuse_grad(name, a, b)
    if any(e not in EDGES for e in block):
        raise ValueError(f"{name}: block {block} not supported by the "
                         f"kernel (every edge in {EDGES})")
    _require_tma(f"{name} {'g' if layout == 'nt' else 'x'}", a)
    _require_tma(f"{name} {'w' if layout == 'nt' else 'g'}", b)
    build.require(f"{name} codes", codes, torch.int32)
    _check(name, *a.shape, *b.shape, codes, block, layout)
    dtype = out_dtype or a.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: out_dtype {dtype} not bf16 or float32")
    rows, cols = ((a.shape[0], b.shape[0]) if layout == "nt"
                  else (a.shape[1], b.shape[1]))
    out = torch.empty((rows, cols), dtype=dtype, device=a.device)
    if out.numel() == 0:
        return out
    s = bwd_launch(layout, rows, cols, tuple(codes.shape), tuple(block),
                   build.sm_count(a.device))
    queue = torch.empty((1,), dtype=torch.int32, device=a.device)
    fn = build.function("dispatch_bwd", "rt_dispatch_bwd", C_ARGS)
    build.check(fn(LAYOUTS.index(layout),
                   a.data_ptr(), a.shape[0], a.shape[1], a.stride(0),
                   b.data_ptr(), b.shape[0], b.shape[1], b.stride(0),
                   codes.data_ptr(), queue.data_ptr(), out.data_ptr(),
                   int(dtype == torch.float32), rows, cols,
                   s.tile_m, s.tile_n, s.row_tiles, s.col_tiles, s.ctas,
                   s.group, s.row_edge, s.col_edge, s.depth, s.steps,
                   s.rs, s.cs, s.ts, build.stream(a)), "dispatch_bwd")
    launches += 1
    return out


def block_matmul_nt(g: torch.Tensor, w: torch.Tensor, codes: torch.Tensor,
                    block: Tuple[int, int, int], *,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dx = g @ w.T masked by the forward's ``codes`` at ``block`` (see
    :func:`block_matmul_nt_plain`), ``(g.shape[0], w.shape[0])`` in
    ``out_dtype`` (default ``g``'s).  On CUDA: the kernel, on bf16 ``g``
    (m, n) and ``w`` (kd, n) read in place, every edge of ``block`` in
    :data:`EDGES`; ``out_dtype`` float32 returns the float32 sums
    unrounded.  Anything else raises."""
    if not w.is_cuda:
        return block_matmul_nt_plain(g, w, codes, block, out_dtype=out_dtype)
    return _launch("nt", g, w, codes, block, out_dtype)


def block_matmul_tn(x: torch.Tensor, g: torch.Tensor, codes: torch.Tensor,
                    block: Tuple[int, int, int], *,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dw = x.T @ g masked by the forward's ``codes`` at ``block`` (see
    :func:`block_matmul_tn_plain`), ``(x.shape[1], g.shape[1])`` in
    ``out_dtype`` (default ``x``'s); on CUDA as :func:`block_matmul_nt`,
    with bf16 ``x`` (m, kd) and ``g`` (m, n) read in place."""
    if not g.is_cuda:
        return block_matmul_tn_plain(x, g, codes, block, out_dtype=out_dtype)
    return _launch("tn", x, g, codes, block, out_dtype)
