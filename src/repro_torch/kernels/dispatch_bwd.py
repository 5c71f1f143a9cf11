"""The masked ``dispatch`` VJP on bf16 and float32 grids, as one Hopper
kernel per product.

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

On CUDA, both products are computed from the forward's operands and code
grid as they are: no transposed copy, no permuted grid.  The route
follows the operands' type:

* bf16: ``csrc/dispatch_bwd.cu``, on the tensor cores (``wgmma`` fed by
  TMA).  Its CTAs walk ``tile_m x tile_n`` output tiles, each inside one
  output block (:func:`bwd_launch` picks them), loading that block's
  active contraction blocks (:func:`tile_walk` lists them) in 64-deep
  stages;
* float32: ``csrc/dispatch_bwd_f32.cu``, on the FP32 FMA units with 8 x 8
  register microtiles fed by ``cp.async`` (:func:`bwd_launch_f32` picks
  its tiles, 128 x 128 at most).  Its sums round as the two ``dispatch``
  launches over the permuted grids did, bit for bit: a fresh partial per
  active contraction block, one ``fmaf`` chain in ascending order, then
  ``acc += partial``.  The same kernel, in a third layout (``nn``), is
  the float32 training forward, ``dispatch.block_matmul_nn``, counted
  under ``dispatch``.

The kernels take every block edge in :data:`EDGES`; the plain versions
take any type and edge.  :func:`takes` is the route rule of
``core/dynasparse.BlockMatmulFn``, for the backward and (float32) the
forward.
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
EDGES = (64, 128, 256)      # block edges the kernels take
LAYOUTS = ("nt", "tn")      # the backward's products
F32_LAYOUTS = LAYOUTS + ("nn",)   # the float32 kernel's (nn: the forward)
DTYPES = (torch.bfloat16, torch.float32)   # the kernels' operand types
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
# rt_dispatch_bwd_f32's: the same without out_f32 (its sums are float32)
C_ARGS_F32 = C_ARGS[:12] + C_ARGS[13:]


def takes(dtype: torch.dtype, block: Tuple[int, int, int]) -> bool:
    """Whether the backward of a ``dtype`` forward at ``block`` runs on
    this module (bf16 or float32 with every edge in :data:`EDGES`);
    anything else keeps the two ``dispatch`` launches over the permuted
    grids.  A float32 forward that this holds for runs on the same
    float32 kernel (``dispatch.block_matmul_nn``)."""
    return dtype in DTYPES and all(b in EDGES for b in block)


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
    row_edge, col_edge = _walk(layout, grid, block)[:2]
    if row_edge >= 128 and col_edge == 256:
        tile_m, tile_n = 128, 256
    else:
        tile_m, tile_n = 64, min(col_edge, 128)
    return _tiled(layout, rows, cols, grid, block, tile_m, tile_n, sms)


@functools.lru_cache(maxsize=1024)
def bwd_launch_f32(layout: str, rows: int, cols: int,
                   grid: Tuple[int, int, int],
                   block: Tuple[int, int, int],
                   sms: int = build.H100_SMS) -> BwdLaunch:
    """The launch shape of the float32 kernel (``csrc/dispatch_bwd_f32.cu``)
    for the ``layout`` product (one of :data:`F32_LAYOUTS`; ``nn`` is the
    forward) with a ``rows`` x ``cols`` output, as
    :func:`bwd_launch`: tiles of min(128, edge) along each output edge, so
    a tile never crosses an output block (256 threads of 8 x 8 outputs at
    128 x 128); one CTA per SM at most (its accumulators and partials take
    most of the registers), as few as give each the same number of tiles
    when all cost the same."""
    row_edge, col_edge = _walk(layout, grid, block)[:2]
    return _tiled(layout, rows, cols, grid, block, min(128, row_edge),
                  min(128, col_edge), sms)


def _walk(layout: str, grid: Tuple[int, int, int],
          block: Tuple[int, int, int]) -> Tuple[int, ...]:
    """(row_edge, col_edge, depth, steps, rs, cs, ts) of the ``layout``
    product over the forward's grid (see :class:`BwdLaunch`)."""
    bm, bk, bn = block
    I, J, K = grid
    if layout == "nt":     # dx (m, kd): blocks (bm, bk), contraction bn
        return bm, bk, bn, J, J * K, 1, K
    if layout == "tn":     # dw (kd, n): blocks (bk, bn), contraction bm
        return bk, bn, bm, I, 1, K, J * K
    if layout == "nn":     # the forward (m, n): blocks (bm, bn), depth bk
        return bm, bn, bk, K, J * K, K, 1
    raise ValueError(f"layout {layout!r} not in {F32_LAYOUTS}")


def _tiled(layout, rows, cols, grid, block, tile_m, tile_n, sms):
    row_edge, col_edge, depth, steps, rs, cs, ts = _walk(layout, grid, block)
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
    elif layout == "nn":  # x (m, kd) @ y (kd, n)
        fits = (a_rows <= I * bm and a_cols <= K * bk and b_cols <= J * bn
                and b_rows == a_cols)
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


def _require_rows(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a CUDA ``dtype`` matrix the kernel's 16-byte
    loads (TMA for bf16, ``cp.async`` for float32) can read in place: unit
    stride along rows, 16-byte aligned base and row stride."""
    if (not t.is_cuda or t.dtype != dtype or t.dim() != 2
            or t.stride(1) != 1
            or (t.stride(0) * torch.finfo(dtype).bits // 8) % 16
            or t.data_ptr() % 16):
        kind = "bf16" if dtype == torch.bfloat16 else "float32"
        raise ValueError(
            f"{name}: expected a CUDA {kind} matrix with unit column stride "
            f"and 16-byte aligned base and rows, got {t.dtype} on "
            f"{t.device}, strides {tuple(t.stride())}, data at "
            f"{t.data_ptr():#x}")


OPERANDS = {"nt": ("g", "w"), "tn": ("x", "g"), "nn": ("x", "y")}


def launch_product(layout: str, a: torch.Tensor, b: torch.Tensor,
                   codes: torch.Tensor, block: Tuple[int, int, int],
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One ``layout`` product on the kernel of ``b``'s type (``a`` must
    match it; the forward, ``nn``, takes only float32), the checks first;
    nothing is counted here: the caller counts the launch when the result
    is not empty (``dispatch_bwd`` for ``nt`` and ``tn``, ``dispatch`` for
    ``nn``)."""
    name = f"block_matmul_{layout}"
    build.refuse_grad(name, a, b)
    if any(e not in EDGES for e in block):
        raise ValueError(f"{name}: block {block} not supported by the "
                         f"kernel (every edge in {EDGES})")
    f32 = layout == "nn" or b.dtype == torch.float32
    kind = torch.float32 if f32 else torch.bfloat16
    for label, t in zip(OPERANDS[layout], (a, b)):
        _require_rows(f"{name} {label}", t, kind)
    build.require(f"{name} codes", codes, torch.int32)
    _check(name, *a.shape, *b.shape, codes, block, layout)
    dtype = out_dtype or a.dtype
    if dtype not in ((torch.float32,) if f32
                     else (torch.bfloat16, torch.float32)):
        raise ValueError(f"{name}: out_dtype {dtype} not "
                         f"{'float32' if f32 else 'bf16 or float32'}")
    rows, cols = {"nt": (a.shape[0], b.shape[0]),
                  "tn": (a.shape[1], b.shape[1]),
                  "nn": (a.shape[0], b.shape[1])}[layout]
    out = torch.empty((rows, cols), dtype=dtype, device=a.device)
    if out.numel() == 0:
        return out
    s = (bwd_launch_f32 if f32 else bwd_launch)(
        layout, rows, cols, tuple(codes.shape), tuple(block),
        build.sm_count(a.device))
    queue = torch.empty((1,), dtype=torch.int32, device=a.device)
    operands = (F32_LAYOUTS.index(layout),
                a.data_ptr(), a.shape[0], a.shape[1], a.stride(0),
                b.data_ptr(), b.shape[0], b.shape[1], b.stride(0),
                codes.data_ptr(), queue.data_ptr(), out.data_ptr())
    shape = (rows, cols, s.tile_m, s.tile_n, s.row_tiles, s.col_tiles,
             s.ctas, s.group, s.row_edge, s.col_edge, s.depth, s.steps,
             s.rs, s.cs, s.ts, build.stream(a))
    if f32:
        fn = build.function("dispatch_bwd_f32", "rt_dispatch_bwd_f32",
                            C_ARGS_F32)
        build.check(fn(*operands, *shape),
                    "dispatch (float32, nn)" if layout == "nn"
                    else "dispatch_bwd (float32)")
    else:
        fn = build.function("dispatch_bwd", "rt_dispatch_bwd", C_ARGS)
        build.check(fn(*operands, int(dtype == torch.float32), *shape),
                    "dispatch_bwd")
    return out


def _launch(layout, a, b, codes, block, out_dtype):
    """One backward product, counted under ``dispatch_bwd``."""
    global launches
    out = launch_product(layout, a, b, codes, block, out_dtype)
    if out.numel():
        launches += 1
    return out


def block_matmul_nt(g: torch.Tensor, w: torch.Tensor, codes: torch.Tensor,
                    block: Tuple[int, int, int], *,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dx = g @ w.T masked by the forward's ``codes`` at ``block`` (see
    :func:`block_matmul_nt_plain`), ``(g.shape[0], w.shape[0])`` in
    ``out_dtype`` (default ``g``'s).  On CUDA: the kernel of ``w``'s type,
    on bf16 or float32 ``g`` (m, n) and ``w`` (kd, n) of that type read in
    place, every edge of ``block`` in :data:`EDGES`; bf16 with
    ``out_dtype`` float32 returns the float32 sums unrounded, float32
    takes only float32.  Anything else raises."""
    if not w.is_cuda:
        return block_matmul_nt_plain(g, w, codes, block, out_dtype=out_dtype)
    return _launch("nt", g, w, codes, block, out_dtype)


def block_matmul_tn(x: torch.Tensor, g: torch.Tensor, codes: torch.Tensor,
                    block: Tuple[int, int, int], *,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dw = x.T @ g masked by the forward's ``codes`` at ``block`` (see
    :func:`block_matmul_tn_plain`), ``(x.shape[1], g.shape[1])`` in
    ``out_dtype`` (default ``x``'s); on CUDA as :func:`block_matmul_nt`,
    with ``x`` (m, kd) and ``g`` (m, n) of ``g``'s type read in place."""
    if not g.is_cuda:
        return block_matmul_tn_plain(x, g, codes, block, out_dtype=out_dtype)
    return _launch("tn", x, g, codes, block, out_dtype)
