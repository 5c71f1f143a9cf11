"""The executor's block path: one launch walks the whole primitive-code grid.

The reference dispatches every (i, j, k) reduction step with a
``lax.switch`` inside a ``lax.scan`` (``src/repro/core/dynasparse.py:239``);
with kernels on, each non-SKIP step is its own Pallas call.  The port runs
the whole grid as one CUDA launch (``csrc/dispatch.cu``): CTAs own output
tiles inside one (bm, bn) block, walk the k loop in order and read each
step's primitive from ``codes`` on the device.  The product accumulates in
float32.  Two routes, by the operands' type:

* float32 (the GNN path): the FP32 FMA units; each warp walks its own
  16 (or 8) rows x 16 columns through its block's codes, shaped from the
  output on the host (:func:`fma_launch`); each output rounds as in the
  first version, bit for bit (the writeback counts depend on it).  Two C
  calls: a format pass over x (its 16 x 16 tile bitmask words and, for
  rows that are not 16-byte aligned, its nonzero tiles staged aligned),
  then the walk, which reads that format and y in place;
* bfloat16 (the LM's FFN): tensor cores (``mma.sync``), with the CTA tile
  and a split of the k-blocks chosen on the host from the rows that are
  really there (:func:`mma_launch`), partials added in a fixed order.

A float32 training forward (``core/dynasparse.BlockMatmulFn``) at a
block whose edges are all in ``dispatch_bwd.EDGES`` takes a third route,
:func:`block_matmul_nn`: the float32 backward's tiled kernel
(``csrc/dispatch_bwd_f32.cu``, 8 x 8 FMA microtiles fed by
``cp.async``) in its ``nn`` layout, bit for bit the FMA route's result,
counted here.

:func:`block_matmul_plain` is the plain PyTorch version with the
reference's per-step accumulation (``acc + step``).

x's format is a function of x alone.  A caller that knows x has not
changed since an earlier pass may build it once (:func:`build_x_format`,
a :class:`WalkFormat`) and hand it to later walks over x
(``block_matmul(..., x_format=)``), which then launch only the walk.
The fused executor does so for a resident graph input
(``core/runtime.FusedModelExecutor``); every other caller passes none.

Both walk routes count their tile-bitmask (or flag) pass over x in
``repro_torch.trace`` (:func:`count_bitmask_pass`): the bytes it reads,
the part an earlier pass already read unchanged, and the scratch; a
walk over a held format counts ``walk_format_hits`` and
``bitmask_reused_bytes`` (x's bytes) instead, and a build
``walk_format_builds``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.kernels import build
from repro_torch.kernels import dispatch_bwd as _bwd
from repro_torch.kernels.profile import tile_nnz

launches = 0
TILE = 16
BLOCK_EDGES = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MMA_ROWS = (16, 32, 64, 128)    # CTA tile rows of the bf16 route
MMA_COLS = 128                  # CTA tile columns at most
H100_SMS = build.H100_SMS
# id(x) -> (weak reference to x, its _version, the k-block edges whose
# bitmask pass has read it at that version); not a counter, so
# trace.reset() leaves it
_passes: Dict[int, tuple] = {}


@dataclasses.dataclass(frozen=True)
class MmaLaunch:
    """Launch shape of the bf16 route: ``row_ctas`` x ``col_ctas`` CTAs of
    ``cta_m`` x ``cta_n`` output elements, each output tile's k-blocks
    split into ``splits`` ranges (one CTA each, blockIdx.z)."""
    cta_m: int
    cta_n: int
    row_ctas: int
    col_ctas: int
    splits: int

    @property
    def rows(self) -> int:
        """Output rows the CTAs compute (the rest of the padding is
        written as zeros)."""
        return self.row_ctas * self.cta_m

    def k_ranges(self, K: int) -> List[Tuple[int, int]]:
        """The k-blocks [k0, k1) of each split, in order (as the kernel
        computes them from blockIdx.z)."""
        return [(z * K // self.splits, (z + 1) * K // self.splits)
                for z in range(self.splits)]


@functools.lru_cache(maxsize=1024)
def mma_launch(m: int, I: int, J: int, K: int,
               block: Tuple[int, int, int],
               sms: int = H100_SMS) -> Optional[MmaLaunch]:
    """The bf16 route's launch shape for ``m`` real rows of ``x``, or None
    when there is no row to compute.

    The CTA tile is the smallest of :data:`MMA_ROWS` that holds ``m`` rows
    (at most 128, at most ``bm``), so the row tiles cover ``m`` and a
    4-slot decode launches one 16-row tile, not a whole padded block; its
    columns are ``min(bn, 128)``.  When those CTAs are fewer than the
    card's ``sms``, each output tile's K k-blocks are split into ranges
    until about 4 (tiles of up to 32 rows, bound by the bytes of y) or 2
    (larger, bound by operations) CTAs per SM are in flight, at most one
    range per k-block.
    """
    bm, _, bn = block
    if m <= 0 or I <= 0 or J <= 0:
        return None
    cta_m = min(min([t for t in MMA_ROWS if t >= m] or [MMA_ROWS[-1]]), bm)
    cta_n = min(bn, MMA_COLS)
    row_ctas = -(-m // cta_m)
    col_ctas = J * bn // cta_n
    tiles = row_ctas * col_ctas
    splits = 1
    if tiles < sms and K > 1:
        per_sm = 4 if cta_m <= 32 else 2
        splits = min(K, -(-per_sm * sms // tiles))
    return MmaLaunch(cta_m, cta_n, row_ctas, col_ctas, splits)


@dataclasses.dataclass(frozen=True)
class FmaLaunch:
    """Launch shape of the float32 route: ``row_ctas`` x ``col_ctas`` CTAs
    of ``row_warps`` x ``col_warps`` warps; each warp owns ``warp_rows``
    rows and 16 columns and walks alone."""
    warp_rows: int
    row_warps: int
    col_warps: int
    row_ctas: int
    col_ctas: int

    @property
    def cta_rows(self) -> int:
        return self.warp_rows * self.row_warps

    @property
    def cta_cols(self) -> int:
        return TILE * self.col_warps


FMA_MAX_WARPS = 4              # warps per CTA


@functools.lru_cache(maxsize=1024)
def fma_launch(rows: int, J: int, block: Tuple[int, int, int],
               sms: int = H100_SMS) -> Optional[FmaLaunch]:
    """The float32 route's launch shape for ``rows`` output rows (the
    padded grid's, or x's m when only those are stored) of a grid with
    ``J`` column blocks, or None when there is nothing to write.

    A warp owns 16 rows (8 when that leaves fewer than 4 warps per SM)
    and 16 columns.  A CTA holds up to 4 warps, along the columns first
    so that they read the same x rows; fewer when the CTAs would not fill
    ``sms`` SMs (the warps walk alone, so the CTA only places them).
    Each output belongs to one warp and the k loop is never split, so the
    shape changes no output's bits.
    """
    _, _, bn = block
    tiles = J * bn // TILE
    if rows <= 0 or tiles <= 0:
        return None
    warp_rows = 16 if -(-rows // 16) * tiles >= 4 * sms else 8
    row_units = -(-rows // warp_rows)
    per_cta = FMA_MAX_WARPS
    while True:
        col_warps = min(per_cta, 1 << (tiles.bit_length() - 1))
        row_warps = per_cta // col_warps
        shape = FmaLaunch(warp_rows, row_warps, col_warps,
                          -(-row_units // row_warps),
                          -(-tiles // col_warps))
        if per_cta == 1 or shape.row_ctas * shape.col_ctas >= sms:
            return shape
        per_cta //= 2


def fma_scratch(m: int, K: int, bk: int, n: int, x_aligned: bool,
                y_aligned: bool) -> Tuple[int, int, int]:
    """4-byte words of the float32 route's scratch, in order: x's tile
    bitmasks (one word per 16-row tile of x's m rows, k-block and 32 of
    the k-block's 16-wide slices, so any ``bk`` works; rounded up to 16
    bytes); room for x's nonzero 16 x 16 tiles when x's rows are not
    16-byte aligned; y (``K * bk`` rows at most, ``n`` columns) padded to
    rows of a multiple of 4 floats when its rows are not."""
    tiles = -(-m // TILE)
    words = tiles * K * -(-(bk // TILE) // 32)
    x_tiles = 0 if x_aligned or not words else tiles * K * bk * TILE
    return -(-words // 4) * 4, x_tiles, 0 if y_aligned else -(-n // 4) * 4


def count_bitmask_pass(x: torch.Tensor, bk: int, scratch_bytes: int
                       ) -> None:
    """Count one tile-bitmask pass of the walk over ``x``'s elements at
    k-block edge ``bk``, beside a scratch of ``scratch_bytes``:
    ``bitmask_bytes``, ``bitmask_repeat_bytes`` where ``x`` is the same
    tensor object at the same ``_version`` and edge as at an earlier pass
    (a fresh tensor at a reused address, or one written in place since,
    is new; an inference-mode tensor, which keeps no version, always is),
    and the high mark ``walk_scratch_bytes``."""
    nbytes = x.numel() * x.element_size()
    trace.count("bitmask_bytes", nbytes)
    trace.high("walk_scratch_bytes", scratch_bytes)
    if x.is_inference():
        return
    key, version = id(x), x._version
    seen = _passes.get(key)
    if seen is not None and seen[0]() is x and seen[1] == version:
        if bk in seen[2]:
            trace.count("bitmask_repeat_bytes", nbytes)
            return
        seen[2].add(bk)
        return

    def forget(ref, key=key):
        if _passes.get(key, (None,))[0] is ref:
            del _passes[key]
    _passes[key] = (weakref.ref(x, forget), version, {bk})


@dataclasses.dataclass(eq=False)
class WalkFormat:
    """x's format for the float32 walk, kept across walks: one allocation
    (``buf``: the bitmask words, rounded up to 16 bytes, then the staged
    tiles when x's rows are not 16-byte aligned) and what it was built
    for.  ``walks`` counts the walks it served; the first is the one its
    build's pass was for, each later one a reuse."""
    buf: Optional[torch.Tensor]
    words: int                  # 4-byte words of the bitmask, rounded
    x_tiles: int                # floats of the staged tiles, or 0
    m: int
    kdim: int
    K: int
    bk: int
    device: torch.device
    data_ptr: int
    walks: int = 0

    @property
    def nbytes(self) -> int:
        return 4 * (self.words + self.x_tiles)

    def pointers(self) -> Tuple[Optional[int], Optional[int]]:
        """(occx, xt) as the walk's C call takes them."""
        if self.buf is None:
            return None, None
        base = self.buf.data_ptr()
        return base, base + 4 * self.words if self.x_tiles else None

    def check(self, x: torch.Tensor, K: int, bk: int) -> None:
        """Raise unless this format was built for ``x`` (its shape, device
        and data) at ``K`` k-blocks of edge ``bk``; nothing falls back."""
        got = (x.shape[0], x.shape[1], K, bk, x.device, x.data_ptr())
        want = (self.m, self.kdim, self.K, self.bk, self.device,
                self.data_ptr)
        if got != want:
            raise ValueError(f"block_matmul: x_format was built for (m, "
                             f"kdim, K, bk, device, data_ptr) {want}, not "
                             f"{got}")


def build_x_format(x: torch.Tensor, K: int, bk: int) -> WalkFormat:
    """x's format for the float32 walk at ``K`` k-blocks of edge ``bk``,
    built by one pass over x (``rt_dispatch_x_format``, which reads no
    skip flag: the format is kept for later walks).  x: contiguous
    float32 on the card, not an inference tensor; the caller keeps it
    alive and unchanged as long as it hands the format to a walk.
    Counts ``walk_format_builds`` and the pass (:func:`count_bitmask_pass`)."""
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("build_x_format: x must be contiguous float32 on "
                         "the card")
    if x.is_inference():
        raise ValueError("build_x_format: an inference tensor keeps no "
                         "version, so a kept format could go stale")
    if bk % TILE or bk <= 0 or x.shape[1] > K * bk:
        raise ValueError(f"build_x_format: {tuple(x.shape)} does not fit "
                         f"K = {K} k-blocks of edge {bk}")
    m, kdim = x.shape
    words, x_tiles, _ = fma_scratch(
        m, K, bk, 0, x.data_ptr() % 16 == 0 and kdim % 4 == 0, True)
    buf = (torch.empty(words + x_tiles, dtype=torch.float32, device=x.device)
           if words + x_tiles else None)
    fmt = WalkFormat(buf, words, x_tiles, m, kdim, K, bk, x.device,
                     x.data_ptr())
    count_bitmask_pass(x, bk, fmt.nbytes)
    trace.count("walk_format_builds")
    _x_format_pass(x, K, bk, *fmt.pointers(), None)
    return fmt


def _x_format_pass(x, K, bk, occx, xt, skip) -> None:
    """``rt_dispatch_x_format``: x's bitmask words (and staged tiles) at
    ``occx`` (``xt``); with ``skip``, nothing where the flag is set."""
    fn = build.function("dispatch", "rt_dispatch_x_format",
                        [ctypes.c_void_p] + [ctypes.c_int] * 4
                        + [ctypes.c_void_p] * 4)
    build.check(fn(x.data_ptr(), x.shape[0], x.shape[1], K, bk, occx, xt,
                   None if skip is None else skip.data_ptr(),
                   build.stream(x)), "dispatch")


def count_walk(x: torch.Tensor, bk: int, x_format: Optional[WalkFormat],
               scratch_bytes: int) -> None:
    """Count one float32 walk over ``x`` beside a scratch of
    ``scratch_bytes`` (a held format counts as the walk's scratch): its
    own format pass (:func:`count_bitmask_pass`) where no ``x_format``
    serves it; else the scratch's high mark and, for each walk after the
    one its build's pass served, ``walk_format_hits`` and x's bytes as
    ``bitmask_reused_bytes``.  So ``bitmask_bytes`` and
    ``bitmask_reused_bytes`` add up to what a pass in every walk reads."""
    if x_format is None:
        count_bitmask_pass(x, bk, scratch_bytes)
        return
    trace.high("walk_scratch_bytes", scratch_bytes)
    if x_format.walks:
        trace.count("walk_format_hits")
        trace.count("bitmask_reused_bytes", x.numel() * x.element_size())
    x_format.walks += 1


def pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Zero-pad ``x`` up to a multiple of ``rows`` x ``cols``."""
    m, n = x.shape
    pm, pn = (-m) % rows, (-n) % cols
    return F.pad(x, (0, pn, 0, pm)) if (pm or pn) else x


def tile_occupancy(x: torch.Tensor) -> torch.Tensor:
    """(M, N) -> (ceil(M/16), ceil(N/16)) uint8 nonzero-tile flags, from
    the profiler kernel's 16x16 counts."""
    return (tile_nnz(x, (TILE, TILE)) > 0).to(torch.uint8)


def _pad_grid(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` zero-padded to exactly ``rows`` x ``cols``, contiguous; no copy
    when it already is."""
    m, n = x.shape
    if (m, n) != (rows, cols):
        x = F.pad(x, (0, cols - n, 0, rows - m))
    return x.contiguous()


def _shapes(x, y, codes, block):
    bm, bk, bn = block
    I, J, K = codes.shape
    if (x.shape[0] > I * bm or x.shape[1] > K * bk or y.shape[0] > K * bk
            or y.shape[1] > J * bn or x.shape[1] != y.shape[0]):
        raise ValueError(f"block_matmul: {tuple(x.shape)} x {tuple(y.shape)} "
                         f"does not fit codes {tuple(codes.shape)} at {block}")
    return bm, bk, bn, I, J, K


def _out(out, rows, cols, device, pad_rows=True):
    if out is None:
        return torch.zeros((rows, cols), dtype=torch.float32, device=device)
    if not pad_rows:
        raise ValueError("block_matmul: out takes the padded shape; it "
                         "excludes pad_rows=False")
    if tuple(out.shape) != (rows, cols):
        raise ValueError(f"block_matmul: out must be ({rows}, {cols})")
    return out


def block_matmul_plain(x: torch.Tensor, y: torch.Tensor,
                       codes: torch.Tensor, block: Tuple[int, int, int], *,
                       out: Optional[torch.Tensor] = None,
                       skip: Optional[torch.Tensor] = None,
                       pad_rows: bool = True) -> torch.Tensor:
    """Per output block (i, j): acc = sum over k with codes[i,j,k] != SKIP
    of the float32 block product, added step by step in k order.  Every
    non-SKIP primitive computes the same value; they differ only in what
    they skip."""
    bm, bk, bn, I, J, K = _shapes(x, y, codes, block)
    out = _out(out, I * bm, J * bn, y.device, pad_rows)
    m = x.shape[0]
    if skip is not None and bool(skip):
        return out if pad_rows else out[:m]
    xb = pad_to(x.float(), bm, bk)
    xb = F.pad(xb, (0, K * bk - xb.shape[1], 0, I * bm - xb.shape[0]))
    yb = pad_to(y.float(), bk, bn)
    yb = F.pad(yb, (0, J * bn - yb.shape[1], 0, K * bk - yb.shape[0]))
    xb = xb.reshape(I, bm, K, bk).permute(0, 2, 1, 3)      # (I, K, bm, bk)
    yb = yb.reshape(K, bk, J, bn).permute(0, 2, 1, 3)      # (K, J, bk, bn)
    acc = torch.zeros((I, J, bm, bn), dtype=torch.float32, device=y.device)
    for k in range(K):
        step = torch.matmul(xb[:, k, None], yb[k][None])   # (I, J, bm, bn)
        run = (codes[:, :, k] != 0)[:, :, None, None]
        acc = torch.where(run, acc + step, acc)
    out.copy_(acc.permute(0, 2, 1, 3).reshape(I * bm, J * bn))
    return out if pad_rows else out[:m]


def block_matmul(x: torch.Tensor, y: torch.Tensor, codes: torch.Tensor,
                 block: Tuple[int, int, int], *,
                 out: Optional[torch.Tensor] = None,
                 skip: Optional[torch.Tensor] = None,
                 pad_rows: bool = True,
                 x_format: Optional[WalkFormat] = None) -> torch.Tensor:
    """``x @ y`` dispatched by the (I, J, K) int32 code grid at
    ``block = (bm, bk, bn)``; returns the padded ``(I*bm, J*bn)`` float32
    product (written into ``out`` when given), or with ``pad_rows=False``
    only ``x``'s ``m`` rows, ``(m, J*bn)``, whose padding rows the bf16
    route then never writes.  When the device flag ``skip`` is nonzero
    nothing is written.

    On CUDA: float32 (FMA route) or bfloat16 (tensor-core route) operands
    of one type, ``bm`` and ``bn`` in ``BLOCK_EDGES`` and ``bk`` a multiple
    of 16; anything else raises.  ``x_format`` (float32 only): x's format
    from :func:`build_x_format`, x unchanged since; the walk then skips
    its format pass, and a format built for another x, K or bk raises.
    The plain version (on the CPU) needs no format and ignores it.
    """
    if not y.is_cuda:
        return block_matmul_plain(x, y, codes, block, out=out, skip=skip,
                                  pad_rows=pad_rows)
    build.refuse_grad("block_matmul", x, y)
    bm, bk, bn, I, J, K = _shapes(x, y, codes, block)
    if bm not in BLOCK_EDGES or bn not in BLOCK_EDGES or bk % TILE:
        raise ValueError(f"block_matmul: block {block} not supported by the "
                         f"kernel (bm, bn in {BLOCK_EDGES}, bk % 16 == 0)")
    if x.dtype != y.dtype or y.dtype not in DTYPES:
        raise ValueError(f"block_matmul: operands {x.dtype} x {y.dtype} must "
                         "both be float32 or both bfloat16")
    build.require("block_matmul codes", codes, torch.int32)
    if skip is not None:
        build.require("block_matmul skip", skip, torch.int32)
    if y.dtype == torch.bfloat16:
        if x_format is not None:
            raise ValueError("block_matmul: x_format is the float32 walk's")
        return _block_matmul_mma(x, y, codes, block, out, skip, pad_rows)
    return _block_matmul_fma(x, y, codes, block, out, skip, pad_rows,
                             x_format)


def block_matmul_nn(x: torch.Tensor, y: torch.Tensor, codes: torch.Tensor,
                    block: Tuple[int, int, int]) -> torch.Tensor:
    """The forward ``x @ y`` of a float32 training step, dispatched by the
    (I, J, K) code grid at ``block``: x's m rows and y's n columns, ``(m,
    n)`` float32, equal bit for bit to ``block_matmul(x, y, codes, block,
    pad_rows=False)[:m, :n]`` (a fresh partial per non-SKIP k-block, one
    ``fmaf`` chain, then ``acc += partial``; SPDMM and SPMM blocks run
    dense, which adds only exact zeros).

    On CUDA: one launch of ``csrc/dispatch_bwd_f32.cu`` in its ``nn``
    layout (tiles and walk: ``dispatch_bwd.bwd_launch_f32("nn", ...)``),
    counted under ``dispatch``; float32 ``x`` (m, kd) and ``y`` (kd, n),
    both on the card, read in place (unit column stride, 16-byte aligned
    base and rows), int32 codes, every edge of ``block`` in
    ``dispatch_bwd.EDGES``, no operand requiring a gradient under grad
    mode.  Anything else raises; nothing falls back to the walk.  On the
    CPU: :func:`block_matmul_plain`."""
    global launches
    if not y.is_cuda:
        return block_matmul_plain(x, y, codes, block,
                                  pad_rows=False)[:x.shape[0], :y.shape[1]]
    out = _bwd.launch_product("nn", x, y, codes, block)
    if out.numel():
        launches += 1
    return out


def _block_matmul_fma(x, y, codes, block, out, skip, pad_rows,
                      x_format=None):
    """The float32 route: x and y are not padded (the kernel reads what
    lies past them as zeros).  x's format pass, then the walk, their
    scratch one allocation; or, over a held ``x_format``, only the walk,
    with y's pad (if any) its scratch.  Operands whose rows are not
    16-byte aligned are staged (x's nonzero tiles by the format pass, y
    padded by the walk's call), since unaligned rows cost the walk far
    more.  Only x's m rows are computed and stored unless ``pad_rows`` (or
    a caller's ``out``) asks for the padded grid."""
    global launches
    bm, bk, bn = block
    I, J, K = codes.shape
    m = x.shape[0]
    x, y = x.contiguous(), y.contiguous()
    out_rows = I * bm if pad_rows else m
    if out is None:      # every element is written unless skip is set
        out = (torch.empty if skip is None else torch.zeros)(
            (out_rows, J * bn), dtype=torch.float32, device=y.device)
    else:
        out = _out(out, I * bm, J * bn, y.device, pad_rows)
    for name, t in (("x", x), ("y", y), ("out", out)):
        build.require(f"block_matmul {name}", t, torch.float32)
    build.require_aligned("block_matmul out", out)
    if x_format is not None:
        x_format.check(x, K, bk)
    shape = fma_launch(out_rows, J, block, build.sm_count(y.device))
    if shape is None:
        return out
    kdim, n = x.shape[1], y.shape[1]
    words, x_tiles, y_cols = fma_scratch(
        m, K, bk, n, x.data_ptr() % 16 == 0 and kdim % 4 == 0,
        y.data_ptr() % 16 == 0 and n % 4 == 0)
    pad = kdim * y_cols
    if x_format is None:
        size = words + x_tiles + pad
        count_walk(x, bk, None, 4 * size)
        work = (torch.empty(size, dtype=torch.float32, device=y.device)
                if size else None)
        base = 0 if work is None else work.data_ptr()
        occx = base if words else None
        xt = base + 4 * words if x_tiles else None
        ypad = base + 4 * (words + x_tiles) if pad else None
        _x_format_pass(x, K, bk, occx, xt, skip)
    else:
        count_walk(x, bk, x_format, x_format.nbytes + 4 * pad)
        work = (torch.empty(pad, dtype=torch.float32, device=y.device)
                if pad else None)
        occx, xt = x_format.pointers()
        ypad = None if work is None else work.data_ptr()
    fn = build.function("dispatch", "rt_dispatch",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int]
                        + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                        + [ctypes.c_void_p])
    build.check(fn(x.data_ptr(), m, kdim, y.data_ptr(), n,
                   codes.data_ptr(), out.data_ptr(), out_rows, occx, xt,
                   ypad, None if skip is None else skip.data_ptr(),
                   I, J, K, bm, bk, bn, shape.warp_rows, shape.row_warps,
                   shape.col_warps, build.stream(y)), "dispatch")
    launches += 1
    return out


def _block_matmul_mma(x, y, codes, block, out, skip, pad_rows):
    """The bfloat16 route: only the row tiles that hold ``x``'s rows, on
    the tensor cores, split over k when they are too few for the card.
    ``x`` is not padded to the block rows (the kernel reads rows past m as
    zeros), and only its m rows are stored: the padding rows of ``out``
    are zero-filled when ``pad_rows``, else not allocated.  One C call
    flags x's nonzero 16x16 tiles and walks the grid; its scratch (the
    flags, then the split partials) is one allocation."""
    global launches
    bm, bk, bn = block
    I, J, K = codes.shape
    m = x.shape[0]
    shape = mma_launch(m, I, J, K, (bm, bk, bn), build.sm_count(y.device))
    xp = _pad_grid(x, m, K * bk)
    yp = _pad_grid(y, K * bk, J * bn)
    out_rows = I * bm if pad_rows else m
    if out is None:      # every element is written unless skip is set
        out = (torch.empty if skip is None else torch.zeros)(
            (out_rows, J * bn), dtype=torch.float32, device=y.device)
    else:
        out = _out(out, I * bm, J * bn, y.device, pad_rows)
    for name, t, dtype in (("x", xp, torch.bfloat16),
                           ("y", yp, torch.bfloat16),
                           ("out", out, torch.float32)):
        build.require(f"block_matmul {name}", t, dtype)
        build.require_aligned(f"block_matmul {name}", t)
    if out.numel() == 0:
        return out
    flags, partials = _scratch_sizes(shape, m, K * bk, J * bn)
    count_bitmask_pass(x, bk, 4 * (flags + partials))
    work = (torch.empty(flags + partials, dtype=torch.float32,
                        device=y.device) if flags + partials else None)
    ptr = 0 if work is None else work.data_ptr()
    fn = build.function("dispatch", "rt_dispatch_mma",
                        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                        + [ctypes.c_int] + [ctypes.c_void_p] * 3
                        + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    build.check(fn(xp.data_ptr(), m, yp.data_ptr(), codes.data_ptr(),
                   out.data_ptr(), out_rows, ptr if flags else None,
                   ptr + 4 * flags if partials else None,
                   None if skip is None else skip.data_ptr(),
                   I, J, K, bm, bk, bn,
                   shape.cta_m if shape else TILE,
                   shape.cta_n if shape else min(bn, MMA_COLS),
                   shape.row_ctas if shape else 0,
                   shape.splits if shape else 1,
                   build.stream(y)), "dispatch")
    launches += 1
    return out


def _scratch_sizes(shape: Optional[MmaLaunch], m: int, k: int,
                   n: int) -> Tuple[int, int]:
    """4-byte words of the bf16 route's scratch: x's tile flags (one int32
    per 16x16 tile of the real rows, rounded up to 16 bytes so the
    partials stay aligned), then the float32 partials of a split (x's m
    rows each)."""
    if shape is None:
        return 0, 0
    flags = -(-m // TILE) * (k // TILE)
    flags = -(-flags // 4) * 4
    partials = shape.splits * m * n if shape.splits > 1 else 0
    return flags, partials
