"""The executor's block path: one launch walks the whole primitive-code grid.

The reference dispatches every (i, j, k) reduction step with a
``lax.switch`` inside a ``lax.scan`` (``src/repro/core/dynasparse.py:239``);
with kernels on, each non-SKIP step is its own Pallas call.  The port runs
the whole grid as one CUDA launch (``csrc/dispatch.cu``): CTAs own output
tiles inside one (bm, bn) block, walk the k loop in order and read each
step's primitive from ``codes`` on the device.  The product accumulates in
float32.  Two routes, by the operands' type:

* float32 (the GNN path): the first version on the FP32 FMA units, 64 x 64
  CTAs, unchanged bit for bit (the writeback counts depend on its
  rounding);
* bfloat16 (the LM's FFN): tensor cores (``mma.sync``), with the CTA tile
  and a split of the k-blocks chosen on the host from the rows that are
  really there (:func:`mma_launch`), partials added in a fixed order.

:func:`block_matmul_plain` is the plain PyTorch version with the
reference's per-step accumulation (``acc + step``).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.profile import tile_nnz

launches = 0
TILE = 16
BLOCK_EDGES = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MMA_ROWS = (16, 32, 64, 128)    # CTA tile rows of the bf16 route
MMA_COLS = 128                  # CTA tile columns at most
H100_SMS = 132


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


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
                 pad_rows: bool = True) -> torch.Tensor:
    """``x @ y`` dispatched by the (I, J, K) int32 code grid at
    ``block = (bm, bk, bn)``; returns the padded ``(I*bm, J*bn)`` float32
    product (written into ``out`` when given), or with ``pad_rows=False``
    only ``x``'s ``m`` rows, ``(m, J*bn)``, whose padding rows the bf16
    route then never writes.  When the device flag ``skip`` is nonzero
    nothing is written.

    On CUDA: float32 (FMA route) or bfloat16 (tensor-core route) operands
    of one type, ``bm`` and ``bn`` in ``BLOCK_EDGES`` and ``bk`` a multiple
    of 16; anything else raises.
    """
    if not y.is_cuda:
        return block_matmul_plain(x, y, codes, block, out=out, skip=skip,
                                  pad_rows=pad_rows)
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
        return _block_matmul_mma(x, y, codes, block, out, skip, pad_rows)
    return _block_matmul_fma(x, y, codes, block, out, skip, pad_rows)


def _block_matmul_fma(x, y, codes, block, out, skip, pad_rows):
    """The float32 route: the whole padded grid, FP32 FMAs."""
    global launches
    bm, bk, bn = block
    I, J, K = codes.shape
    m = x.shape[0]
    xp = _pad_grid(x, I * bm, K * bk)
    yp = _pad_grid(y, K * bk, J * bn)
    build.require("block_matmul x", xp, torch.float32)
    build.require("block_matmul y", yp, torch.float32)
    out = _out(out, I * bm, J * bn, y.device, pad_rows)
    build.require("block_matmul out", out, torch.float32)
    if out.numel() == 0:
        return out if pad_rows else out[:m]
    occ_x = tile_occupancy(xp)
    occ_y = tile_occupancy(yp)
    fn = build.function("dispatch", "rt_dispatch", [ctypes.c_void_p] * 7
                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    build.check(fn(xp.data_ptr(), yp.data_ptr(), codes.data_ptr(),
                   occ_x.data_ptr(), occ_y.data_ptr(), out.data_ptr(),
                   None if skip is None else skip.data_ptr(),
                   I, J, K, bm, bk, bn, build.stream(y)), "dispatch")
    launches += 1
    return out if pad_rows else out[:m]


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
    shape = mma_launch(m, I, J, K, (bm, bk, bn), _sms(y.device))
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
