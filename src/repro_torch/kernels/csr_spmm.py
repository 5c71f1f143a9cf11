"""Row-CSR SPMM primitive: row-gather sparse x dense matmul.

Port of ``repro.kernels.csr_spmm`` (the Pallas kernel at
``src/repro/kernels/csr_spmm.py:43``) over the ELL view
(``core.formats.ELLMatrix``): ``out[i] = sum_{s < min(counts[i], rmax)}
vals[i, s] * y[cols[i, s]]``, float32 or bf16 operands of one type,
accumulated and written in float32.  :func:`csr_spmm_plain` is the plain
PyTorch version.

The CUDA kernel (``csrc/csr_spmm.cu``) ranks the rows by count on the
device (longest first) and lets a group of lanes walk each row over a strip
of columns, the row's slots staged in registers and 32 y loads a lane
issued before their FMAs.  :func:`csr_launch` and the kernel shape the work
by row length: the longest ranks first walk strips of one column a lane,
so a hub row spreads over many warps; the others walk 1024-column strips,
strip after strip, in passes whose width grows as the row gets shorter;
outputs up to 16 wide put two rows in a warp.  Each output is one fmaf
chain over its row's slots in slot order, from 0, whatever the shape: on
float32 operands the dense ``gemm``'s value bit for bit (ELL keeps a row's
columns ascending, and fma(0, y, p) == p for finite y).

Both versions write rows ``[:m]`` and columns ``[:n]`` of ``out``, which
may be a wider, taller buffer (the executor's padded block-path output),
and both do nothing when the device flag ``run`` holds 0.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0
# launches by (rows, output width): the shapes the path gives the kernel
launches_by_shape: collections.Counter = collections.Counter()
DTYPES = (torch.float32, torch.bfloat16)
WARP = 32
NARROW = 16            # outputs up to this wide put two rows in a warp
LIGHT_COLS = 1024      # columns of a light unit (csrc/csr_spmm.cu)
HEAVY_ROWS = 48        # the longest ranks that walk narrow strips ...
LONG_SLOTS = 8         # ... when a row may hold more slots than this
HUB_ROWS = 4           # the longest of them that are hub units ...
HUB_SLOTS = 128        # ... when a row may hold more than half this
MAX_WARPS = 4          # warps per CTA


@dataclasses.dataclass(frozen=True)
class CsrLaunch:
    """Launch shape of ``csr_spmm``, over the ranks of the long-rows-first
    order.  The first ``hub_rows * hub_strips`` CTAs are hub units: CTA b
    takes rank ``b // hub_strips`` over the 32-column strip ``b %
    hub_strips``.  Then warp u of the CTAs after them (``32 // group``
    ranks a warp, one per ``group`` lanes) takes heavy unit u while ``u <
    heavy_units``: ranks ``hub_rows + (u // heavy_strips) * rows_per_warp
    + lane // group`` (those below ``heavy_rows``) over the
    ``group``-column strip ``u % heavy_strips``; then light unit v: the
    rank group ``v % groups`` after the heavy ranks over the strip ``v //
    groups`` of ``strip_cols`` columns, ``strips`` strips."""
    group: int
    strip_cols: int
    strips: int
    hub_rows: int
    hub_strips: int
    heavy_rows: int
    heavy_strips: int
    per_cta: int
    ctas: int

    @property
    def rows_per_warp(self) -> int:
        return WARP // self.group

    @property
    def hub_ctas(self) -> int:
        return self.hub_rows * self.hub_strips

    @property
    def heavy_units(self) -> int:
        return (-(-(self.heavy_rows - self.hub_rows) // self.rows_per_warp)
                * self.heavy_strips)

    def groups(self, m: int) -> int:
        """Light rank groups of one strip."""
        return -(-(m - self.heavy_rows) // self.rows_per_warp)

    def units(self, m: int) -> int:
        """Warps after the hub CTAs that hold work: the heavy units, then
        the light ones."""
        return self.heavy_units + self.groups(m) * self.strips


@functools.lru_cache(maxsize=1024)
def csr_launch(m: int, n: int, max_count: int,
               sms: int = build.H100_SMS) -> Optional[CsrLaunch]:
    """The kernel's shape for ``m`` rows of at most ``max_count`` slots (the
    wrapper passes ``rmax``: counts are capped there) and an ``n``-wide
    output, or None when there is nothing to write.

    Outputs up to 16 wide: two rows a warp, 16 lanes on each row's
    columns.  Wider: one row a warp over strips of ``LIGHT_COLS`` columns,
    strip after strip, so that the rows of y they gather stay in L2; the
    kernel walks a strip in passes as wide as the row's length allows (32
    columns a lane for a 1-slot row, 4 beyond 4 slots).  When a row may
    hold more than ``LONG_SLOTS`` slots, the ``HEAVY_ROWS`` longest ranks
    first walk strips of one column a lane instead, 32 slots a chunk, so
    that a long row's columns spread over many warps; when it may hold
    more than ``HUB_SLOTS`` / 2, the ``HUB_ROWS`` longest of them are hub
    units, a CTA per 32 columns staging 128 slots at a time in shared
    memory.  Up to 4 warps a CTA (always 4 with hub units), fewer while
    the CTAs would not fill ``sms`` SMs.  No shape splits a row's slots,
    so none changes an output's bits.
    """
    if m <= 0 or n <= 0:
        return None
    group, strip_cols = (NARROW, NARROW) if n <= NARROW else (WARP,
                                                              LIGHT_COLS)
    heavy = min(m, HEAVY_ROWS) if max_count > LONG_SLOTS else 0
    hub = min(heavy, HUB_ROWS) if max_count > HUB_SLOTS // 2 else 0
    shape = CsrLaunch(group, strip_cols, -(-n // strip_cols), hub,
                      -(-n // WARP) if hub else 0, heavy,
                      -(-n // group) if heavy > hub else 0, MAX_WARPS, 0)
    units = shape.units(m)
    per_cta = MAX_WARPS
    while not hub and per_cta > 1 and -(-units // per_cta) < sms:
        per_cta //= 2
    return dataclasses.replace(shape, per_cta=per_cta,
                               ctas=shape.hub_ctas + -(-units // per_cta))


def _out(out: Optional[torch.Tensor], m: int, n: int, y: torch.Tensor
         ) -> torch.Tensor:
    if out is None:
        return torch.empty((m, n), dtype=torch.float32, device=y.device)
    if out.shape[0] < m or out.shape[1] < n or not out.is_contiguous():
        raise ValueError(f"csr_spmm: out {tuple(out.shape)} cannot hold "
                         f"({m}, {n}) contiguously")
    return out


def csr_spmm_plain(vals: torch.Tensor, cols: torch.Tensor,
                   counts: torch.Tensor, y: torch.Tensor, *,
                   out: Optional[torch.Tensor] = None,
                   run: Optional[torch.Tensor] = None) -> torch.Tensor:
    m, rmax = vals.shape
    n = y.shape[1]
    out = _out(out, m, n, y)
    if run is not None and not bool(run):
        return out
    valid = (torch.arange(rmax, device=vals.device)[None, :]
             < torch.clamp(counts, max=rmax)[:, None])
    v = torch.where(valid, vals.float(), 0.0)
    yf = y.float()
    acc = torch.zeros((m, n), dtype=torch.float32, device=y.device)
    for s in range(rmax):                 # slot order, as the kernel sums
        acc = acc + v[:, s, None] * yf[cols[:, s].long()]
    out[:m, :n] = acc
    return out


def csr_spmm(vals: torch.Tensor, cols: torch.Tensor, counts: torch.Tensor,
             y: torch.Tensor, *, out: Optional[torch.Tensor] = None,
             run: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ell @ y`` in float32 for ``vals``/``cols`` of ``(m, rmax)``,
    ``counts`` the (m,) per-row counts (capped at ``rmax`` here) and ``y``
    of ``(k, n)``; every column id must be a row of ``y``.  Returns
    ``out``.  On CUDA ``vals`` and ``y`` are both float32 or both bf16,
    and ``y`` has fewer than 2^32 elements."""
    if not y.is_cuda:
        return csr_spmm_plain(vals, cols, counts, y, out=out, run=run)
    build.refuse_grad("csr_spmm", vals, y)
    global launches
    m, rmax = vals.shape
    n = y.shape[1]
    if vals.dtype != y.dtype or y.dtype not in DTYPES:
        raise ValueError(f"csr_spmm: vals {vals.dtype} and y {y.dtype} must "
                         "both be float32 or both bfloat16")
    build.require("csr_spmm vals", vals, y.dtype)
    build.require("csr_spmm cols", cols, torch.int32)
    build.require("csr_spmm counts", counts, torch.int32)
    build.require("csr_spmm y", y, y.dtype)
    if y.numel() >= 2 ** 32:
        raise ValueError("csr_spmm: y must have fewer than 2^32 elements "
                         "(the kernel's row offsets are 32-bit)")
    if run is not None:
        build.require("csr_spmm run", run, torch.int32)
    out = _out(out, m, n, y)
    build.require("csr_spmm out", out, torch.float32)
    shape = csr_launch(m, n, rmax, build.sm_count(y.device))
    if shape is None:
        return out
    order = torch.empty(m, dtype=torch.int32, device=y.device)
    fn = build.function("csr_spmm", "rt_csr_spmm", [ctypes.c_void_p] * 7
                        + [ctypes.c_int] * 4 + [ctypes.c_long]
                        + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    build.check(fn(vals.data_ptr(), cols.data_ptr(), counts.data_ptr(),
                   y.data_ptr(), out.data_ptr(), order.data_ptr(),
                   None if run is None else run.data_ptr(),
                   int(y.dtype == torch.bfloat16), m, rmax, n, out.shape[1],
                   shape.group, shape.hub_rows, shape.heavy_rows,
                   shape.heavy_strips, shape.strips, shape.per_cta,
                   shape.ctas, build.stream(y)), "csr_spmm")
    launches += 1
    launches_by_shape[(m, n)] += 1
    return out
