"""Row-CSR SPMM primitive: row-gather sparse x dense matmul.

Port of ``repro.kernels.csr_spmm`` (the Pallas kernel at
``src/repro/kernels/csr_spmm.py:43``) over the ELL view
(``core.formats.ELLMatrix``): ``out[i] = sum_{s < min(counts[i], rmax)}
vals[i, s] * y[cols[i, s]]`` in float32.  The CUDA kernel is
``csrc/csr_spmm.cu`` (one warp per row, lanes across the columns);
:func:`csr_spmm_plain` is the plain PyTorch version.

Both write rows ``[:m]`` and columns ``[:n]`` of ``out``, which may be a
wider, taller buffer (the executor's padded block-path output), and both
do nothing when the device flag ``run`` holds 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0


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
    """``ell @ y`` for ``vals``/``cols`` of ``(m, rmax)``, ``counts`` the
    (m,) per-row counts (capped at ``rmax`` here) and ``y`` of ``(k, n)``;
    every column id must be a row of ``y``.  Returns ``out``."""
    if not y.is_cuda:
        return csr_spmm_plain(vals, cols, counts, y, out=out, run=run)
    global launches
    m, rmax = vals.shape
    n = y.shape[1]
    build.require("csr_spmm vals", vals, torch.float32)
    build.require("csr_spmm cols", cols, torch.int32)
    build.require("csr_spmm counts", counts, torch.int32)
    build.require("csr_spmm y", y, torch.float32)
    if run is not None:
        build.require("csr_spmm run", run, torch.int32)
    out = _out(out, m, n, y)
    build.require("csr_spmm out", out, torch.float32)
    if m == 0 or n == 0:
        return out
    fn = build.function("csr_spmm", "rt_csr_spmm", [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 3 + [ctypes.c_long,
                                                ctypes.c_void_p])
    build.check(fn(vals.data_ptr(), cols.data_ptr(), counts.data_ptr(),
                   y.data_ptr(), out.data_ptr(),
                   None if run is None else run.data_ptr(), m, rmax, n,
                   out.shape[1], build.stream(y)), "csr_spmm")
    launches += 1
    return out
