"""SPMM primitive: block-sparse x block-sparse matmul (paper's "SPMM mode").

Port of ``repro.kernels.spmm`` (the Pallas kernel at
``src/repro/kernels/spmm.py:110`` and its schedule ``plan_intersection`` at
``:38``).  A reduction step k contributes to output tile (i, j) only when
both X[i, k] and Y[k, j] tiles are nonzero; :func:`plan_intersection`
compacts those steps into slot lists with device-side torch ops, and the
CUDA kernel ``csrc/spmm.cu`` walks exactly ``counts[i, j]`` of them.
:func:`spmm_plain` is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core.formats import BlockCSCMatrix, BlockCSRMatrix
from repro_torch.kernels import build

launches = 0


class IntersectionPlan(NamedTuple):
    """The per-output-tile schedule of one SPMM call (all int32)."""

    xpos: torch.Tensor     # (Mb, Nb, S): slot of step s in X.blocks[i]
    ypos: torch.Tensor     # (Mb, Nb, S): slot of step s in Y.blocks[j]
    counts: torch.Tensor   # (Mb, Nb): surviving reduction steps per out tile

    @property
    def smax(self) -> int:
        return self.xpos.shape[2]


def _occupancy(idx: torch.Tensor, counts: torch.Tensor, kb: int
               ) -> torch.Tensor:
    """(R, S) compact tile indices -> (R, Kb) bool occupancy."""
    r, s = idx.shape
    slot = torch.arange(s, device=idx.device)
    tgt = torch.where(slot[None, :] < counts[:, None], idx.long(), kb)
    occ = torch.zeros((r, kb + 1), dtype=torch.bool, device=idx.device)
    occ[torch.arange(r, device=idx.device)[:, None].expand(r, s), tgt] = True
    return occ[:, :kb]


def plan_intersection(x: BlockCSRMatrix, y: BlockCSCMatrix,
                      smax: Optional[int] = None) -> IntersectionPlan:
    """Intersect the tile occupancy of X rows with Y columns.

    The surviving-step counts are a sum of a logical AND (exact integers;
    there is no integer matmul on CUDA).  Each output tile's surviving k's
    are compacted in ascending order; slots past the count hold 0, as in
    the reference.
    """
    mb, kb = x.grid
    kb2, nb = y.grid
    if kb != kb2:
        raise ValueError(f"spmm: inner tile grids differ ({kb} vs {kb2})")
    smax = int(smax if smax is not None else kb)
    dev = x.col_idx.device
    occ_x = _occupancy(x.col_idx, x.counts, kb)                  # (Mb, Kb)
    occ_yt = _occupancy(y.row_idx, y.counts, kb)                 # (Nb, Kb)
    inter = occ_x[:, None, :] & occ_yt[None, :, :]               # (Mb,Nb,Kb)
    counts = inter.sum(dim=2, dtype=torch.int32)
    dest = torch.where(inter, torch.cumsum(inter, dim=2) - 1, smax)
    dest = torch.clamp(dest, max=smax)
    xpos_full = (torch.cumsum(occ_x, dim=1) - 1).to(torch.int32)
    ypos_full = (torch.cumsum(occ_yt, dim=1) - 1).to(torch.int32)
    xpos = torch.zeros((mb, nb, smax + 1), dtype=torch.int32, device=dev)
    ypos = torch.zeros((mb, nb, smax + 1), dtype=torch.int32, device=dev)
    xpos.scatter_(2, dest, xpos_full[:, None, :].expand(mb, nb, kb))
    ypos.scatter_(2, dest, ypos_full[None, :, :].expand(mb, nb, kb))
    return IntersectionPlan(xpos[:, :, :smax].contiguous(),
                            ypos[:, :, :smax].contiguous(),
                            torch.clamp(counts, max=smax))


def spmm_plain(x: BlockCSRMatrix, y: BlockCSCMatrix,
               plan: IntersectionPlan) -> torch.Tensor:
    """Output tile (i, j) is sum_{s < counts[i, j]} X.blocks[i, xpos] @
    Y.blocks[j, ypos], accumulated in float32 slot by slot."""
    tm, tk = x.tile
    tn = y.tile[1]
    mb, nb = x.grid[0], y.grid[1]
    dev = y.blocks.device
    ii = torch.arange(mb, device=dev)[:, None].expand(mb, nb)
    jj = torch.arange(nb, device=dev)[None, :].expand(mb, nb)
    # a zero-capacity operand keeps one dummy slot (every step is masked)
    xb = x.blocks if x.blocks.shape[1] else torch.zeros(
        (mb, 1, tm, tk), dtype=x.blocks.dtype, device=dev)
    yb = y.blocks if y.blocks.shape[1] else torch.zeros(
        (nb, 1, tk, tn), dtype=y.blocks.dtype, device=dev)
    out = torch.zeros((mb, nb, tm, tn), dtype=torch.float32, device=dev)
    for s in range(plan.smax):
        valid = (s < plan.counts)[:, :, None, None]
        xs = xb[ii, plan.xpos[:, :, s].long()].float()
        ys = yb[jj, plan.ypos[:, :, s].long()].float()
        out = torch.where(valid, out + torch.matmul(xs, ys), out)
    out = out.permute(0, 2, 1, 3).reshape(mb * tm, nb * tn)
    return out.to(torch.promote_types(x.blocks.dtype, y.blocks.dtype))


def spmm(x: BlockCSRMatrix, y: BlockCSCMatrix,
         plan: IntersectionPlan) -> torch.Tensor:
    """``dense(x) @ dense(y)`` skipping every tile pair with an empty side;
    returns the tile-padded ``(Mb*tm, Nb*tn)`` product.  On CUDA the tile
    edges must be multiples of 16 and the payloads float32."""
    if not y.blocks.is_cuda:
        return spmm_plain(x, y, plan)
    global launches
    tm, tk = x.tile
    tk2, tn = y.tile
    if tk != tk2 or tm % 16 or tk % 16 or tn % 16:
        raise ValueError(f"spmm: tiles {x.tile} x {y.tile} must agree and "
                         "be multiples of 16")
    mb, nb = x.grid[0], y.grid[1]
    for name, t in (("xpos", plan.xpos), ("ypos", plan.ypos),
                    ("counts", plan.counts)):
        build.require(f"spmm {name}", t, torch.int32)
    build.require("spmm x blocks", x.blocks, torch.float32)
    build.require("spmm y blocks", y.blocks, torch.float32)
    out = torch.empty((mb * tm, nb * tn), dtype=torch.float32,
                      device=y.blocks.device)
    if out.numel() == 0:
        return out
    fn = build.function("spmm", "rt_spmm", [ctypes.c_void_p] * 6
                        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    build.check(fn(plan.xpos.data_ptr(), plan.ypos.data_ptr(),
                   plan.counts.data_ptr(), x.blocks.data_ptr(),
                   y.blocks.data_ptr(), out.data_ptr(), mb, nb, plan.smax,
                   x.blocks.shape[1], y.blocks.shape[1], tm, tk, tn,
                   build.stream(out)), "spmm")
    launches += 1
    return out
