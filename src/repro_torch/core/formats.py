"""Data formats & transformations (paper Section V-A / V-B2).

Port of the block and row formats of ``repro.core.formats`` that the
executor and the kernels consume:

* :class:`BlockCSRMatrix` / :class:`BlockCSCMatrix` -- tile-level
  compaction of nonzero tiles per tile-row / tile-column (the spdmm and
  spmm kernels' operands);
* :class:`ELLMatrix` -- the fixed-slots-per-row view of row-CSR that the
  row-gather SPMM (``kernels.csr_spmm``) consumes, built on the device by
  :func:`dense_to_ell`.

Every converter produces the reference's integers exactly, padding slots
included.  The flat COO/CSR storage formats are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _pad_to_tiles(x: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    m, n = x.shape
    pm, pn = (-m) % tile[0], (-n) % tile[1]
    return F.pad(x, (0, pn, 0, pm)) if (pm or pn) else x


def tile_view(x: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    """(M, N) -> (Mb, Nb, tm, tn) tile tensor (pads to tile multiples)."""
    x = _pad_to_tiles(x, tile)
    m, n = x.shape
    tm, tn = tile
    return x.reshape(m // tm, tm, n // tn, tn).permute(0, 2, 1, 3)


def untile_view(tiles: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    mb, nb, tm, tn = tiles.shape
    full = tiles.permute(0, 2, 1, 3).reshape(mb * tm, nb * tn)
    return full[: shape[0], : shape[1]]


@dataclasses.dataclass
class BlockCSRMatrix:
    """Tile-level CSR over a (Mb x Kb) tile grid.

    ``col_idx[i, s]`` is the tile-column of the s-th nonzero tile in tile-row
    i (ascending; entries >= counts[i] are padding = 0); ``blocks[i, s]`` is
    its dense (tm, tk) payload.
    """

    col_idx: torch.Tensor  # (Mb, Smax) int32
    counts: torch.Tensor   # (Mb,) int32 -- nnz tiles per tile-row
    blocks: torch.Tensor   # (Mb, Smax, tm, tk)
    shape: Tuple[int, int]
    tile: Tuple[int, int]

    @property
    def grid(self) -> Tuple[int, int]:
        return (-(-self.shape[0] // self.tile[0]),
                -(-self.shape[1] // self.tile[1]))


@dataclasses.dataclass
class BlockCSCMatrix:
    """Tile-level CSC over a (Kb x Nb) tile grid (SPMM's right operand).

    ``row_idx[j, s]`` is the tile-row of the s-th nonzero tile in tile-column
    j; ``blocks[j, s]`` its (tk, tn) payload, not transposed.
    """

    row_idx: torch.Tensor  # (Nb, Smax) int32
    counts: torch.Tensor   # (Nb,) int32
    blocks: torch.Tensor   # (Nb, Smax, tk, tn)
    shape: Tuple[int, int]
    tile: Tuple[int, int]

    @property
    def grid(self) -> Tuple[int, int]:
        return (-(-self.shape[0] // self.tile[0]),
                -(-self.shape[1] // self.tile[1]))


def _compact(nz: torch.Tensor, smax: int) -> torch.Tensor:
    """Slot of every occupied tile along the last axis (prefix-sum
    compaction); unoccupied and over-capacity tiles go to the dump slot
    ``smax``, which the callers slice off."""
    dest = torch.where(nz, torch.cumsum(nz, dim=-1) - 1, smax)
    return torch.clamp(dest, max=smax)


def dense_to_bcsr(x: torch.Tensor, tile: Tuple[int, int],
                  smax: Optional[int] = None) -> BlockCSRMatrix:
    """Compact the nonzero tiles of each tile-row."""
    tiles = tile_view(x, tile)                      # (Mb, Kb, tm, tk)
    mb, kb = tiles.shape[:2]
    smax = int(smax if smax is not None else kb)
    dev = x.device
    nz = (tiles != 0).any(dim=3).any(dim=2)         # (Mb, Kb)
    counts = nz.sum(dim=1, dtype=torch.int32)
    dest = _compact(nz, smax)
    rows = torch.arange(mb, device=dev)[:, None].expand(mb, kb)
    col_ids = torch.arange(kb, device=dev, dtype=torch.int32)[None, :].expand(
        mb, kb)
    col_idx = torch.zeros((mb, smax + 1), dtype=torch.int32, device=dev)
    col_idx[rows, dest] = col_ids
    blocks = torch.zeros((mb, smax + 1) + tuple(tiles.shape[2:]),
                         dtype=x.dtype, device=dev)
    blocks[rows, dest] = tiles
    return BlockCSRMatrix(col_idx[:, :smax].contiguous(),
                          torch.clamp(counts, max=smax),
                          blocks[:, :smax].contiguous(),
                          shape=tuple(x.shape), tile=tuple(tile))


def dense_to_bcsc(x: torch.Tensor, tile: Tuple[int, int],
                  smax: Optional[int] = None) -> BlockCSCMatrix:
    """Compact the nonzero tiles of each tile-COLUMN (payloads stay
    untransposed)."""
    tiles = tile_view(x, tile)                      # (Kb, Nb, tk, tn)
    kb, nb = tiles.shape[:2]
    smax = int(smax if smax is not None else kb)
    dev = x.device
    nz = (tiles != 0).any(dim=3).any(dim=2).T       # (Nb, Kb)
    counts = nz.sum(dim=1, dtype=torch.int32)
    dest = _compact(nz, smax)
    cols = torch.arange(nb, device=dev)[:, None].expand(nb, kb)
    row_ids = torch.arange(kb, device=dev, dtype=torch.int32)[None, :].expand(
        nb, kb)
    row_idx = torch.zeros((nb, smax + 1), dtype=torch.int32, device=dev)
    row_idx[cols, dest] = row_ids
    blocks = torch.zeros((nb, smax + 1) + tuple(tiles.shape[2:]),
                         dtype=x.dtype, device=dev)
    blocks[cols, dest] = tiles.transpose(0, 1)
    pad_shape = (kb * tile[0], nb * tile[1])
    return BlockCSCMatrix(row_idx[:, :smax].contiguous(),
                          torch.clamp(counts, max=smax),
                          blocks[:, :smax].contiguous(),
                          shape=pad_shape, tile=tuple(tile))


def bcsr_to_dense(b: BlockCSRMatrix) -> torch.Tensor:
    mb, kb = b.grid
    smax = b.col_idx.shape[1]
    dev = b.blocks.device
    valid = torch.arange(smax, device=dev)[None, :] < b.counts[:, None]
    cols = torch.where(valid, b.col_idx.long(), kb)
    rows = torch.arange(mb, device=dev)[:, None].expand(mb, smax)
    tiles = torch.zeros((mb, kb + 1) + tuple(b.blocks.shape[2:]),
                        dtype=b.blocks.dtype, device=dev)
    tiles.index_put_((rows, cols),
                     torch.where(valid[..., None, None], b.blocks, 0),
                     accumulate=True)
    return untile_view(tiles[:, :kb], b.shape)


@dataclasses.dataclass
class ELLMatrix:
    """Padded row-CSR execution view: ``rmax`` slots per row.

    ``values[i, s]`` / ``cols[i, s]`` are row i's s-th nonzero; slots beyond
    the row's count hold value 0 and column ``k - 1`` (in range, so gathers
    through them are safe).  ``row_counts`` keeps the TRUE (uncapped)
    per-row counts, so ``max(row_counts) <= rmax`` is an exact lossless-fit
    predicate.
    """

    values: torch.Tensor      # (m, rmax)
    cols: torch.Tensor        # (m, rmax) int32
    row_counts: torch.Tensor  # (m,) int32 -- TRUE counts, may exceed rmax
    shape: Tuple[int, int]

    @property
    def rmax(self) -> int:
        return self.values.shape[1]


def dense_to_ell(x: torch.Tensor, rmax: int) -> ELLMatrix:
    """D2S into ELL on the tensor's device: one prefix sum per row, then a
    scatter of each nonzero's column into its slot.

    Gives the reference's hierarchical converter's exact output: the
    first ``rmax`` nonzero columns of each row in ascending order, and
    column ``k - 1`` with value 0 in every slot past the row's count.
    """
    m, k = x.shape
    dev = x.device
    nz = x != 0
    counts = nz.sum(dim=1, dtype=torch.int32)
    dest = torch.where(nz, torch.cumsum(nz, dim=1) - 1, rmax)
    dest = torch.clamp(dest, max=rmax)
    cols = torch.full((m, rmax + 1), k - 1, dtype=torch.int32, device=dev)
    cols.scatter_(1, dest, torch.arange(k, dtype=torch.int32, device=dev)
                  .expand(m, k))
    cols = cols[:, :rmax].contiguous()
    valid = (torch.arange(rmax, device=dev)[None, :] < counts[:, None])
    vals = torch.where(valid, torch.gather(x, 1, cols.long()), 0).to(x.dtype)
    return ELLMatrix(vals, cols, counts, (m, k))


def ell_to_dense(ell: ELLMatrix) -> torch.Tensor:
    """S2D (lossless only when every row fits: max(row_counts) <= rmax)."""
    m, k = ell.shape
    dev = ell.values.device
    valid = (torch.arange(ell.rmax, device=dev)[None, :]
             < torch.clamp(ell.row_counts, max=ell.rmax)[:, None])
    out = torch.zeros((m, k), dtype=ell.values.dtype, device=dev)
    return out.scatter_add_(1, ell.cols.long(),
                            torch.where(valid, ell.values, 0))


def ell_matmul(ell: ELLMatrix, y: torch.Tensor) -> torch.Tensor:
    """Row-gather SPMM, plain version: out[i] = sum_s vals[i,s] * y[cols[i,s]].

    Invalid slots carry value 0 and an in-range column.  f32 accumulation.
    """
    g = y[ell.cols.long()].float()                         # (m, rmax, n)
    return (ell.values.float()[:, :, None] * g).sum(dim=1)
