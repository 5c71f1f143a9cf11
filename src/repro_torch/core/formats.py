"""Data formats & transformations (paper Section V-A / V-B2).

Port of the block and row formats of ``repro.core.formats`` that the
executor and the kernels consume:

* :class:`BlockCSRMatrix` / :class:`BlockCSCMatrix` -- tile-level
  compaction of nonzero tiles per tile-row / tile-column (the spdmm and
  spmm kernels' operands);
* :class:`COOMatrix` / :class:`CSRMatrix` -- the flat padded storage
  formats with a static capacity (the paper's D2S / S2D: one prefix-sum
  compaction and a scatter);
* :class:`ELLMatrix` -- the fixed-slots-per-row view of row-CSR that the
  row-gather SPMM (``kernels.csr_spmm``) consumes, built on the device by
  :func:`dense_to_ell` (or :func:`csr_to_ell` from flat CSR).

Every converter runs on the tensor's device and produces the reference's
integers exactly, padding slots included, but for :func:`csr_to_ell`'s
empty slots: they hold column ``k - 1``, as :func:`dense_to_ell`'s do,
where the reference's ``csr_to_ell`` writes column 0.
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

    def tile_density(self) -> torch.Tensor:
        """Fraction of the tile grid that holds a nonzero tile (float32)."""
        mb, kb = self.grid
        return _ratio(self.counts.sum(dtype=torch.int32), mb * kb)


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


def _ratio(count: torch.Tensor, total: int) -> torch.Tensor:
    """``count / total`` in float32 with the divisor made a tensor on the
    count's device: CUDA's division by a host number multiplies by its
    reciprocal, which rounds differently from the reference's division."""
    return count.to(torch.float32) / torch.full(
        (), total, dtype=torch.float32, device=count.device)


@dataclasses.dataclass
class COOMatrix:
    """Padded COO: entries [0, nnz) are valid; the rest are (0, 0, 0.0).

    Rows/cols are int32, row-major sorted (row, then col).
    """

    rows: torch.Tensor     # (capacity,) int32
    cols: torch.Tensor     # (capacity,) int32
    values: torch.Tensor   # (capacity,) dtype
    nnz: torch.Tensor      # () int32
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    def density(self) -> torch.Tensor:
        return _ratio(self.nnz, self.shape[0] * self.shape[1])


def _compact_flat(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """D2S slot of every element of a flat nonzero mask: the prefix sum of
    the mask for a nonzero, the dump slot ``capacity`` for a zero or a
    nonzero past the capacity.  Only the dump slot receives more than one
    element, and the callers slice it off."""
    dest = torch.where(mask, torch.cumsum(mask, dim=0) - 1, capacity)
    return torch.clamp(dest, max=capacity)


def _scatter_flat(dest: torch.Tensor, src: torch.Tensor, capacity: int
                  ) -> torch.Tensor:
    out = torch.zeros((capacity + 1,), dtype=src.dtype, device=src.device)
    out[dest] = src
    return out[:capacity]


def dense_to_coo(x: torch.Tensor, capacity: Optional[int] = None
                 ) -> COOMatrix:
    """D2S: prefix-sum compaction of the nonzeros into padded COO
    (row-major), on the tensor's device.  ``capacity`` is static (default
    m * n); nonzeros past it are dropped and ``nnz`` is clamped to it."""
    m, n = x.shape
    capacity = int(capacity if capacity is not None else m * n)
    flat = x.reshape(-1)
    mask = flat != 0
    nnz = mask.sum(dtype=torch.int32)
    dest = _compact_flat(mask, capacity)
    lin = torch.arange(m * n, dtype=torch.int32, device=x.device)
    return COOMatrix(_scatter_flat(dest, lin // n, capacity),
                     _scatter_flat(dest, lin % n, capacity),
                     _scatter_flat(dest, flat, capacity),
                     torch.clamp(nnz, max=capacity), (m, n))


def coo_to_dense(coo: COOMatrix) -> torch.Tensor:
    """S2D: scatter-add the valid COO entries into a dense matrix (invalid
    entries add 0.0 at (0, 0))."""
    m, n = coo.shape
    dev = coo.values.device
    valid = torch.arange(coo.capacity, device=dev) < coo.nnz
    vals = torch.where(valid, coo.values, 0)
    rows = torch.where(valid, coo.rows, 0).long()
    cols = torch.where(valid, coo.cols, 0).long()
    out = torch.zeros((m, n), dtype=coo.values.dtype, device=dev)
    return out.index_put_((rows, cols), vals, accumulate=True)


@dataclasses.dataclass
class CSRMatrix:
    """Padded flat CSR with STATIC capacity.

    ``indptr`` is monotone with ``indptr[-1] == nnz`` (clamped to capacity);
    entries ``[indptr[r], indptr[r+1])`` of ``indices``/``values`` are row
    r's column ids (ascending) and values.  Slots ``>= nnz`` are (0, 0.0)
    padding, as in :class:`COOMatrix`.
    """

    indptr: torch.Tensor   # (m + 1,) int32
    indices: torch.Tensor  # (capacity,) int32
    values: torch.Tensor   # (capacity,)
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.indices.shape[0]

    @property
    def nnz(self) -> torch.Tensor:
        return self.indptr[-1]

    def density(self) -> torch.Tensor:
        return _ratio(self.nnz, self.shape[0] * self.shape[1])


def dense_to_csr(x: torch.Tensor, capacity: Optional[int] = None
                 ) -> CSRMatrix:
    """D2S into flat CSR: the compaction of :func:`dense_to_coo`, with the
    row ids folded into ``indptr`` (cumulative row counts clamped to the
    capacity, which drops exactly the trailing entries the compaction
    drops)."""
    m, n = x.shape
    capacity = int(capacity if capacity is not None else m * n)
    dev = x.device
    flat = x.reshape(-1)
    dest = _compact_flat(flat != 0, capacity)
    cols_src = torch.arange(m * n, dtype=torch.int32, device=dev) % n
    row_counts = (x != 0).sum(dim=1, dtype=torch.int32)
    indptr = torch.cat([
        torch.zeros((1,), dtype=torch.int32, device=dev),
        torch.clamp(torch.cumsum(row_counts, dim=0), max=capacity).to(
            torch.int32)])
    return CSRMatrix(indptr, _scatter_flat(dest, cols_src, capacity),
                     _scatter_flat(dest, flat, capacity), (m, n))


def _csr_rows(c: CSRMatrix) -> torch.Tensor:
    """Row id of each storage slot (searchsorted over the row boundaries)."""
    e = torch.arange(c.capacity, dtype=c.indptr.dtype,
                     device=c.indptr.device)
    return torch.searchsorted(c.indptr[1:].contiguous(), e, right=True,
                              out_int32=True)


def _valid_slots(c: CSRMatrix) -> torch.Tensor:
    return torch.arange(c.capacity, device=c.indptr.device) < c.nnz


def csr_to_dense(c: CSRMatrix) -> torch.Tensor:
    m, n = c.shape
    valid = _valid_slots(c)
    rows = torch.where(valid, torch.clamp(_csr_rows(c), max=m - 1), 0)
    cols = torch.where(valid, c.indices, 0)
    vals = torch.where(valid, c.values, 0)
    out = torch.zeros((m, n), dtype=c.values.dtype, device=c.values.device)
    return out.index_put_((rows.long(), cols.long()), vals, accumulate=True)


def coo_to_csr(coo: COOMatrix) -> CSRMatrix:
    """Fold row-major COO row ids into ``indptr`` (no re-sort needed).

    ``indptr[b]`` counts the valid entries whose row is below ``b``: an
    entry of row r is counted from ``b = r + 1`` on, so a histogram of
    ``r + 1`` (clamped to [0, m + 1], invalid entries at m + 1) and its
    prefix sum give the counts in O(capacity + m)."""
    m, _ = coo.shape
    dev = coo.values.device
    valid = torch.arange(coo.capacity, device=dev) < coo.nnz
    first = torch.where(valid, torch.clamp(coo.rows.long() + 1, 0, m + 1),
                        m + 1)
    hist = torch.zeros((m + 2,), dtype=torch.int64, device=dev)
    hist.scatter_add_(0, first, torch.ones_like(first))
    indptr = torch.cumsum(hist[: m + 1], dim=0).to(torch.int32)
    return CSRMatrix(indptr,
                     torch.where(valid, coo.cols, 0),
                     torch.where(valid, coo.values, 0),
                     coo.shape)


def csr_to_coo(c: CSRMatrix) -> COOMatrix:
    m, _ = c.shape
    valid = _valid_slots(c)
    rows = torch.where(valid, torch.clamp(_csr_rows(c), max=m - 1), 0)
    return COOMatrix(rows.to(torch.int32),
                     torch.where(valid, c.indices, 0),
                     torch.where(valid, c.values, 0),
                     c.nnz.to(torch.int32), c.shape)


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


def csr_to_ell(c: CSRMatrix, rmax: int) -> ELLMatrix:
    """Flat CSR -> ELL: scatter each slot to (row, slot - indptr[row]).

    The first ``rmax`` entries of each row land in its slots; slots past a
    row's count hold value 0 and column ``k - 1``, as :func:`dense_to_ell`
    leaves them, so the two converters give the same ``ELLMatrix``
    (``row_counts`` are the CSR's, the true counts unless the capacity
    clamped them)."""
    m, k = c.shape
    dev = c.indices.device
    e = torch.arange(c.capacity, device=dev)
    rows = torch.clamp(_csr_rows(c), max=m - 1).long()
    pos = e - c.indptr[rows]
    valid = (e < c.nnz) & (pos < rmax)
    r = torch.where(valid, rows, 0)
    p = torch.where(valid, pos, rmax)
    cols = torch.full((m, rmax + 1), k - 1, dtype=torch.int32, device=dev)
    cols[r, p] = c.indices
    vals = torch.zeros((m, rmax + 1), dtype=c.values.dtype, device=dev)
    vals[r, p] = c.values
    row_counts = (c.indptr[1:] - c.indptr[:-1]).to(torch.int32)
    return ELLMatrix(vals[:, :rmax].contiguous(), cols[:, :rmax].contiguous(),
                     row_counts, c.shape)


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
