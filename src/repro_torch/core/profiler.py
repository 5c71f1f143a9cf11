"""Sparsity profiling (paper Section V-B2, "Sparsity Profiler").

Port of ``repro.core.profiler``: per-block nonzero counts and the densities
the Analyzer plans from.  Everything runs on the tensor's own device, so the
executor's profiling never leaves the GPU.  Counts are exact integers,
which is what makes the fused executor's pooled writeback profiles bitwise
equal to profiling the tensor directly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.profile import tile_nnz, tile_nnz_batched


def element_density(x: torch.Tensor) -> torch.Tensor:
    """Fraction of nonzero elements of the whole matrix (scalar)."""
    return torch.count_nonzero(x) / x.numel()


def density_from_counts(counts: torch.Tensor, m: int, n: int,
                        bm: int, bn: int) -> torch.Tensor:
    """(Mb, Nb) nonzero counts -> float32 densities relative to the
    *unpadded* elements actually inside each block (ragged edges)."""
    mb, nb = counts.shape
    dev = counts.device
    rows_in = torch.clamp(m - torch.arange(mb, device=dev) * bm, 0, bm)
    cols_in = torch.clamp(n - torch.arange(nb, device=dev) * bn, 0, bn)
    sizes = (rows_in[:, None] * cols_in[None, :]).to(torch.int32)
    return counts.to(torch.int32) / torch.clamp(sizes, min=1)


def block_counts(x: torch.Tensor, block: Tuple[int, int]) -> torch.Tensor:
    """Per-block NONZERO COUNTS.  (M, N) -> (Mb, Nb) int32, through the
    profiler kernel (``kernels/profile.py``) on a CUDA tensor and its plain
    version on the CPU."""
    return tile_nnz(x, tuple(block))


def batched_block_counts(x: torch.Tensor, block: Tuple[int, int]
                         ) -> torch.Tensor:
    """Per-block nonzero counts of a stacked batch in ONE launch:
    (B, M, N) -> (B, Mb, Nb) int32, each slice bitwise ``block_counts`` of
    that slice (integer sums are order-free), which keeps batched and
    per-request planning exact.  The serving wave's request inputs are
    profiled through it (``tile_nnz_batched`` on a CUDA tensor)."""
    return tile_nnz_batched(x, tuple(block))


def block_density(x: torch.Tensor, block: Tuple[int, int]) -> torch.Tensor:
    """Per-block element density.  (M, N) -> (Mb, Nb) in [0, 1]."""
    m, n = x.shape
    return density_from_counts(block_counts(x, block), m, n, *block)


def tile_occupancy(x: torch.Tensor, tile: Tuple[int, int]) -> torch.Tensor:
    """Per-tile occupancy: (M, N) -> (Mt, Nt) float32 0/1, 1 where the tile
    holds a nonzero.  (``kernels.dispatch.tile_occupancy`` is another
    function: the dispatch kernel's uint8 occupancy of 16x16 tiles.)"""
    return (block_counts(x, tile) > 0).to(torch.float32)


def block_tile_density(x: torch.Tensor, block: Tuple[int, int],
                       tile: Tuple[int, int]) -> torch.Tensor:
    """Fraction of nonzero (tile x tile) sub-tiles inside each block: the
    beta the TPU cost model plans from.  Counted through ``tile_nnz`` on a
    CUDA tensor."""
    occ = tile_occupancy(x, tile)                        # (Mt, Nt) 0/1
    bm, bn = block[0] // tile[0], block[1] // tile[1]
    return block_density_from_mask(occ, (bm, bn))


def block_density_from_mask(mask: torch.Tensor, block: Tuple[int, int]
                            ) -> torch.Tensor:
    """Mean of a float32 0/1 mask over each (bm, bn) block, zero-padded at
    ragged edges.  The sum of the block is exact; it is then multiplied by
    the float32 reciprocal of ``bm * bn``, which is how the reference's
    compiled mean divides (a true division rounds differently when
    ``bm * bn`` is not a power of two)."""
    m, n = mask.shape
    bm, bn = block
    pm, pn = (-m) % bm, (-n) % bn
    if pm or pn:
        mask = F.pad(mask, (0, pn, 0, pm))
    mb, nb = mask.shape[0] // bm, mask.shape[1] // bn
    total = mask.reshape(mb, bm, nb, bn).sum(dim=(1, 3))
    return total * float(np.float32(1.0) / np.float32(bm * bn))


@dataclasses.dataclass
class BlockProfile:
    """A propagated block-sparsity profile (counts, not densities).

    The fused executor threads these between layers: a producer emits
    counts at (N2, N2) at writeback and each consumer pools them to its own
    granularity with integer sums, bitwise equal to direct profiling.
    """

    counts: torch.Tensor            # (Mb, Nb) int32 nonzero counts per block
    shape: Tuple[int, int]          # unpadded (m, n) of the profiled tensor
    block: Tuple[int, int]          # (bm, bn) granularity of ``counts``

    @classmethod
    def measure(cls, x: torch.Tensor, block: Tuple[int, int]
                ) -> "BlockProfile":
        return cls(block_counts(x, block), tuple(x.shape), tuple(block))

    def densities(self) -> torch.Tensor:
        return density_from_counts(self.counts, *self.shape, *self.block)

    def pool_rows(self, r: int) -> "BlockProfile":
        """Merge ``r`` row blocks at a time: (N2, N2) -> (r*N2, N2)."""
        if r <= 1:
            return self
        c = self.counts
        pad = (-c.shape[0]) % r
        if pad:
            c = F.pad(c, (0, 0, 0, pad))
        pooled = c.reshape(-1, r, c.shape[1]).sum(dim=1, dtype=torch.int32)
        return BlockProfile(pooled, self.shape,
                            (self.block[0] * r, self.block[1]))

    def pool_cols(self, r: int) -> "BlockProfile":
        """Merge ``r`` column blocks at a time: (bm, N2) -> (bm, r*N2)."""
        if r <= 1:
            return self
        c = self.counts
        pad = (-c.shape[1]) % r
        if pad:
            c = F.pad(c, (0, pad))
        pooled = c.reshape(c.shape[0], -1, r).sum(dim=2, dtype=torch.int32)
        return BlockProfile(pooled, self.shape,
                            (self.block[0], self.block[1] * r))


@dataclasses.dataclass
class SparsityStats:
    """Host-side summary for one matrix (what the soft processor caches)."""

    shape: Tuple[int, int]
    block: Tuple[int, int]
    density: float                  # whole-matrix element density
    block_densities: np.ndarray     # (Mb, Nb) element densities per partition

    @classmethod
    def measure(cls, x, block: Tuple[int, int]) -> "SparsityStats":
        """Profile on the tensor's own device; numpy input runs on the CPU."""
        t = torch.as_tensor(x)
        bd = block_density(t, block).cpu().numpy()
        return cls(shape=tuple(t.shape), block=tuple(block),
                   density=float(element_density(t)), block_densities=bd)

    @classmethod
    def from_predicted(cls, shape, block, block_densities
                       ) -> "SparsityStats":
        """Stats from predicted (host numpy) block densities: the cost
        simulator's generated and propagated statistics."""
        bd = np.asarray(block_densities)
        return cls(shape=tuple(shape), block=tuple(block),
                   density=float(bd.mean()), block_densities=bd)
