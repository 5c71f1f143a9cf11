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


def _pad2(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    m, n = x.shape
    pm, pn = (-m) % bm, (-n) % bn
    return F.pad(x, (0, pn, 0, pm)) if (pm or pn) else x


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
    """Per-block NONZERO COUNTS.  (M, N) -> (Mb, Nb) int32."""
    bm, bn = block
    xp = _pad2(x, bm, bn)
    mb, nb = xp.shape[0] // bm, xp.shape[1] // bn
    nz = (xp != 0).reshape(mb, bm, nb, bn)
    return nz.sum(dim=(1, 3), dtype=torch.int32)


def block_density(x: torch.Tensor, block: Tuple[int, int]) -> torch.Tensor:
    """Per-block element density.  (M, N) -> (Mb, Nb) in [0, 1]."""
    m, n = x.shape
    return density_from_counts(block_counts(x, block), m, n, *block)


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
