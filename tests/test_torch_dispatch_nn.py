"""The float32 training forward on the tiled route
(``dispatch.block_matmul_nn``: ``csrc/dispatch_bwd_f32.cu`` in its ``nn``
layout) on the CPU.

* the ``nn`` layout's walk (``dispatch_bwd._walk``: codes[i, j, k] at
  rs = J * K, cs = K, ts = 1) and its launch shape
  (``bwd_launch_f32("nn", ...)``): tiles of min(128, edge), each inside
  one output block, every tile taken once, whole k-blocks, CTAs with
  equal shares; ``tile_walk`` lists exactly each tile's non-SKIP k, at
  every edge triple of ``EDGES`` with ragged m and n;
* the route rule: ``BlockMatmulFn``'s forward takes ``block_matmul_nn``
  for float32 at every ``EDGES`` triple, the walk (``block_matmul``) for
  bf16 and at smaller edges; the GNN path's ``dynasparse_matmul`` without
  a gradient never takes it;
* the forward against the reference's ``dynasparse_matmul`` on grids that
  hold SKIP, GEMM, SPDMM and SPMM codes, within 3e-4, and bitwise the
  walk's plain version;
* the wrapper's refusals (checked before any launch, so they run here on
  tensors that only claim to be on the card).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynasparse as j_dyn
from repro_torch.core import dynasparse
from repro_torch.kernels import dispatch, dispatch_bwd

EDGES = dispatch_bwd.EDGES
TRIPLES = list(itertools.product(EDGES, repeat=3))


def _grid(m, k, n, block, seed, p_skip=0.5):
    """A random (I, J, K) grid of SKIP, GEMM, SPDMM and SPMM codes."""
    bm, bk, bn = block
    grid = (-(-m // bm), -(-n // bn), -(-k // bk))
    rng = np.random.default_rng(seed)
    codes = rng.integers(1, 4, size=grid).astype(np.int32)
    codes[rng.random(grid) < p_skip] = 0
    return codes


@pytest.mark.parametrize("block", TRIPLES)
def test_nn_walk_and_launch_shape(block):
    bm, bk, bn = block
    m, k, n = 2 * bm + 37, 2 * bk + 64, 2 * bn - 20      # ragged m and n
    codes = _grid(m, k, n, block, sum(block))
    I, J, K = codes.shape
    assert dispatch_bwd._walk("nn", codes.shape, block) == (
        bm, bn, bk, K, J * K, K, 1)
    s = dispatch_bwd.bwd_launch_f32("nn", m, n, codes.shape, block)
    assert (s.tile_m, s.tile_n) == (min(128, bm), min(128, bn))
    assert (s.depth, s.steps) == (bk, K)
    assert s.row_tiles * s.tile_m >= m > (s.row_tiles - 1) * s.tile_m
    assert s.col_tiles * s.tile_n >= n > (s.col_tiles - 1) * s.tile_n
    tiles = s.row_tiles * s.col_tiles
    order = [s.tile_rc(t) for t in range(tiles)]
    assert sorted(order) == list(itertools.product(range(s.row_tiles),
                                                   range(s.col_tiles)))
    per = -(-tiles // s.ctas)
    assert s.ctas <= 132 and (s.ctas - 1) * per < tiles <= s.ctas * per
    walks = dispatch_bwd.tile_walk(torch.from_numpy(codes), s)
    for t, (tr, tc) in enumerate(order):
        # the tile lies inside one output block: its first and last rows
        # and columns are in the block tile_block names
        i, j = s.tile_block(t)
        assert tr * s.tile_m // bm == ((tr + 1) * s.tile_m - 1) // bm == i
        assert tc * s.tile_n // bn == ((tc + 1) * s.tile_n - 1) // bn == j
        assert walks[t] == [kb for kb in range(K) if codes[i, j, kb] != 0]


def _spy_forward(monkeypatch, run=True):
    """Record which forward entry is called; ``run=False`` returns zeros
    of the result's shape in place of the product."""
    calls = []
    for name in ("block_matmul", "block_matmul_nn"):
        def spy(x, y, *a, _real=getattr(dispatch, name), _name=name, **kw):
            calls.append(_name)
            if run:
                return _real(x, y, *a, **kw)
            return torch.zeros((x.shape[0], y.shape[1]))

        monkeypatch.setattr(dispatch, name, spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_route_at_every_edge_triple(monkeypatch, dtype):
    """float32 takes ``block_matmul_nn`` exactly when every edge is in
    EDGES; bf16 always takes the walk."""
    calls = _spy_forward(monkeypatch, run=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(40, 70)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(70, 50)).astype(np.float32))
    for block in itertools.product((16, 32) + EDGES, repeat=3):
        codes = torch.ones((-(-40 // block[0]), -(-50 // block[2]),
                            -(-70 // block[1])), dtype=torch.int32)
        calls.clear()
        xs = x.to(dtype).requires_grad_()
        out = dynasparse.BlockMatmulFn.apply(xs, y.to(dtype), codes, block)
        tiled = dtype == torch.float32 and all(e in EDGES for e in block)
        assert calls == ["block_matmul_nn" if tiled else "block_matmul"]
        assert out.shape == (40, 50) and out.dtype == torch.float32


def test_gnn_path_without_grad_keeps_the_walk(monkeypatch):
    """``dynasparse_matmul`` in float32 at (64, 64, 64): the walk without a
    gradient (the GNN path), ``block_matmul_nn`` inside the Function when
    one is wanted; the two results are equal bitwise."""
    calls = _spy_forward(monkeypatch)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(130, 150)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(150, 70)).astype(np.float32))
    block = (64, 64, 64)
    walk = dynasparse.dynasparse_matmul(x, y, block=block).out
    assert calls == ["block_matmul"] and walk.grad_fn is None
    calls.clear()
    tiled = dynasparse.dynasparse_matmul(x.clone().requires_grad_(), y,
                                         block=block).out
    assert calls == ["block_matmul_nn"] and tiled.grad_fn is not None
    assert torch.equal(tiled.detach(), walk)


@pytest.mark.parametrize("shape,block", [
    ((300, 320, 400), (128, 64, 256)),       # ragged m, k and n
    ((300, 512, 520), (256, 256, 256))])     # the LM's block, narrow
def test_forward_is_the_reference_block_walk(shape, block):
    """``block_matmul_nn`` against the reference's block walk on the same
    grid of SKIP, GEMM, SPDMM and SPMM codes (x with zero tiles, so that
    the sparse codes skip something): within 3e-4 of the largest |want|;
    bitwise the walk's plain version, cut to (m, n)."""
    m, k, n = shape
    codes = _grid(m, k, n, block, m + n, p_skip=0.3)
    assert {0, 1, 2, 3} <= set(np.unique(codes))
    rng = np.random.default_rng(m)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x *= rng.random((m, k)) < 0.7
    x[:16, :64] = 0
    y = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    want = np.asarray(j_dyn.dynasparse_matmul(
        jnp.asarray(x), jnp.asarray(y), codes=jnp.asarray(codes),
        block=block).out)
    tc = torch.from_numpy(codes)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = dispatch.block_matmul_nn(tx, ty, tc, block)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= 3e-4, err
    walk = dispatch.block_matmul_plain(tx, ty, tc, block, pad_rows=False)
    assert torch.equal(got, walk[:m, :n])


class _OnCard:
    """A tensor stand-in that claims to lie on the card: the wrapper's
    checks run before anything is launched."""

    def __init__(self, t, ptr=256, stride=None):
        self._t, self._ptr = t, ptr
        self._stride = stride or t.stride()
        self.is_cuda = True
        self.device = torch.device("cuda")
        self.dtype, self.shape = t.dtype, t.shape
        self.requires_grad = False

    def dim(self):
        return self._t.dim()

    def stride(self, i=None):
        return self._stride if i is None else self._stride[i]

    def data_ptr(self):
        return self._ptr

    def is_contiguous(self):
        return self._stride == self._t.stride()


@pytest.mark.parametrize("case,match", [
    ("bf16", "block_matmul_nn x: expected a CUDA float32 matrix"),
    ("mixed types", "block_matmul_nn y: expected a CUDA float32 matrix"),
    ("x on the CPU", "block_matmul_nn x: expected a CUDA float32 matrix"),
    ("unaligned base", "16-byte aligned"),
    ("odd row stride", "16-byte aligned"),
    ("column stride", "unit column stride"),
    ("block edge 32", "not supported by the kernel"),
    ("codes int64", "block_matmul_nn codes"),
    ("shape", "do not fit codes"),
    ("grad", "no backward")])
def test_the_forward_wrapper_refuses(case, match):
    block = (64, 64, 64)
    x = torch.zeros((128, 64), dtype=torch.float32)
    y = torch.zeros((64, 196), dtype=torch.float32)
    codes = torch.zeros((2, 4, 1), dtype=torch.int32)
    a, b, c = _OnCard(x), _OnCard(y), _OnCard(codes)
    if case == "bf16":
        a, b = _OnCard(x.bfloat16()), _OnCard(y.bfloat16())
    elif case == "mixed types":
        b = _OnCard(y.bfloat16())
    elif case == "x on the CPU":
        a = x
    elif case == "unaligned base":
        b = _OnCard(y, ptr=260)
    elif case == "odd row stride":
        b = _OnCard(y, stride=(198, 1))
    elif case == "column stride":
        a = _OnCard(x, stride=(1, 128))
    elif case == "block edge 32":
        block = (64, 32, 64)
    elif case == "codes int64":
        c = _OnCard(codes.long())
    elif case == "shape":
        c = _OnCard(torch.zeros((1, 4, 1), dtype=torch.int32))
    elif case == "grad":
        a.requires_grad = True
    ctx = torch.enable_grad() if case == "grad" else torch.no_grad()
    with ctx, pytest.raises(ValueError, match=match):
        dispatch.block_matmul_nn(a, b, c, block)
    assert dispatch.launches == 0
