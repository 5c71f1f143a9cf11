"""The masked ``dispatch`` VJP (``kernels/dispatch_bwd.py``, bf16 and
float32 routes) on the CPU.

* ``block_matmul_nt_plain`` (dx) and ``block_matmul_tn_plain`` (dw)
  against ``jax.value_and_grad`` of the reference's
  ``dynasparse_matmul``, zero blocks planted in x and w: float32 within
  3e-4, bf16 within 5e-2 of the largest gradient; dx and dw exactly 0 in
  every block whose steps were all SKIPped;
* bitwise the previous route: ``dispatch.block_matmul_plain`` over the
  permuted GEMM/SKIP grids, cut and cast;
* the launch shapes (``bwd_launch``, ``bwd_launch_f32``): tiles inside
  one output block, every tile taken once in the kernel's order, whole
  contraction blocks, CTAs with equal shares; the walk (``tile_walk``)
  against a brute-force numpy walk of the code grid;
* the route rule (``takes``) and ``BlockMatmulFn``'s choice of route;
* the CUDA wrapper's refusals (checked before any launch, so they run
  here on tensors that only claim to be on the card).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynasparse as j_dyn
from repro.core.perf_model import TPUCostModel as JTPUCostModel
from repro_torch.core import dynasparse
from repro_torch.core.perf_model import TPUCostModel
from repro_torch.kernels import dispatch, dispatch_bwd

CASES = [((512, 512, 768), (256, 256, 256)),     # LM block, narrow
         ((300, 320, 400), (128, 64, 256)),      # ragged m, k and n
         ((130, 192, 200), (64, 64, 128))]


def _operands(m, k, n, block, seed):
    """x (m, k) and w (k, n) with zero blocks planted so that whole output
    blocks of dx and dw have every step SKIPped; g (m, n)."""
    bm, bk, bn = block
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    x[:bm, bk:2 * bk] = 0
    w[:bk, bn:2 * bn] = 0
    return x, w, g


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("shape,block", CASES)
def test_plain_versions_are_the_reference_masked_vjp(dtype, tol, shape,
                                                     block):
    x, w, g = _operands(*shape, block, 3)
    bm, bk, bn = block
    jdt = getattr(jnp, dtype)

    def ref(x_, w_):
        r = j_dyn.dynasparse_matmul(x_, w_, strategy="dynamic", block=block,
                                    cost_model=JTPUCostModel())
        return jnp.sum(r.out.astype(jnp.float32) * jnp.asarray(g)), r.codes

    (_, jcodes), (jgx, jgw) = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(jnp.asarray(x, jdt),
                                          jnp.asarray(w, jdt))
    tdt = getattr(torch, dtype)
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    tg = torch.from_numpy(g).to(tdt)
    codes = torch.from_numpy(np.array(jcodes))
    dx = dispatch_bwd.block_matmul_nt(tg, tw, codes, block)
    dw = dispatch_bwd.block_matmul_tn(tx, tg, codes, block)
    assert dx.dtype == dw.dtype == tdt
    assert dx.shape == tx.shape and dw.shape == tw.shape
    for got, want in ((dx, jgx), (dw, jgw)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, err
    # every step of x's block (0, 1) and of w's block (0, 1) SKIPped
    c = np.asarray(jcodes)
    assert np.all(c[0, :, 1] == 0) and np.all(c[:, 1, 0] == 0)
    assert np.all(dx.float().numpy()[:bm, bk:2 * bk] == 0)
    assert np.all(dw.float().numpy()[:bk, bn:2 * bn] == 0)
    assert np.abs((g @ w.T)[:bm, bk:2 * bk]).max() > 1.0


@pytest.mark.parametrize("layout", ["nt", "tn"])
@pytest.mark.parametrize("shape,block", CASES)
def test_skipped_output_blocks_are_exactly_zero(layout, shape, block):
    """Random grids with SKIP codes: every output block whose contraction
    steps were all SKIPped is +0.0 bitwise, the others are not."""
    m, k, n = shape
    bm, bk, bn = block
    I, J, K = -(-m // bm), -(-n // bn), -(-k // bk)
    rng = np.random.default_rng(7)
    codes = rng.integers(1, 4, size=(I, J, K)).astype(np.int32)
    codes[rng.random((I, J, K)) < 0.4] = 0
    if layout == "nt":
        codes[0, :, K - 1] = 0
        a = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
        out = dispatch_bwd.block_matmul_nt(a, b, torch.from_numpy(codes),
                                           block)
        dead = (codes != 0).sum(1) == 0                      # (I, K)
        edges = (bm, bk)
    else:
        codes[:, J - 1, 0] = 0
        a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32))
        out = dispatch_bwd.block_matmul_tn(a, b, torch.from_numpy(codes),
                                           block)
        dead = ((codes != 0).sum(0) == 0).T                  # (K, J)
        edges = (bk, bn)
    o = out.numpy()
    for r, c in itertools.product(*map(range, dead.shape)):
        blk = o[r * edges[0]:(r + 1) * edges[0],
                c * edges[1]:(c + 1) * edges[1]]
        if dead[r, c]:
            assert np.all(blk == 0) and not np.signbit(blk).any()
        else:
            assert np.abs(blk).max() > 0
    assert dead.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,block", CASES)
def test_bitwise_the_dispatch_route_over_permuted_grids(dtype, shape,
                                                        block):
    """The plain versions read the forward's grid in place and equal, bit
    for bit, what the previous backward computed: ``block_matmul_plain``
    on the transposed operands over the permuted GEMM/SKIP grids, cut to
    the operand's shape and cast to its type."""
    m, k, n = shape
    bm, bk, bn = block
    I, J, K = -(-m // bm), -(-n // bn), -(-k // bk)
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(I, J, K)).astype(np.int32)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dtype)
    codes = torch.from_numpy(codes)
    run = torch.where(codes != 0, 1, 0).to(torch.int32)
    want_dx = dispatch.block_matmul_plain(
        g, w.T, run.permute(0, 2, 1).contiguous(), (bm, bn, bk),
        pad_rows=False)[:m, :k].to(dtype)
    want_dw = dispatch.block_matmul_plain(
        x.T, g, run.permute(2, 1, 0).contiguous(), (bk, bm, bn),
        pad_rows=False)[:k, :n].to(dtype)
    assert torch.equal(dispatch_bwd.block_matmul_nt(g, w, codes, block),
                       want_dx)
    assert torch.equal(dispatch_bwd.block_matmul_tn(x, g, codes, block),
                       want_dw)
    # float32 sums, unrounded, on request
    f32 = dispatch_bwd.block_matmul_nt(g, w, codes, block,
                                       out_dtype=torch.float32)
    assert f32.dtype == torch.float32 and torch.equal(f32.to(dtype),
                                                      want_dx)


GRIDS = [("nt", 2048, 2048, (8, 32, 8), (256, 256, 256)),
         ("tn", 2048, 8192, (8, 32, 8), (256, 256, 256)),
         ("nt", 2048, 8192, (8, 8, 32), (256, 256, 256)),
         ("tn", 8192, 2048, (8, 8, 32), (256, 256, 256)),
         ("nt", 300, 320, (3, 2, 5), (128, 64, 256)),
         ("tn", 320, 400, (3, 2, 5), (128, 64, 256)),
         ("nt", 130, 192, (3, 2, 3), (64, 64, 128)),
         ("tn", 192, 200, (3, 2, 3), (64, 64, 128)),
         ("nt", 2048, 2048, (8, 43, 8), (256, 256, 256)),
         ("tn", 2048, 10944, (8, 43, 8), (256, 256, 256)),
         ("nt", 40, 64, (1, 2, 1), (64, 64, 64)),
         ("tn", 512, 768, (8, 12, 8), (64, 64, 64))]


@pytest.mark.parametrize("layout,rows,cols,grid,block", GRIDS)
def test_tile_schedule_and_walk_against_a_brute_force_walk(layout, rows,
                                                           cols, grid, block):
    s = dispatch_bwd.bwd_launch(layout, rows, cols, grid, block)
    bm, bk, bn = block
    row_edge, col_edge = (bm, bk) if layout == "nt" else (bk, bn)
    assert (s.row_edge, s.col_edge) == (row_edge, col_edge)
    # a tile never crosses an output block, the tiles cover the output
    assert row_edge % s.tile_m == 0 and col_edge % s.tile_n == 0
    assert (s.tile_m, s.tile_n) == ((128, 256) if row_edge >= 128
                                    and col_edge == 256
                                    else (64, min(col_edge, 128)))
    assert s.row_tiles * s.tile_m >= rows > (s.row_tiles - 1) * s.tile_m
    assert s.col_tiles * s.tile_n >= cols > (s.col_tiles - 1) * s.tile_n
    tiles = s.row_tiles * s.col_tiles
    order = [s.tile_rc(t) for t in range(tiles)]
    assert sorted(order) == list(itertools.product(range(s.row_tiles),
                                                   range(s.col_tiles)))
    # the CTAs: at most one per SM, each the same number of tiles
    per = -(-tiles // s.ctas)
    assert s.ctas <= 132 and (s.ctas - 1) * per < tiles <= s.ctas * per
    assert per == -(-tiles // 132)
    rng = np.random.default_rng(rows + cols)
    codes = rng.integers(0, 4, size=grid).astype(np.int32)
    codes[rng.random(grid) < 0.5] = 0
    walks = dispatch_bwd.tile_walk(torch.from_numpy(codes), s)
    I, J, K = grid
    assert s.steps == (J if layout == "nt" else I)
    assert s.depth == (bn if layout == "nt" else bm)
    for t, (tr, tc) in enumerate(order):
        r, c = tr * s.tile_m // row_edge, tc * s.tile_n // col_edge
        if layout == "nt":     # dx block (i, k): the j with a step
            want = [j for j in range(J) if codes[r, j, c] != 0]
        else:                  # dw block (k, j): the i with a step
            want = [i for i in range(I) if codes[i, c, r] != 0]
        assert walks[t] == want


def test_tiles_in_flight_share_operands():
    """The first 128 of a 16 x 32 tile grid form an 8 x 16 block (groups
    of 8 tile rows), not 4 rows of 32."""
    s = dispatch_bwd.bwd_launch("tn", 2048, 8192, (8, 32, 8),
                                (256, 256, 256))
    assert (s.row_tiles, s.col_tiles, s.ctas) == (16, 32, 128)
    first = {s.tile_rc(t) for t in range(s.ctas)}
    assert first == set(itertools.product(range(8), range(16)))


@pytest.mark.parametrize("dtype,block,want", [
    (torch.bfloat16, (256, 256, 256), True),
    (torch.bfloat16, (64, 128, 256), True),
    (torch.bfloat16, (64, 64, 64), True),
    (torch.bfloat16, (32, 64, 64), False),
    (torch.bfloat16, (64, 16, 64), False),
    (torch.bfloat16, (128, 128, 32), False),
    (torch.float32, (256, 256, 256), True),
    (torch.float16, (256, 256, 256), False)])
def test_route_by_dtype_and_block(dtype, block, want):
    assert dispatch_bwd.takes(dtype, block) is want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16, torch.float64])
def test_route_at_every_edge_triple(dtype):
    """bf16 and float32 take the kernels exactly when every edge is in
    EDGES; any other type never does."""
    edges = (16, 32, 48, 64, 128, 256, 512)
    for block in itertools.product(edges, repeat=3):
        want = (dtype in (torch.bfloat16, torch.float32)
                and all(e in (64, 128, 256) for e in block))
        assert dispatch_bwd.takes(dtype, block) is want, block


@pytest.mark.parametrize("layout,rows,cols,grid,block", GRIDS)
def test_f32_tile_schedule_and_walk(layout, rows, cols, grid, block):
    """The float32 kernel's launch shape: tiles of min(128, edge), each
    inside one output block and taken once; whole contraction blocks (the
    block edge, one step per block: no reduction block is split); its
    walk lists exactly the active blocks, ascending, no SKIPped one."""
    s = dispatch_bwd.bwd_launch_f32(layout, rows, cols, grid, block)
    bm, bk, bn = block
    I, J, K = grid
    row_edge, col_edge = (bm, bk) if layout == "nt" else (bk, bn)
    assert (s.tile_m, s.tile_n) == (min(128, row_edge), min(128, col_edge))
    assert row_edge % s.tile_m == 0 and col_edge % s.tile_n == 0
    assert (s.depth, s.steps) == ((bn, J) if layout == "nt" else (bm, I))
    assert s.row_tiles * s.tile_m >= rows > (s.row_tiles - 1) * s.tile_m
    assert s.col_tiles * s.tile_n >= cols > (s.col_tiles - 1) * s.tile_n
    tiles = s.row_tiles * s.col_tiles
    order = [s.tile_rc(t) for t in range(tiles)]
    assert sorted(order) == list(itertools.product(range(s.row_tiles),
                                                   range(s.col_tiles)))
    per = -(-tiles // s.ctas)
    assert s.ctas <= 132 and (s.ctas - 1) * per < tiles <= s.ctas * per
    rng = np.random.default_rng(rows * cols)
    codes = rng.integers(0, 4, size=grid).astype(np.int32)
    codes[rng.random(grid) < 0.5] = 0
    walks = dispatch_bwd.tile_walk(torch.from_numpy(codes), s)
    for t, (tr, tc) in enumerate(order):
        r, c = tr * s.tile_m // row_edge, tc * s.tile_n // col_edge
        run = (codes[r, :, c] if layout == "nt" else codes[:, c, r]) != 0
        assert walks[t] == [i for i in range(s.steps) if run[i]]
        assert all(run[i] for i in walks[t])


@pytest.mark.parametrize("dtype,block,route", [
    ("bfloat16", (64, 64, 128), "dispatch_bwd"),
    ("bfloat16", (32, 32, 32), "dispatch"),
    ("float32", (64, 64, 128), "dispatch_bwd"),
    ("float32", (32, 32, 32), "dispatch"),
    ("float32", (16, 64, 128), "dispatch")])
def test_block_matmul_fn_takes_the_route(monkeypatch, dtype, block, route):
    """The Function's backward: dispatch_bwd's two products on bf16 and
    float32 grids with every edge in EDGES (the forward's codes, g cast
    once), else two dispatch launches over the permuted grids.  Its
    forward: ``block_matmul_nn`` in float32 at those edges, else the
    walk, ``block_matmul``."""
    x, w, g = _operands(130, 192, 200, block, 5)
    tdt = getattr(torch, dtype)
    calls = []
    for mod, names in ((dispatch, ["block_matmul", "block_matmul_nn"]),
                       (dispatch_bwd, ["block_matmul_nt",
                                       "block_matmul_tn"])):
        for name in names:
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=name, **kw):
                calls.append((_name, tuple(a[0].shape), a[0].dtype))
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, spy)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    res = dynasparse.dynasparse_matmul(tx, tw, strategy="dynamic",
                                       block=block,
                                       cost_model=TPUCostModel())
    (res.out.float() * torch.from_numpy(g)).sum().backward()
    names = [c[0] for c in calls]
    if route == "dispatch_bwd":
        forward = "block_matmul_nn" if dtype == "float32" else "block_matmul"
        assert names == [forward, "block_matmul_nt", "block_matmul_tn"]
        assert calls[1][1:] == ((130, 200), tdt)     # g, cast once
        assert calls[2][1:] == ((130, 192), tdt)     # x in place
    else:
        assert names == ["block_matmul"] * 3
    assert tx.grad.dtype == tw.grad.dtype == tdt


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
    ("float32 g", "expected a CUDA bf16 matrix"),
    ("unaligned base", "16-byte aligned"),
    ("odd row stride", "16-byte aligned"),
    ("column stride", "unit column stride"),
    ("block edge 32", "not supported by the kernel"),
    ("codes int64", "block_matmul_nt codes"),
    ("shape", "do not fit codes"),
    ("out float16", "out_dtype")])
def test_the_cuda_wrapper_refuses(case, match):
    block = (64, 64, 64)
    g = torch.zeros((128, 192), dtype=torch.bfloat16)
    w = torch.zeros((64, 192), dtype=torch.bfloat16)
    codes = torch.zeros((2, 3, 1), dtype=torch.int32)
    kw = {}
    a, b = _OnCard(g), _OnCard(w)
    c = _OnCard(codes)
    if case == "float32 g":
        a = _OnCard(g.float())
    elif case == "unaligned base":
        a = _OnCard(g, ptr=264)
    elif case == "odd row stride":
        a = _OnCard(g, stride=(196, 1))
    elif case == "column stride":
        b = _OnCard(w, stride=(1, 64))
    elif case == "block edge 32":
        block = (32, 64, 64)
    elif case == "codes int64":
        c = _OnCard(codes.long())
    elif case == "shape":
        c = _OnCard(torch.zeros((1, 3, 1), dtype=torch.int32))
    elif case == "out float16":
        kw = {"out_dtype": torch.float16}
    with pytest.raises(ValueError, match=match):
        dispatch_bwd.block_matmul_nt(a, b, c, block, **kw)


@pytest.mark.parametrize("case,match", [
    ("bf16 x", "expected a CUDA float32 matrix"),
    ("unaligned base", "16-byte aligned"),
    ("odd row stride", "16-byte aligned"),
    ("column stride", "unit column stride"),
    ("block edge 16", "not supported by the kernel"),
    ("codes int64", "block_matmul_tn codes"),
    ("shape", "do not fit codes"),
    ("out bf16", "out_dtype"),
    ("grad", "no backward")])
def test_the_cuda_wrapper_refuses_float32(case, match):
    """The float32 route (``g``'s type): x must match it, rows must be
    16-byte aligned (``cp.async``), the result float32."""
    block = (64, 64, 64)
    x = torch.zeros((128, 64), dtype=torch.float32)
    g = torch.zeros((128, 196), dtype=torch.float32)
    codes = torch.zeros((2, 4, 1), dtype=torch.int32)
    kw = {}
    a, b, c = _OnCard(x), _OnCard(g), _OnCard(codes)
    if case == "bf16 x":
        a = _OnCard(x.bfloat16())
    elif case == "unaligned base":
        b = _OnCard(g, ptr=260)
    elif case == "odd row stride":
        b = _OnCard(g, stride=(198, 1))
    elif case == "column stride":
        a = _OnCard(x, stride=(1, 128))
    elif case == "block edge 16":
        block = (64, 16, 64)
    elif case == "codes int64":
        c = _OnCard(codes.long())
    elif case == "shape":
        c = _OnCard(torch.zeros((1, 4, 1), dtype=torch.int32))
    elif case == "out bf16":
        kw = {"out_dtype": torch.bfloat16}
    elif case == "grad":
        b.requires_grad = True
    ctx = torch.enable_grad() if case == "grad" else torch.no_grad()
    with ctx, pytest.raises(ValueError, match=match):
        dispatch_bwd.block_matmul_tn(a, b, c, block, **kw)
