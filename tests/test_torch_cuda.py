"""The CUDA kernels against their plain PyTorch versions, on the card.

Imports neither jax nor the JAX package, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.  Without
a CUDA device every test skips (decided inside the fixture).
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro_torch.core import formats
from repro_torch.core.ir import KernelType
from repro_torch.core.perf_model import Primitive
from repro_torch.kernels import build, dispatch, ops

TOL = dict(atol=3e-4, rtol=3e-4)
# bf16 dispatch vs its plain version: both sum the same exact bf16 products
# in float32, so only the order of the float32 sums differs
MMA_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def sparse(seed, m, n, density, device):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n)).astype(np.float32)
    return torch.from_numpy(x * (rng.random((m, n)) < density)).to(device)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.6])
def test_cuda_kernels_match_plain(cuda, density):
    x = sparse(8, 100, 130, density, cuda)
    y = sparse(9, 130, 50, 0.4, cuda)
    want = (x.double() @ y.double()).float()
    K.reset_launch_counts()
    for prim in (Primitive.GEMM, Primitive.SPDMM, Primitive.SPMM):
        torch.testing.assert_close(ops.matmul(x, y, prim, tile=(16, 16)),
                                   want, **TOL)
    torch.testing.assert_close(ops.csr_spmm(x, y, rmax=130), want, **TOL)
    ell = formats.dense_to_ell(x, 16)
    torch.testing.assert_close(
        ops.csr_spmm(ell, y),
        ops.csr_spmm(formats.dense_to_ell(x.cpu(), 16), y.cpu()).to(cuda),
        **TOL)
    for block in ((16, 16, 16), (32, 32, 16), (64, 16, 32)):
        shape = (-(-100 // block[0]), -(-50 // block[2]), -(-130 // block[1]))
        codes = torch.randint(0, 4, shape, dtype=torch.int32, device=cuda)
        torch.testing.assert_close(
            dispatch.block_matmul(x, y, codes, block),
            dispatch.block_matmul_plain(x, y, codes, block), **TOL)
    launched = K.launch_counts()
    # (the float32 dispatch flags x's tiles inside its own C call, so these
    # products no longer launch tile_nnz; it has its own test below)
    assert all(launched[name] >= 1 for name in (
        "gemm", "spdmm", "spmm", "csr_spmm", "dispatch"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tile_nnz_kernel_is_exact(cuda, dtype):
    x = sparse(10, 700, 1500, 0.05, cuda).to(dtype)
    K.reset_launch_counts()
    for tile in ((16, 16), (64, 16), (256, 256), (48, 80), (1, 300),
                 (700, 1500)):
        got = K.profile.tile_nnz(x, tile)
        assert torch.equal(got, K.profile.tile_nnz_plain(x, tile)), tile
        strided = x[3:650, 5:1400]
        assert torch.equal(K.profile.tile_nnz(strided, tile),
                           K.profile.tile_nnz_plain(strided, tile)), tile
    assert int(K.profile.tile_nnz(x, (64, 16)).sum()) == int(
        torch.count_nonzero(x))
    assert K.launch_counts()["tile_nnz"] == 13


@pytest.mark.parametrize("hkv", [2, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,sq,skv,bq,bk", [
    (True, 128, 128, 128, 128), (True, 40, 40, 16, 16),
    (False, 64, 128, 64, 128), (True, 80, 48, 16, 16),
    (True, 48, 40, 16, 8), (True, 300, 300, 128, 128)])
def test_flash_attention_kernel_matches_plain(cuda, d, causal, sq, skv, bq,
                                              bk, hkv):
    g = torch.Generator(device=cuda)
    g.manual_seed(d + sq)
    q = torch.randn((2, 8, sq, d), generator=g, device=cuda)
    k = torch.randn((2, hkv, skv, d), generator=g, device=cuda)
    v = torch.randn((2, hkv, skv, d), generator=g, device=cuda)
    kw = dict(causal=causal, bq=bq, bk=bk)
    K.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    bf = ops.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), **kw)
    torch.testing.assert_close(
        bf.float().cpu(), ops.flash_attention(
            q.bfloat16().cpu(), k.bfloat16().cpu(), v.bfloat16().cpu(),
            **kw).float(), atol=1e-2, rtol=1e-2)
    assert K.launch_counts()["flash_attention"] == 2


@pytest.mark.parametrize("block", [(256, 256, 256), (128, 64, 256),
                                   (256, 32, 32), (64, 16, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_large_blocks_and_bf16(cuda, block, dtype):
    x = sparse(11, 300, 520, 0.3, cuda).to(dtype)
    y = sparse(12, 520, 600, 0.1, cuda).to(dtype)
    shape = (-(-300 // block[0]), -(-600 // block[2]), -(-520 // block[1]))
    codes = torch.randint(0, 4, shape, dtype=torch.int32, device=cuda)
    tol = TOL if dtype == torch.float32 else MMA_TOL
    torch.testing.assert_close(
        dispatch.block_matmul(x, y, codes, block),
        dispatch.block_matmul_plain(x, y, codes, block), **tol)


def test_lm_smoke_dynasparse_serving_equals_dense(cuda):
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import prune_ffn
    from repro_torch.models import model_zoo
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = smoke_config("llama3.2-1b", n_layers=2)
    dense = model_zoo.build(cfg)
    params = prune_ffn(dense.init_params(0), 0.1, period=cfg.layer_period)
    sparse_b = model_zoo.build(dataclasses.replace(cfg, dynasparse_ffn=True))
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                    max_new_tokens=4, request_id=i) for i in range(2)]
    K.reset_launch_counts()
    r_ds = ServeEngine(sparse_b, params, slots=2, max_seq=16).generate(reqs)
    assert K.launch_counts()["dispatch"] > 0
    assert K.launch_counts()["tile_nnz"] > 0
    r_dense = ServeEngine(dense, params, slots=2, max_seq=16).generate(reqs)
    for a, b in zip(r_ds, r_dense):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_flash_attention_bf16_raises_on_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 16, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, causal=True)          # D = 48
    flat = torch.zeros(1 + 2 * 16 * 64, dtype=torch.bfloat16, device=cuda)
    odd = flat[1:].view(1, 2, 16, 64)                       # 2-byte offset
    with pytest.raises(ValueError):
        K.flash_attention.flash_attention(odd, odd, odd, bq=16, bk=16)


@pytest.mark.parametrize("m", [1, 4, 17, 300])
@pytest.mark.parametrize("block", [(256, 256, 256), (128, 64, 256),
                                   (32, 48, 64)])
def test_dispatch_bf16_decode_rows_and_split_k(cuda, m, block):
    bm, bk, bn = block
    x = sparse(13, m, 1000, 0.5, cuda).bfloat16()
    y = sparse(14, 1000, 700, 0.1, cuda).bfloat16()
    shape = (-(-m // bm), -(-700 // bn), -(-1000 // bk))
    codes = torch.randint(0, 4, shape, dtype=torch.int32, device=cuda)
    want = dispatch.block_matmul_plain(x, y, codes, block)
    K.reset_launch_counts()
    got = dispatch.block_matmul(x, y, codes, block)
    torch.testing.assert_close(got, want, **MMA_TOL)
    assert K.launch_counts()["dispatch"] == 1
    assert not got[m:].any()                 # padded rows stay zero
    # x's rows only, as the FFN calls it: the same values, no padding rows
    rows = dispatch.block_matmul(x, y, codes, block, pad_rows=False)
    assert rows.shape == (m, got.shape[1]) and torch.equal(rows, got[:m])
    # every element of a given out is written, and a rerun is bitwise equal
    out = torch.full_like(got, float("nan"))
    dispatch.block_matmul(x, y, codes, block, out=out)
    assert torch.equal(out, got)
    # the device flag skips the whole grid
    kept = torch.full_like(got, 7.0)
    flag = torch.ones((), dtype=torch.int32, device=cuda)
    dispatch.block_matmul(x, y, codes, block, out=kept, skip=flag)
    assert bool((kept == 7.0).all())


def test_dispatch_bf16_raises_on_misaligned_rows(cuda):
    flat = torch.zeros(1 + 64 * 64, dtype=torch.bfloat16, device=cuda)
    x = flat[1:].view(64, 64)                   # 2-byte offset
    y = torch.zeros((64, 64), dtype=torch.bfloat16, device=cuda)
    codes = torch.ones((1, 1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        dispatch.block_matmul(x, y, codes, (64, 64, 64))


@pytest.mark.parametrize("m,k,n,tile", [
    (1552, 80, 1552, 128),    # wide: 13 x 13 CTAs of 128, the last overhang
    (784, 48, 784, 16),       # 16 x 16: the 128 tile leaves too few CTAs
    (3328, 112, 16, 16),      # an Update's 16-wide output
    (16, 16, 16, 16),
    (48, 0, 32, 16)])         # k = 0: zeros
def test_gemm_tiles_match_plain(cuda, m, k, n, tile):
    assert K.gemm.gemm_launch(m, n, build.sm_count(cuda)) == tile
    x = sparse(15, m, k, 0.5, cuda)
    y = sparse(16, k, n, 0.5, cuda)
    K.reset_launch_counts()
    got = K.gemm.gemm(x, y)
    assert K.launch_counts()["gemm"] == 1
    torch.testing.assert_close(got, K.gemm.gemm_plain(x, y), **TOL)
    assert torch.equal(got, K.gemm.gemm(x, y))        # deterministic


@pytest.mark.parametrize("m,k,n,bm,bn", [(1552, 80, 1552, 64, 16),
                                         (784, 48, 784, 128, 256),
                                         (3328, 112, 16, 16, 16)])
def test_gemm_equals_one_k_block_all_gemm_dispatch(cuda, m, k, n, bm, bn):
    """One k-block makes each dispatch output one fmaf chain over k from
    0, then 0 + chain: the gemm kernel's value bit for bit."""
    x = sparse(17, m, k, 0.3, cuda)
    y = sparse(18, k, n, 0.6, cuda)
    codes = torch.ones((-(-m // bm), -(-n // bn), 1), dtype=torch.int32,
                       device=cuda)
    got = dispatch.block_matmul(x, y, codes, (bm, k, bn), pad_rows=False)
    assert torch.equal(K.gemm.gemm(x, y), got[:, :n])


def test_gemm_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros((32, 32), device=cuda)
    with pytest.raises(ValueError):
        K.gemm.gemm(x[:, :24], x[:24])                  # not multiples
    flat = torch.zeros(1 + 32 * 32, device=cuda)
    with pytest.raises(ValueError):                     # 4-byte offset
        K.gemm.gemm(flat[1:].view(32, 32), x)


@pytest.mark.parametrize("bk", [16, 48, 64, 528])
@pytest.mark.parametrize("bm,bn", [(16, 16), (32, 64), (64, 16), (128, 32),
                                   (256, 128), (16, 256), (256, 16)])
def test_dispatch_f32_every_block_edge(cuda, bm, bk, bn):
    """The float32 route against its plain version on random codes, with
    x and y read in place (ragged, unaligned rows), padded and rows-only;
    then the skip flag and a caller's out."""
    x = sparse(19, 333, 537, 0.05, cuda)
    y = sparse(20, 537, 301, 0.3, cuda)
    shape = (-(-333 // bm), -(-301 // bn), -(-537 // bk))
    g = torch.Generator(device=cuda)
    g.manual_seed(bm + bk + bn)
    codes = torch.randint(0, 4, shape, generator=g, dtype=torch.int32,
                          device=cuda)
    want = dispatch.block_matmul_plain(x, y, codes, (bm, bk, bn))
    K.reset_launch_counts()
    got = dispatch.block_matmul(x, y, codes, (bm, bk, bn))
    counts = K.launch_counts()
    assert counts == {**{n: 0 for n in counts}, "dispatch": 1}
    torch.testing.assert_close(got, want, **TOL)
    assert not got[333:].any()                  # padded rows are zeros
    rows = dispatch.block_matmul(x, y, codes, (bm, bk, bn), pad_rows=False)
    assert rows.shape == (333, got.shape[1]) and torch.equal(rows, got[:333])
    out = torch.full_like(got, float("nan"))   # every element is written
    dispatch.block_matmul(x, y, codes, (bm, bk, bn), out=out)
    assert torch.equal(out, got)
    kept = torch.full_like(got, 7.0)
    flag = torch.ones((), dtype=torch.int32, device=cuda)
    dispatch.block_matmul(x, y, codes, (bm, bk, bn), out=kept, skip=flag)
    assert bool((kept == 7.0).all())
    for fill in (0, 1):                         # all SKIP, all GEMM
        c = torch.full_like(codes, fill)
        torch.testing.assert_close(
            dispatch.block_matmul(x, y, c, (bm, bk, bn)),
            dispatch.block_matmul_plain(x, y, c, (bm, bk, bn)), **TOL)


def test_dispatch_f32_spmm_skips_only_zero_tiles(cuda):
    """SPMM and SPDMM give GEMM's value bit for bit when every skipped
    tile is zero: skipping drops only exact zeros, and the partials of
    each k-block add in the same order."""
    x = sparse(21, 256, 320, 0.01, cuda)
    y = sparse(22, 320, 128, 0.02, cuda)
    block = (64, 64, 16)
    shape = (4, 8, 5)
    runs = [dispatch.block_matmul(
        x, y, torch.full(shape, c, dtype=torch.int32, device=cuda), block)
        for c in (1, 2, 3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


# tile-row counts of the "ordered" case: empty and full first, then
# descending, tied and ascending (the kernels rank rows on the device,
# longest first)
ORDER_COUNTS = [0, 9, *range(9, 0, -1), *[5] * 10, *range(10), *[9] * 4]


def tile_sparse(seed, mb, kb, tile, device, occ="random"):
    """(mb * tm, kb * tk) float32 whose nonzero tiles hold about half
    nonzero elements: tile-row 0 empty, tile-row 1 full (its count equals
    smax = kb), about a third of the other tiles nonzero ("random");
    no tile nonzero ("empty"); or ORDER_COUNTS[i] tiles in tile-row i
    ("ordered", mb = len(ORDER_COUNTS))."""
    tm, tk = tile
    rng = np.random.default_rng(seed)
    if occ == "ordered":
        nz = np.zeros((mb, kb), dtype=bool)
        for i, c in enumerate(ORDER_COUNTS):
            nz[i, rng.permutation(kb)[:c]] = True
    else:
        nz = rng.random((mb, kb)) < 0.3
        nz[0], nz[1] = False, True
        nz &= occ != "empty"
    vals = rng.normal(size=(mb * tm, kb * tk)).astype(np.float32)
    vals *= rng.random(vals.shape) < 0.5
    mask = np.repeat(np.repeat(nz, tm, axis=0), tk, axis=1)
    return torch.from_numpy(vals * mask).to(device)


def poison(shape, device):
    """Leave NaN in the allocator's cache where the next output of
    ``shape`` is placed, so a row the kernel does not write shows."""
    torch.full(shape, float("nan"), device=device)


# n: the Updates' 16-wide output, three warp columns, a wide output with a
# partial 128-column strip, and H0's padded width
@pytest.mark.parametrize("n", [16, 48, 400, 3712])
@pytest.mark.parametrize("tile", [(16, 16), (32, 32)])
@pytest.mark.parametrize("occ", ["random", "empty", "ordered"])
def test_spdmm_equals_gemm_bitwise(cuda, n, tile, occ):
    """Each output is one fmaf chain over the nonzero tiles, k ascending,
    from 0: the dense gemm's value bit for bit (skipped tiles are zero),
    every row written once whatever order the device ranks."""
    tm, tk = tile
    mb, kb = (len(ORDER_COUNTS) if occ == "ordered" else 12), 9
    x = tile_sparse(23, mb, kb, tile, cuda, occ)
    y = sparse(24, kb * tk, n, 0.5, cuda)
    xb = formats.dense_to_bcsr(x, tile)
    assert int(xb.counts.max()) == (0 if occ == "empty" else kb)
    if occ == "ordered":
        assert xb.counts.tolist() == ORDER_COUNTS
    K.reset_launch_counts()
    poison((mb * tm, n), cuda)
    got = K.spdmm.spdmm(xb, y)
    assert K.launch_counts()["spdmm"] == 1
    assert K.spdmm.spdmm_launch(mb * tm, n, build.sm_count(cuda)).wide == (
        n >= 128)
    assert torch.equal(got, K.gemm.gemm(x, y))
    torch.testing.assert_close(got, K.spdmm.spdmm_plain(xb, y), **TOL)
    assert not got[:tm].any()                   # the empty tile-row


@pytest.mark.parametrize("n", [16, 48, 400, 3712])
@pytest.mark.parametrize("tile", [(16, 16), (32, 32)])
@pytest.mark.parametrize("occ", ["random", "empty", "ordered"])
def test_spmm_equals_gemm_bitwise(cuda, n, tile, occ):
    """The intersection walk skips only pairs with a zero side: the dense
    gemm's value bit for bit, every row written once."""
    tm, tk = tile
    mb, kb = (len(ORDER_COUNTS) if occ == "ordered" else 12), 9
    x = tile_sparse(25, mb, kb, tile, cuda, occ)
    nb = -(-n // tk)
    y = tile_sparse(26, kb, nb, (tk, tk), cuda)       # y's tile-row 0 empty
    yb = formats.dense_to_bcsc(y, (tk, tk))
    xb = formats.dense_to_bcsr(x, tile)
    plan = K.spmm.plan_intersection(xb, yb)
    K.reset_launch_counts()
    poison((mb * tm, nb * tk), cuda)
    got = K.spmm.spmm(xb, yb, plan)
    assert K.launch_counts()["spmm"] == 1
    assert torch.equal(got, K.gemm.gemm(x, y))
    torch.testing.assert_close(got, K.spmm.spmm_plain(xb, yb, plan), **TOL)


def test_sparse_kernels_raise_on_what_they_do_not_take(cuda):
    x = tile_sparse(27, 4, 3, (16, 16), cuda)
    y = sparse(28, 48, 32, 0.5, cuda)
    xb = formats.dense_to_bcsr(x, (16, 16))
    yb = formats.dense_to_bcsc(y, (16, 16))
    plan = K.spmm.plan_intersection(xb, yb)
    flat = torch.zeros(1 + y.numel(), device=cuda)
    odd_y = flat[1:].view(y.shape)                       # 4-byte offset
    bflat = torch.zeros(1 + xb.blocks.numel(), device=cuda)
    odd_x = formats.BlockCSRMatrix(xb.col_idx, xb.counts,
                                   bflat[1:].view(xb.blocks.shape),
                                   xb.shape, xb.tile)
    for bad in (lambda: K.spdmm.spdmm(xb, y.double()),   # dtypes
                lambda: K.spdmm.spdmm(formats.dense_to_bcsr(
                    x.bfloat16(), (16, 16)), y),
                lambda: K.spdmm.spdmm(xb, y[:, :24].contiguous()),  # n % 16
                lambda: K.spdmm.spdmm(xb, odd_y),         # misaligned
                lambda: K.spdmm.spdmm(odd_x, y),
                lambda: K.spmm.spmm(xb, yb, K.spmm.IntersectionPlan(
                    plan.xpos.long(), plan.ypos, plan.counts)),
                lambda: K.spmm.spmm(odd_x, yb, plan)):
        with pytest.raises(ValueError):
            bad()


def hub_sparse(seed, m, k, device):
    """A sparse (m, k) float32 matrix with an empty row 0, a hub row 5 of
    600 nonzeros (more than 512 slots) and about 1 % elsewhere."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    mask = rng.random((m, k)) < 0.01
    mask[0] = False
    mask[5] = False
    mask[5, rng.permutation(k)[:600]] = True
    return torch.from_numpy(x * mask).to(device)


@pytest.mark.parametrize("n", [1, 16, 17, 3703])
def test_csr_spmm_equals_gemm_bitwise(cuda, n):
    """Each output is one fmaf chain over the row's slots (ascending
    columns) from 0: the dense gemm's value bit for bit, every row (the
    empty one too) written once, the hub row on the heavy strips."""
    m, k = 300, 700
    x = hub_sparse(30, m, k, cuda)
    y = sparse(31, k, n, 0.9, cuda)
    ell = formats.dense_to_ell(x, 704)
    assert int(ell.row_counts.max()) == 600
    want = K.gemm.gemm(dispatch.pad_to(x, 16, 16).contiguous(),
                       dispatch.pad_to(y, 16, 16).contiguous())[:m, :n]
    out = torch.full((m, n), float("nan"), device=cuda)
    K.reset_launch_counts()
    got = K.csr_spmm.csr_spmm(ell.values, ell.cols, ell.row_counts, y,
                              out=out)
    assert K.launch_counts()["csr_spmm"] == 1
    assert torch.equal(got, want)
    assert not got[0].any()
    torch.testing.assert_close(
        got, K.csr_spmm.csr_spmm_plain(ell.values, ell.cols, ell.row_counts,
                                       y), **TOL)
    shape = K.csr_spmm.csr_launch(m, n, 704, build.sm_count(cuda))
    assert shape.heavy_rows == 48


def test_csr_spmm_run_flag_wide_out_and_caps(cuda):
    m, k, n = 200, 300, 40
    x = hub_sparse(32, m, k, cuda)
    y = sparse(33, k, n, 0.7, cuda)
    ell = formats.dense_to_ell(x, 128)       # the hub row is cut at 128
    want = K.csr_spmm.csr_spmm_plain(ell.values, ell.cols, ell.row_counts, y)
    # run = 0 leaves out as it was; run = 1 writes it
    kept = torch.full((m, n), 7.0, device=cuda)
    flag = torch.zeros((), dtype=torch.int32, device=cuda)
    K.csr_spmm.csr_spmm(ell.values, ell.cols, ell.row_counts, y, out=kept,
                        run=flag)
    assert bool((kept == 7.0).all())
    K.csr_spmm.csr_spmm(ell.values, ell.cols, ell.row_counts, y, out=kept,
                        run=flag + 1)
    torch.testing.assert_close(kept, want, **TOL)
    # ldo > n: only [:m, :n] of a wider, taller buffer is written
    wide = torch.full((m + 8, n + 24), float("nan"), device=cuda)
    K.csr_spmm.csr_spmm(ell.values, ell.cols, ell.row_counts, y, out=wide)
    assert torch.equal(wide[:m, :n], kept)
    assert bool(wide[m:].isnan().all()) and bool(wide[:, n:].isnan().all())
    # rmax = 0: every row writes 0
    z = formats.dense_to_ell(torch.zeros_like(x), 0)
    assert not K.csr_spmm.csr_spmm(z.values, z.cols, z.row_counts, y).any()
    for bad in (lambda: K.csr_spmm.csr_spmm(ell.values, ell.cols,
                                            ell.row_counts, y.bfloat16()),
                lambda: K.csr_spmm.csr_spmm(ell.values.double(), ell.cols,
                                            ell.row_counts, y.double())):
        with pytest.raises(ValueError):
            bad()


@pytest.mark.parametrize("n", [16, 17, 3703])
def test_csr_spmm_bf16_matches_plain(cuda, n):
    m, k = 300, 700
    x = hub_sparse(34, m, k, cuda).bfloat16()
    y = sparse(35, k, n, 0.9, cuda).bfloat16()
    ell = formats.dense_to_ell(x, 704)
    got = K.csr_spmm.csr_spmm(ell.values, ell.cols, ell.row_counts, y)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, K.csr_spmm.csr_spmm_plain(ell.values, ell.cols, ell.row_counts,
                                       y), atol=5e-2, rtol=5e-2)
    res = ops.csr_spmm(ell, y)
    assert res.dtype == torch.bfloat16


def small_ints(seed, m, n, density, device):
    """bf16 integers in [-4, 4] on a sparse mask: every product and partial
    sum is exact in float32, so the kernel and the plain version agree
    exactly whatever the order of their float32 sums, and a stale or
    skipped tile shows as a whole-number error."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, size=(m, n)) * (rng.random((m, n)) < density)
    return torch.from_numpy(x.astype(np.float32)).to(device).bfloat16()


@pytest.mark.parametrize("strategy", ["gemm", "s1", "s2"])
@pytest.mark.parametrize("block", [(16, 16, 16), (64, 64, 64)])
def test_bf16_static_strategies_run_on_dispatch(cuda, strategy, block):
    from repro_torch.core import dynasparse
    from repro_torch.core.ir import KernelType
    x = small_ints(36, 300, 520, 0.1, cuda)
    y = small_ints(37, 520, 200, 0.3, cuda)
    kw = dict(strategy=strategy, block=block,
              kernel_type=KernelType.AGGREGATE)
    K.reset_launch_counts()
    got = dynasparse.dynasparse_matmul(x, y, **kw)
    assert K.launch_counts()["dispatch"] == 1
    assert K.launch_counts()["gemm"] == K.launch_counts()["spdmm"] == 0
    want = dynasparse.dynasparse_matmul(x.cpu(), y.cpu(), **kw)
    assert got.out.dtype == torch.bfloat16
    torch.testing.assert_close(got.out.cpu().float(), want.out.float(),
                               **MMA_TOL)
    # the format-aware route in bf16: csr_spmm on the same operands
    fmt = torch.ones((), dtype=torch.int32, device=cuda)
    res = dynasparse.dynasparse_matmul(x, y, block=block, fmt=fmt,
                                       format_aware=True, csr_rmax=520)
    assert int(res.fmt) == 1 and res.out.dtype == torch.bfloat16
    torch.testing.assert_close(res.out.float(), want.out.float().to(cuda),
                               **MMA_TOL)


# -- GAT's masked edge-softmax ------------------------------------------------

FLIP_DIST = 1e-6      # a support flip further than this from the threshold
OUT_BLOCKS = [(16, 16), (32, 16), (128, 128), (16, 48)]
BF16_CASES = {"bf16 a": (torch.bfloat16, torch.float32),
              "bf16 z": (torch.float32, torch.bfloat16),
              "bf16 a and z": (torch.bfloat16, torch.bfloat16)}


def attention_operands(seed, n, f, density, device):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < density).astype(np.float32)
    z = rng.normal(size=(n, f)).astype(np.float32)
    att = rng.normal(size=(2, f, 1)).astype(np.float32)
    return [torch.from_numpy(v).to(device) for v in (a, z, att[0], att[1])]


def assert_within_one_bf16_step(got, want):
    """|got - want| at most one bf16 step of ``want`` (its spacing at
    ``want``'s binade) wherever both are nonzero."""
    both = (got != 0) & (want != 0)
    g, w = got.float()[both], want.float()[both]
    step = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    assert bool(((g - w).abs() <= step).all()), float((g - w).abs().max())


def assert_edge_softmax_matches_plain(a, z, asrc, adst, threshold,
                                      out_block=(16, 16)):
    """alpha within 3e-4 of the plain version (one bf16 step where alpha
    is bf16); any support flip within 1e-6 of the threshold; the kernel's
    counts equal ``tile_nnz`` of its own alpha exactly, and the plain
    version's where no entry flipped."""
    before = K.edge_softmax.launches
    got, counts = K.edge_softmax.edge_softmax(a, z, asrc, adst,
                                              threshold=threshold,
                                              out_block=out_block)
    want, want_counts = K.edge_softmax.edge_softmax_plain(
        a, z, asrc, adst, threshold=threshold, out_block=out_block)
    assert K.edge_softmax.launches == before + 1
    assert got.dtype == want.dtype == torch.promote_types(a.dtype, z.dtype)
    flips, dist = K.edge_softmax.support_flips(got, want, threshold)
    assert dist <= FLIP_DIST, (flips, dist)
    if got.dtype == torch.bfloat16:
        assert_within_one_bf16_step(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)
    assert counts.dtype == torch.int32
    assert torch.equal(counts, K.profile.tile_nnz(got, out_block))
    if flips == 0:
        assert torch.equal(counts, want_counts)
    assert not torch.isnan(got).any()
    empty = a.float().sum(dim=1) == 0
    assert not got[empty].any()
    return got


@pytest.mark.parametrize("threshold", [0.0, 0.02, 0.6])
@pytest.mark.parametrize("n", [1, 31, 40, 1000, 3327])
def test_edge_softmax_matches_plain(cuda, n, threshold):
    a, z, asrc, adst = attention_operands(n, n, 16, min(1.0, 8.0 / n),
                                          cuda)
    a[n // 2] = 0.0                                   # an all-zero row
    got = assert_edge_softmax_matches_plain(a, z, asrc, adst, threshold)
    if threshold == 0.0:
        live = a.sum(dim=1) > 0
        torch.testing.assert_close(got[live].sum(dim=1),
                                   torch.ones_like(got[live, 0]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("out_block", OUT_BLOCKS)
@pytest.mark.parametrize("n", [1, 31, 40, 1000, 3327])
def test_edge_softmax_counts_equal_tile_nnz(cuda, n, out_block):
    """The fused counts at every ``out_block`` the engines and tests use,
    ragged last tiles included: ``tile_nnz`` of the alpha as stored."""
    a, z, asrc, adst = attention_operands(n + 5, n, 16,
                                          min(1.0, 24.0 / n), cuda)
    a[n // 3] = 0.0
    assert_edge_softmax_matches_plain(a, z, asrc, adst, 0.02, out_block)


@pytest.mark.parametrize("threshold", [0.0, 0.02, 0.6])
@pytest.mark.parametrize("f", [1, 6, 16, 64])
def test_edge_softmax_widths_and_a_long_row(cuda, f, threshold):
    a, z, asrc, adst = attention_operands(f, 1500, f, 0.01, cuda)
    a[7] = 1.0                                        # 1500 support entries
    a[8, :1100] = 0.5
    a[9] = 0.0
    assert_edge_softmax_matches_plain(a, z, asrc, adst, threshold)


def sparse_square(seed, n, per_row, dense_rows, device,
                  dtype=torch.float32):
    """An (n, n) support of about ``per_row`` entries a row, made on the
    card from seeded numpy indices, with the rows ``dense_rows`` full and
    row n // 2 empty."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.integers(0, n, size=rows.size)
    a = torch.zeros((n, n), dtype=dtype, device=device)
    a[torch.from_numpy(rows).to(device), torch.from_numpy(cols).to(device)] \
        = 1.0
    a[list(dense_rows)] = 0.5
    a[n // 2] = 0.0
    return a


def plain_rows(a, z, asrc, adst, rows, threshold, slope=0.2):
    """The plain formula (``edge_softmax_plain``) on ``rows`` of alpha
    only: each row needs every s_dst but only its own row of a."""
    att = torch.cat([asrc, adst], dim=1).float()
    s = (z.float()[:, :, None] * att[None]).sum(dim=1)
    sc = s[rows, :1] + s[:, 1:2].T
    sc = torch.where(sc >= 0, sc, slope * sc)
    sup = a[rows] != 0
    mx = torch.where(sup, sc, float("-inf")).amax(dim=1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.where(sup, torch.exp(sc - mx), 0.0)
    al = ex / torch.clamp(ex.sum(dim=1, keepdim=True), min=1e-30)
    return torch.where(al > threshold, al, 0.0)


@pytest.mark.parametrize("out_block", [(16, 16), (32, 1)])
@pytest.mark.parametrize("n,route", [(8192, "list"), (9000, "list"),
                                     (20000, "list"), (40000, "reread")])
def test_edge_softmax_long_rows_on_each_route(cuda, n, route, out_block):
    """Long rows on each route (chunks with support listed in shared
    memory, s_dst staged there up to 16384 columns and not beyond; or a
    re-read of a), a few of them dense; at (32, 1) the counters exceed
    shared memory and count into device memory.  Up to 9000 columns
    against the whole plain version; at 20000 and 40000 (a is 1.6 and 6.4
    GB) against the plain formula on the dense, empty and a few sparse
    rows."""
    E = K.edge_softmax
    assert E.ROUTES[E.edge_launch(n, out_block).route] == route
    dense = (0, 7, n - 1)
    a = sparse_square(n, n, 6, dense, cuda)
    rng = np.random.default_rng(n + 1)
    z, asrc, adst = (torch.from_numpy(v.astype(np.float32)).to(cuda)
                     for v in (rng.normal(size=(n, 16)),
                               rng.normal(size=(16, 1)),
                               rng.normal(size=(16, 1))))
    if n <= 9000:
        got = assert_edge_softmax_matches_plain(a, z, asrc, adst, 0.0,
                                                out_block)
        torch.testing.assert_close(got[list(dense)].sum(dim=1),
                                   torch.ones(3, device=cuda), atol=1e-5,
                                   rtol=0)
        return
    before = E.launches
    got, counts = E.edge_softmax(a, z, asrc, adst, threshold=0.0,
                                 out_block=out_block)
    assert E.launches == before + 1
    assert torch.equal(counts, K.profile.tile_nnz(got, out_block))
    rows = [0, 7, 1, 999, n // 2, n - 9, n - 1]
    torch.testing.assert_close(got[rows], plain_rows(a, z, asrc, adst, rows,
                                                     0.0), **TOL)
    assert int(counts.sum()) == int(torch.count_nonzero(got))


@pytest.mark.parametrize("threshold", [0.0, 0.02, 0.6])
@pytest.mark.parametrize("n", [40, 1000, 3327])
@pytest.mark.parametrize("case", list(BF16_CASES))
def test_edge_softmax_bf16_matches_plain(cuda, case, n, threshold):
    """bf16 ``a`` and/or ``z`` (and attention vectors with ``z``) on the
    kernel: alpha in the promoted type, within one bf16 step of the plain
    version when bf16, counts exact."""
    a_t, z_t = BF16_CASES[case]
    a, z, asrc, adst = attention_operands(n + 11, n, 16,
                                          min(1.0, 8.0 / n), cuda)
    a[n // 2] = 0.0
    for ob in ((16, 16), (16, 48)):
        assert_edge_softmax_matches_plain(a.to(a_t), z.to(z_t),
                                          asrc.to(z_t), adst.to(z_t),
                                          threshold, ob)


def test_edge_softmax_bf16_counts_the_value_after_the_cast(cuda):
    """A float32 alpha of about 3.7e-44 (a denormal above threshold 0)
    rounds to 0 in bf16: the bf16 counts leave it out, as ``tile_nnz``
    of the stored alpha does."""
    n = 40
    a = torch.zeros((n, n), device=cuda)
    a[0, 1] = a[0, 2] = 1.0
    a[1:, 0] = 1.0
    z = torch.zeros((n, 1), device=cuda)
    z[2, 0] = 100.0                   # score 100 against 0 in row 0
    one = torch.ones((1, 1), device=cuda)
    f32, c32 = K.edge_softmax.edge_softmax(a, z, one, one, threshold=0.0,
                                           out_block=(16, 16))
    b16, c16 = K.edge_softmax.edge_softmax(a.bfloat16(), z.bfloat16(), one,
                                           one, threshold=0.0,
                                           out_block=(16, 16))
    assert b16.dtype == torch.bfloat16 and float(b16[0, 1]) == 0.0
    assert torch.equal(c16, K.profile.tile_nnz(b16, (16, 16)))
    assert torch.equal(c32, K.profile.tile_nnz(f32, (16, 16)))
    assert int(c16[0, 0]) == int(c32[0, 0]) - int(f32[0, 1] != 0)
    assert_edge_softmax_matches_plain(a.bfloat16(), z.bfloat16(), one, one,
                                      0.0)


@pytest.mark.parametrize("threshold", [0.0, 0.02, 0.6])
def test_edge_softmax_all_zero_adjacency(cuda, threshold):
    a, z, asrc, adst = attention_operands(3, 300, 16, 0.0, cuda)
    got = assert_edge_softmax_matches_plain(a, z, asrc, adst, threshold)
    assert not got.any()


def test_edge_softmax_raises_on_what_it_does_not_take(cuda):
    a, z, asrc, adst = attention_operands(4, 64, 8, 0.1, cuda)
    # bf16 a runs on the kernel (it was refused before the bf16 routes)
    got = assert_edge_softmax_matches_plain(a.bfloat16(), z, asrc, adst,
                                            0.02)
    assert got.dtype == torch.float32
    with pytest.raises(ValueError):
        K.edge_softmax.edge_softmax(a, z.double(), asrc, adst)
    with pytest.raises(ValueError):
        K.edge_softmax.edge_softmax(a.double(), z, asrc, adst)
    with pytest.raises(ValueError):
        K.edge_softmax.edge_softmax(a[:, :63], z, asrc, adst)
    with pytest.raises(ValueError):
        K.edge_softmax.edge_softmax(a, z[:63], asrc, adst)
    with pytest.raises(ValueError):
        K.edge_softmax.edge_softmax(a, z, asrc[:, 0], adst)
    with pytest.raises(ValueError):
        K.edge_softmax.edge_softmax(a, z, asrc, adst[:7])
    with pytest.raises(ValueError):
        K.edge_softmax.edge_softmax(a, z, asrc, adst, out_block=(0, 16))


def test_gat_fused_equals_per_kernel_on_the_card(cuda):
    from repro_torch.core import runtime
    from repro_torch.models import gnn
    bundle = gnn.build_dense("gat", "CO", scale=0.12, seed=2, device=cuda)
    K.reset_launch_counts()
    out, rep = bundle.run(runtime.DynasparseEngine())
    assert K.launch_counts()["edge_softmax"] == 4
    K.reset_launch_counts()
    env, f_rep = runtime.FusedModelExecutor().run(bundle.compiled,
                                                  bundle.tensors)
    assert K.launch_counts()["edge_softmax"] == 4
    last = bundle.compiled.graph.kernels[-1].out
    assert torch.equal(env[last], out)
    np.testing.assert_array_equal(f_rep.histogram, rep.histogram)
    cpu = {k: v.cpu() for k, v in bundle.tensors.items()}
    want, cpu_rep = runtime.DynasparseEngine().run(bundle.compiled, cpu)
    torch.testing.assert_close(out.cpu(), want[last], atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(rep.histogram, cpu_rep.histogram)


# -- the batched serving path --------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,m,n", [(1, 64, 48), (3, 100, 130), (4, 700, 1500),
                                   (3, 33, 1)])
def test_tile_nnz_batched_equals_per_slot_launches(cuda, dtype, b, m, n):
    """One batched launch per stack; each slot exactly the 2-D kernel's
    counts and the plain version's, all-zero slots and strided stacks
    included."""
    rng = np.random.default_rng(b * m + n)
    x = rng.normal(size=(b, m, n)) * (rng.random((b, m, n)) < 0.05)
    x[b // 2] = 0.0                                  # a dummy slot
    x = torch.from_numpy(x.astype(np.float32)).to(cuda).to(dtype)
    for stack in (x, x[:, 1:, :]):
        for tile in ((16, 16), (64, 16), (32, 1)):
            K.reset_launch_counts()
            got = K.profile.tile_nnz_batched(stack, tile)
            assert K.launch_counts()["tile_nnz_batched"] == 1
            assert torch.equal(got, K.profile.tile_nnz_plain(stack, tile))
            for s in range(b):
                assert torch.equal(got[s], K.profile.tile_nnz(stack[s],
                                                              tile)), s
            assert not got[b // 2].any()
    with pytest.raises(ValueError):
        K.profile.tile_nnz_batched(x[0], (16, 16))


def _slot_operands(cuda):
    """A (3, 64, 48) stack whose slot 1 is real and slots 0 and 2 are
    all-zero dummies, and a (3, 64, 64) adjacency stack likewise."""
    rng = np.random.default_rng(11)
    h = np.zeros((3, 64, 48), np.float32)
    h[1] = rng.normal(size=(64, 48)) * (rng.random((64, 48)) < 0.3)
    a = np.zeros((3, 64, 64), np.float32)
    a[1] = rng.random((64, 64)) < 0.1
    return (torch.from_numpy(h).to(cuda), torch.from_numpy(a).to(cuda))


@pytest.mark.parametrize("slot", ["dummy", "real"])
def test_path_kernels_on_dummy_slots_and_slot_views(cuda, slot):
    """Every kernel wrapper of the serving path on a slot view at a nonzero
    offset of a wave stack: the all-zero dummy slot 0 (empty Block-CSR, an
    all-SKIP grid, ELL with every row empty, an adjacency with no support)
    and the real slot 1, each against its plain version."""
    from repro_torch.core import dynasparse
    h, a = _slot_operands(cuda)
    b = 2 if slot == "dummy" else 1
    x, adj = h[b], a[b]
    assert bool(x.any()) == (slot == "real")
    assert x.data_ptr() != h.data_ptr()              # a view at an offset
    w = sparse(12, 48, 16, 0.5, cuda)
    cpu = lambda t: t.cpu()                          # noqa: E731
    torch.testing.assert_close(K.gemm.gemm(x, w), K.gemm.gemm_plain(
        cpu(x), cpu(w)).to(cuda), **TOL)
    xb = formats.dense_to_bcsr(x, (16, 16))
    torch.testing.assert_close(K.spdmm.spdmm(xb, w), K.spdmm.spdmm_plain(
        formats.dense_to_bcsr(cpu(x), (16, 16)), cpu(w)).to(cuda), **TOL)
    ell = formats.dense_to_ell(adj, 8)
    torch.testing.assert_close(
        ops.csr_spmm(ell, x), ops.csr_spmm(formats.dense_to_ell(
            cpu(adj), 8), cpu(x)).to(cuda), **TOL)
    skip = torch.zeros((4, 1, 3), dtype=torch.int32, device=cuda)
    for codes in (skip, torch.randint(0, 4, (4, 1, 3), dtype=torch.int32,
                                      device=cuda)):
        got = dispatch.block_matmul(x, w, codes, (16, 16, 16))
        torch.testing.assert_close(got, dispatch.block_matmul_plain(
            cpu(x), cpu(w), cpu(codes), (16, 16, 16)).to(cuda), **TOL)
    assert not dispatch.block_matmul(x, w, skip, (16, 16, 16)).any()
    asrc, adst = sparse(13, 48, 1, 1.0, cuda), sparse(14, 48, 1, 1.0, cuda)
    got, counts = K.edge_softmax.edge_softmax(adj, x, asrc, adst,
                                              threshold=0.02,
                                              out_block=(16, 16))
    want, want_c = K.edge_softmax.edge_softmax_plain(
        cpu(adj), cpu(x), cpu(asrc), cpu(adst), threshold=0.02,
        out_block=(16, 16))
    assert not torch.isnan(got).any()
    torch.testing.assert_close(got.cpu(), want, **TOL)
    assert torch.equal(counts.cpu(), want_c)
    kw = dict(block=(16, 16, 16), kernel_type=KernelType.AGGREGATE)
    for strategy in ("dynamic", "s1", "s2", "gemm"):
        res = dynasparse.dynasparse_matmul(adj, x, strategy=strategy, **kw)
        ref = dynasparse.dynasparse_matmul(cpu(adj), cpu(x),
                                           strategy=strategy, **kw)
        torch.testing.assert_close(res.out.cpu(), ref.out, **TOL)
        assert torch.equal(res.codes.cpu(), ref.codes), strategy


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_graph_serving_matches_naive_on_the_card(cuda, model):
    """serve == run_naive bitwise on a small stream; one walk plan per
    bucket; one batched tile_nnz launch per (request input, granularity)
    per wave; dummy slots plan all SKIP; two waves in flight give what two
    dispatched waves give."""
    from repro_torch.core import runtime
    from repro_torch.serving.graph_engine import (GraphServeEngine,
                                                  random_requests)
    eng = GraphServeEngine(model, f_in=64, hidden=16, n_classes=7, slots=4,
                           keep_codes=True, device=cuda)
    reqs = random_requests(7, f_in=64, sizes=(56, 100, 150), seed=7)
    K.reset_launch_counts()
    served = eng.serve(reqs)
    launched = K.launch_counts()["tile_nnz_batched"]
    naive = eng.run_naive(reqs)
    for s, n in zip(served, naive):
        assert np.array_equal(s.logits, n.logits), s.request_id
    assert eng.executor.trace_count == len(eng.buckets)
    per_wave = {}
    for bucket in eng.buckets:
        flows = runtime.FusedModelExecutor._resolved_flows(
            eng._compiled[bucket])
        per_wave[bucket] = len([n for n, _ in runtime.FusedModelExecutor
                                ._needed_inputs(flows)
                                if n in eng._input_names[bucket]])
    assert launched == sum(per_wave[r.bucket] for r in
                           {r.wave: r for r in served}.values())
    # the last wave of the stream: its unused slots plan all SKIP (an
    # attention kernel's grid is its constant one-GEMM cost entry)
    real = eng.last_wave_report.wave_real
    for k in eng._compiled[served[-1].bucket].graph.kernels:
        if k.kernel_type != KernelType.ATTENTION:
            assert not eng.executor.planned_codes[k.out][real:].any(), k.out
    bucket = served[0].bucket
    wave = [q for q, r in zip(reqs, served) if r.bucket == bucket][:2]
    first, second = eng.begin_wave(bucket, wave), eng.begin_wave(
        bucket, wave[::-1])
    got = eng.finish_wave(first) + eng.finish_wave(second)
    want = eng.dispatch_wave(bucket, wave) + eng.dispatch_wave(bucket,
                                                               wave[::-1])
    for g, w_ in zip(got, want):
        assert np.array_equal(g.logits, w_.logits)


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_continuous_two_waves_in_flight_equal_one(cuda, model):
    """ContinuousGraphServer on the card: with two lanes (two waves in
    flight) every result is bitwise what one lane gives, and both are
    run_naive's; begin_wave makes no host synchronization while a wave is
    in flight (the sync debug mode raises on one)."""
    from repro_torch.serving.graph_engine import (GraphServeEngine,
                                                  random_requests)
    from repro_torch.serving.scheduler import ContinuousGraphServer
    reqs = random_requests(9, f_in=64, sizes=(56, 100, 150), seed=7)
    out = {}
    for n_lanes in (1, 2):
        eng = GraphServeEngine(model, f_in=64, hidden=16, n_classes=7,
                               slots=2, device=cuda)
        srv = ContinuousGraphServer(eng, n_lanes=n_lanes)
        begin, live = eng.begin_wave, []

        def begin_wave(bucket, wave):
            if live:
                torch.cuda.set_sync_debug_mode("error")
            try:
                handle = begin(bucket, wave)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            live.append(handle)
            return handle

        finish = eng.finish_wave

        def finish_wave(handle):
            live.remove(handle)
            return finish(handle)

        eng.begin_wave, eng.finish_wave = begin_wave, finish_wave
        for r in reqs:
            assert srv.submit(r).admitted
        out[n_lanes] = {r.request_id: r for r in srv.drain()}
        assert srv.pipeline_depth == n_lanes and not live
        assert len(out[n_lanes]) == len(reqs)
        naive = eng.run_naive(reqs)
        for n in naive:
            assert np.array_equal(out[n_lanes][n.request_id].logits,
                                  n.logits), n.request_id
    for rid, res in out[1].items():
        assert np.array_equal(out[2][rid].logits, res.logits)


def test_minibatch_fill_features_into_a_pinned_slot(cuda):
    """A wave's pinned slot buffer, filled through ``_fill_slot``: each
    SeedRequest's gathered rows land in its slot's first rows and every
    padding row (and the dummy slots) stays zero; the device copy of the
    stack is the same bits."""
    from repro_torch.data.sampling import powerlaw_host_graph
    from repro_torch.serving.graph_engine import GraphServeEngine
    from repro_torch.serving.minibatch import FeatureStore, MiniBatchPlanner
    graph = powerlaw_host_graph(2000, avg_degree=8, seed=1)
    store = FeatureStore(np.random.default_rng(2).standard_normal(
        (2000, 48)).astype(np.float32) + 0.5)
    planner = MiniBatchPlanner(graph, store, fanouts=(8, 4))
    eng = GraphServeEngine("gcn", f_in=48, hidden=16, n_classes=7, slots=4,
                           device=cuda)
    reqs = [planner.request_for(v) for v in (3, 17, 999)]
    bucket = max(eng.bucket_for(r.n_vertices) for r in reqs)
    host = torch.zeros((4, bucket, 48), pin_memory=True)
    view = host.numpy()
    assert host.is_pinned() and view.flags["C_CONTIGUOUS"]
    for slot, req in enumerate(reqs):
        eng._fill_slot(req, {"H0": view[slot]})
    for slot, req in enumerate(reqs):
        n = req.n_vertices
        assert np.array_equal(view[slot, :n],
                              store.gather(req.subgraph.vertices))
        assert not view[slot, n:].any()
    assert not view[len(reqs):].any()
    dev = host.to(cuda, non_blocking=True)
    assert torch.equal(dev.cpu(), host)


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_minibatch_stream_equals_its_oracle_on_the_card(cuda, model):
    """A small mini-batch stream on the card: synchronous serve_queries
    and the continuous submit_query, with an edge delta and a store update
    between passes, each bitwise the per-seed run_naive oracle; cache-on
    equals cache-off."""
    from repro_torch.data.sampling import powerlaw_host_graph
    from repro_torch.serving.graph_engine import GraphServeEngine
    from repro_torch.serving.minibatch import (FeatureStore,
                                               MiniBatchServeEngine)
    from repro_torch.serving.scheduler import ContinuousGraphServer
    graph = powerlaw_host_graph(3000, avg_degree=8, seed=0)
    feats = np.random.default_rng(3).standard_normal(
        (3000, 64)).astype(np.float32)
    eng = GraphServeEngine(model, f_in=64, hidden=16, n_classes=7, slots=8,
                           device=cuda)
    on = MiniBatchServeEngine(eng, graph, FeatureStore(feats.copy()))
    off = MiniBatchServeEngine(eng, graph, FeatureStore(feats.copy()),
                               cache_capacity=None)
    queries = [[5, 9], [9, 200, 5], [1234], [5, 5, 77, 2999]]
    for step in range(3):
        got_on, got_off = on.serve_queries(queries), off.serve_queries(
            queries)
        want = on.oracle_queries(queries)
        for a, b, w in zip(got_on, got_off, want):
            assert np.array_equal(a.result(), w)
            assert np.array_equal(b.result(), w)
        if step == 0:
            edge = [(5, next(u for u in range(3000) if u != 5 and u not in
                             set(on.planner.graph.neighbors(5))))]
            assert on.apply_delta(edge).graph_version == 1
            off.apply_delta(edge)
        if step == 1:
            for mb in (on, off):
                rows = mb.planner.sample(9).vertices
                mb.planner.store.update(
                    rows, mb.planner.store.gather(rows) * 2.0)
    assert on.cache.stats.hits > 0
    srv = ContinuousGraphServer(eng, minibatch=on.planner)
    tickets = [srv.submit_query(q) for q in queries + [[42, 5]]]
    srv.drain()
    assert all(t.done for t in tickets)
    for t, w in zip(tickets, on.oracle_queries([t.seeds for t in tickets])):
        assert np.array_equal(t.result(), w)


def test_simulate_plans_on_the_card_as_on_the_cpu(cuda):
    """The cost simulator planning on the card gives the CPU's histograms
    and makespans, under both cost models."""
    from repro_torch.core import runtime
    from repro_torch.core.perf_model import FPGACostModel, TPUCostModel
    from repro_torch.models import gnn
    sim = gnn.build_sim("sage", "CI")
    assert sim.device.type == "cuda"
    for strategy, model in (("dynamic", FPGACostModel()), ("s1", None),
                            ("dynamic", TPUCostModel())):
        got = sim.simulate(strategy, model=model)
        want = runtime.simulate_inference(sim.compiled, sim.stats,
                                          strategy=strategy, model=model,
                                          device="cpu")
        for g, w in zip(got.kernels, want.kernels):
            np.testing.assert_array_equal(g.histogram, w.histogram)
            assert g.makespan_cycles == w.makespan_cycles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_formats_on_the_card(cuda, dtype):
    from repro_torch.core import profiler
    x = sparse(21, 45, 70, 0.1, cuda).to(dtype)
    x[7] = 0
    for cap in (None, 100, 20):
        for conv, fields in ((formats.dense_to_coo,
                              ("rows", "cols", "values", "nnz")),
                             (formats.dense_to_csr,
                              ("indptr", "indices", "values"))):
            got, want = conv(x, cap), conv(x.cpu(), cap)
            for f in fields:
                assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    assert torch.equal(formats.coo_to_dense(formats.dense_to_coo(x)), x)
    csr = formats.dense_to_csr(x)
    assert torch.equal(formats.csr_to_dense(csr), x)
    assert torch.equal(formats.coo_to_csr(formats.csr_to_coo(csr)).indptr,
                       csr.indptr)
    via, direct = formats.csr_to_ell(csr, 12), formats.dense_to_ell(x, 12)
    for f in ("values", "cols", "row_counts"):
        assert torch.equal(getattr(via, f), getattr(direct, f)), f
    assert torch.equal(profiler.block_tile_density(x, (32, 32), (8, 8)).cpu(),
                       profiler.block_tile_density(x.cpu(), (32, 32), (8, 8)))


# ---------------------------------------------- the LM layer kinds ------

def _lm_cfg(arch, **kw):
    from repro_torch.configs import smoke_config
    return smoke_config(arch, dtype="float32", **kw)


def _on(tree, device):
    if isinstance(tree, dict):
        return {k: _on(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, device) for v in tree]
    return tree.to(device)


def _mixer_case(kind):
    """(fn(x, p, cfg, cache), params on the CPU, cfg, cache maker) of one
    LM layer kind at its smoke config, float32."""
    from repro_torch.models import attention, ssm, transformer, xlstm

    gen = torch.Generator().manual_seed(0)
    if kind in ("mla", "mla_absorbed"):
        cfg = _lm_cfg("deepseek-v2-lite-16b")
        absorbed = kind == "mla_absorbed"
        p = attention.init_mla(gen, cfg, torch.float32)

        def fn(x, p, c, cache, pos):
            return attention.mla_attention(
                x, p, cfg, positions=pos + torch.arange(
                    x.shape[1], device=x.device), cache=cache, pos=pos,
                absorbed=absorbed)
        mixer = "attn"
    else:
        arch = "jamba-v0.1-52b" if kind == "mamba" else "xlstm-125m"
        cfg = _lm_cfg(arch)
        init = {"mamba": ssm.init_mamba, "mlstm": xlstm.init_mlstm,
                "slstm": xlstm.init_slstm}[kind]
        run = {"mamba": ssm.mamba_mixer, "mlstm": xlstm.mlstm_mixer,
               "slstm": xlstm.slstm_mixer}[kind]
        p = init(gen, cfg, torch.float32)

        def fn(x, p, c, cache, pos):
            return run(x, p, cfg, cache=cache)
        mixer = kind

    def cache(device):
        return transformer._cache_for_kind(cfg, {"mixer": mixer}, 2, 24,
                                           device)
    return fn, p, cfg, cache


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm", "mla",
                                  "mla_absorbed"])
def test_lm_mixers_on_the_card_match_the_cpu(cuda, kind):
    """Each new mixer, float32, on the card against the same mixer on the
    CPU: no cache, prefill into a cache, then two decode steps."""
    fn, p, cfg, cache = _mixer_case(kind)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 19, cfg.d_model), generator=gen) * 0.5
    pc = _on(p, cuda)
    want, _ = fn(x[:, :17], p, cfg, None, 0)
    got, _ = fn(x[:, :17].to(cuda), pc, cfg, None, 0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    cc, gc = cache("cpu"), cache(cuda)
    for lo, hi in ((0, 17), (17, 18), (18, 19)):
        want, _ = fn(x[:, lo:hi], p, cfg, cc, lo)
        got, _ = fn(x[:, lo:hi].to(cuda), pc, cfg, gc, lo)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        for name in cc:
            torch.testing.assert_close(gc[name].cpu(), cc[name], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b",
                                  "jamba-v0.1-52b"])
def test_moe_routing_on_the_card_equals_the_cpu(cuda, arch):
    """Routing integers exact (stable top-k, float32 cumsum slots, drops)
    and the MoE output within float32 tolerance, shared experts too."""
    import dataclasses

    from repro_torch.models import layers

    cfg = _lm_cfg(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.6))
    p = layers.init_moe(torch.Generator().manual_seed(2), cfg, torch.float32)
    x = torch.randn((3, 23, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    want, want_aux = layers.moe_ffn(x, p, cfg)
    got, got_aux = layers.moe_ffn(x.to(cuda), _on(p, cuda), cfg)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    assert abs(float(got_aux) - float(want_aux)) < 1e-6
    m = cfg.moe
    xg = torch.nn.functional.pad(x.reshape(69, -1), (0, 0, 0, 27))
    xg = xg.reshape(3, 32, -1)
    r_cpu = layers.moe_routing(xg, p, m, 69)
    r_gpu = layers.moe_routing(xg.to(cuda), _on(p, cuda), m, 69)
    for name in ("gate_i", "pos", "keep", "slot"):
        assert torch.equal(r_gpu[name].cpu(), r_cpu[name]), name
    assert not bool(r_cpu["keep"].all())          # capacity 0.6 drops


def test_flash_attention_refuses_head_dim_192_and_mla(cuda):
    """deepseek's head dim (128 nope + 64 rope) is not a kernel head dim;
    MLA refuses flash before it gets there."""
    import dataclasses

    from repro_torch.models import attention

    q = torch.zeros((1, 2, 16, 192), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim 192"):
        ops.flash_attention(q, q, q, causal=True)
    _, p, cfg, _ = _mixer_case("mla")
    flash = dataclasses.replace(cfg, attn_impl="flash")
    with pytest.raises(ValueError, match="flash"):
        attention.mla_attention(torch.zeros((1, 8, cfg.d_model),
                                            device=cuda), _on(p, cuda),
                                flash, positions=torch.arange(8,
                                                              device=cuda))


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b",
                                  "jamba-v0.1-52b", "xlstm-125m",
                                  "whisper-large-v3", "chatglm3-6b",
                                  "chameleon-34b", "mistral-large-123b"])
def test_lm_archs_on_the_card_match_the_cpu(cuda, arch):
    """Each new arch's smoke config, float32, the same params on both:
    prefill and a decode step's logits on the card against the CPU's."""
    from repro_torch.models import model_zoo

    cfg = _lm_cfg(arch)
    cpu = model_zoo.build(cfg, device="cpu")
    gpu = model_zoo.build(cfg, device=cuda)
    params = cpu.init_params(5)
    pg = _on(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 12)))
    batch = {"tokens": toks[:, :11]}
    if cfg.encdec is not None:
        batch["frames"] = torch.randn(
            (2, 16, cfg.d_model), generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        want, cc = cpu.prefill(params, batch, max_seq=12)
        got, gc = gpu.prefill(pg, {k: v.to(cuda) for k, v in batch.items()},
                              max_seq=12)
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
        want, _ = cpu.decode_step(params, cc, toks[:, 11:], 11)
        got, _ = gpu.decode_step(pg, gc, toks[:, 11:].to(cuda), 11)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("density", [0.1, 0.37])
def test_prune_ffn_on_the_card_equals_the_cpu(cuda, density):
    """bf16 leaves take the histogram threshold on the card; masks equal
    the CPU's."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo

    cfg = smoke_config("deepseek-v2-lite-16b")
    params = model_zoo.build(cfg, device="cpu").init_params(8)
    pg = _on(params, cuda)
    want = serve.prune_ffn(params, density, period=cfg.layer_period)
    got = serve.prune_ffn(pg, density, period=cfg.layer_period)
    for group in serve.leaf_groups(params, cfg.layer_period):
        for key, j, path in group:
            assert torch.equal(serve._get(got[key][j], path).cpu(),
                               serve._get(want[key][j], path))


# ---------------------------------------------------------------- training

def _grad_operands(m, k, n, block, dtype, device, seed=21):
    """x, w with a zero block planted in each (SKIP codes), and a
    cotangent g, on ``device``."""
    bm, bk, bn = block
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    x[:bm, bk:2 * bk] = 0
    w[:bk, bn:2 * bn] = 0
    g = rng.normal(size=(m, n)).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(w).to(device, dtype),
            torch.from_numpy(g).to(device))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("shape,block", [
    ((300, 512, 768), (256, 256, 256)), ((100, 96, 80), (32, 32, 32)),
    ((40, 160, 300), (16, 64, 128))])
def test_dispatch_backward_matches_autograd_of_the_plain_version(
        cuda, dtype, tol, shape, block):
    """The Function's dx and dw (``dispatch_bwd``'s two products on bf16
    and float32 grids with every edge in {64, 128, 256}, else two dispatch
    launches over the permuted grids) against autograd through
    ``block_matmul_plain`` on the card; dx exactly 0 where the forward
    SKIPped every step."""
    from repro_torch.core import analyzer, dynasparse, profiler
    from repro_torch.core.perf_model import TPUCostModel

    bm, bk, bn = block
    x, w, g = _grad_operands(*shape, block, dtype, cuda)
    codes = analyzer.plan_codes(
        "dynamic", profiler.block_density(x, (bm, bk)),
        profiler.block_density(w, (bk, bn)), TPUCostModel())
    m, n = x.shape[0], w.shape[1]
    grads = []
    for route in ("kernel", "plain"):
        xs, ws = (x.clone().requires_grad_(), w.clone().requires_grad_())
        K.reset_launch_counts()
        if route == "kernel":
            out = dynasparse.BlockMatmulFn.apply(xs, ws, codes, block)
        else:
            out = dispatch.block_matmul_plain(xs, ws, codes, block,
                                              pad_rows=False)[:m, :n]
        out.backward(g)
        torch.cuda.synchronize()
        c = K.launch_counts()
        want = ((0, 0) if route == "plain"
                else (1, 2) if K.dispatch_bwd.takes(dtype, block)
                else (3, 0))
        assert (c["dispatch"], c["dispatch_bwd"]) == want
        grads.append((xs.grad, ws.grad))
    for got, want in zip(grads[0], grads[1]):
        assert got.dtype == dtype
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= tol, err
    assert torch.all(grads[0][0][:bm, bk:2 * bk] == 0)
    assert torch.all(grads[0][1][:bk, bn:2 * bn] == 0)


@pytest.mark.parametrize("layout", ["nt", "tn"])
@pytest.mark.parametrize("shape,block", [
    ((512, 512, 768), (256, 256, 256)), ((300, 320, 400), (128, 64, 256)),
    ((130, 192, 200), (64, 64, 128)), ((40, 64, 72), (64, 64, 64)),
    ((256, 512, 256), (256, 128, 64)), ((2048, 2048, 10944),
                                        (256, 256, 256))])
def test_dispatch_bwd_matches_its_plain_versions(cuda, layout, shape, block):
    """``dispatch_bwd`` on random GEMM/SPDMM/SPMM/SKIP grids: its float32
    sums within 1e-4 of the largest |want| of the plain version's (the
    order of the float32 sums differs), its bf16 result their rounding
    bitwise, exact zeros where every step was SKIPped; one launch each."""
    m, k, n = shape
    bm, bk, bn = block
    I, J, Kb = -(-m // bm), -(-n // bn), -(-k // bk)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + n)
    codes = torch.randint(0, 4, (I, J, Kb), generator=gen, device=cuda,
                          dtype=torch.int32)
    x = torch.randn((m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=cuda).to(torch.bfloat16)
    g = torch.randn((m, n), generator=gen, device=cuda).to(torch.bfloat16)
    B = K.dispatch_bwd
    fn, plain, a, b = ((B.block_matmul_nt, B.block_matmul_nt_plain, g, w)
                       if layout == "nt" else
                       (B.block_matmul_tn, B.block_matmul_tn_plain, x, g))
    K.reset_launch_counts()
    got = fn(a, b, codes, block)
    k32 = fn(a, b, codes, block, out_dtype=torch.float32)
    assert K.launch_counts()["dispatch_bwd"] == 2
    want = plain(a, b, codes, block, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err = float((k32.double() - want.double()).abs().max())
    assert err <= 1e-4 * float(want.abs().max()), err
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, k32.to(torch.bfloat16))
    run = codes != 0
    if layout == "nt":
        skipped = (run.sum(1) == 0).repeat_interleave(bm, 0)
        skipped = skipped.repeat_interleave(bk, 1)[:m, :k]
    else:
        skipped = (run.sum(0) == 0).T.repeat_interleave(bk, 0)
        skipped = skipped.repeat_interleave(bn, 1)[:k, :n]
    assert torch.all(got[skipped] == 0)


def _two_launch(layout, a, b, codes, block):
    """The float32 backward product as two dispatch launches over a
    transposed operand and the permuted GEMM/SKIP grid (the route below
    the kernels' edges)."""
    bm, bk, bn = block
    run = (codes != 0).to(torch.int32)
    if layout == "nt":
        return dispatch.block_matmul(
            a, b.T, run.permute(0, 2, 1).contiguous(), (bm, bn, bk),
            pad_rows=False)[:a.shape[0], :b.shape[0]]
    return dispatch.block_matmul(
        a.T, b, run.permute(2, 1, 0).contiguous(), (bk, bm, bn),
        pad_rows=False)[:a.shape[1], :b.shape[1]]


@pytest.mark.parametrize("layout", ["nt", "tn"])
@pytest.mark.parametrize("skip", ["random", "half", "all"])
@pytest.mark.parametrize("shape,block", [
    ((512, 512, 768), (256, 256, 256)), ((300, 320, 400), (128, 64, 256)),
    ((130, 192, 200), (64, 64, 128)), ((40, 64, 72), (64, 64, 64)),
    ((256, 512, 260), (256, 128, 64)), ((2048, 2048, 10944),
                                        (256, 256, 256))])
def test_dispatch_bwd_f32_matches_its_plain_versions(cuda, layout, skip,
                                                     shape, block):
    """The float32 ``dispatch_bwd`` (``csrc/dispatch_bwd_f32.cu``) at block
    edges 64, 128 and 256, ragged N, on random, half-SKIPped and all-SKIP
    grids: within 3e-4 of the largest |want| of its plain version, equal
    to the two-launch route bitwise, exact zeros where every step was
    SKIPped; one launch."""
    m, k, n = shape
    bm, bk, bn = block
    I, J, Kb = -(-m // bm), -(-n // bn), -(-k // bk)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + n + len(skip))
    codes = torch.randint(1, 4, (I, J, Kb), generator=gen, device=cuda,
                          dtype=torch.int32)
    p = {"random": 0.25, "half": 0.5, "all": 1.1}[skip]
    codes[torch.rand((I, J, Kb), generator=gen, device=cuda) < p] = 0
    x = torch.randn((m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda)
    g = torch.randn((m, n), generator=gen, device=cuda)
    B = K.dispatch_bwd
    fn, plain, a, b = ((B.block_matmul_nt, B.block_matmul_nt_plain, g, w)
                       if layout == "nt" else
                       (B.block_matmul_tn, B.block_matmul_tn_plain, x, g))
    K.reset_launch_counts()
    got = fn(a, b, codes, block)
    assert K.launch_counts()["dispatch_bwd"] == 1
    want = plain(a, b, codes, block)
    old = _two_launch(layout, a, b, codes, block)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.double() - want.double()).abs().max())
    assert err <= 3e-4 * float(want.abs().max()), err
    assert torch.equal(got, old)
    run = codes != 0
    if layout == "nt":
        skipped = (run.sum(1) == 0).repeat_interleave(bm, 0)
        skipped = skipped.repeat_interleave(bk, 1)[:m, :k]
    else:
        skipped = (run.sum(0) == 0).T.repeat_interleave(bk, 0)
        skipped = skipped.repeat_interleave(bn, 1)[:k, :n]
    assert torch.all(got[skipped] == 0)
    if skip == "all":
        assert torch.all(got == 0)


def test_dispatch_bwd_f32_raises_on_what_it_does_not_take(cuda):
    """Misaligned or non-contiguous float32 operands raise (the kernel's
    16-byte cp.async rows); so do mixed types and a bf16 result."""
    block = (64, 64, 64)
    codes = torch.ones((2, 2, 1), dtype=torch.int32, device=cuda)
    g = torch.randn((128, 128), device=cuda)
    w = torch.randn((64, 128), device=cuda)
    flat = torch.zeros(1 + 128 * 128, device=cuda)
    odd = flat[1:].view(128, 128)                           # 4-byte offset
    wide = torch.zeros((128, 130), device=cuda)[:, :128]    # 520-byte rows
    B = K.dispatch_bwd
    for a_, b_, match in ((odd, w, "16-byte aligned"),
                          (wide, w, "16-byte aligned"),
                          (g, torch.randn((128, 64), device=cuda).T,
                           "unit column stride"),
                          (g.bfloat16(), w, "expected a CUDA float32"),
                          (g, w.bfloat16(), "expected a CUDA bf16")):
        with pytest.raises(ValueError, match=match):
            B.block_matmul_nt(a_, b_, codes, block)
    with pytest.raises(ValueError, match="out_dtype"):
        B.block_matmul_nt(g, w, codes, block, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("skip", ["random", "half", "all"])
@pytest.mark.parametrize("shape,block", [
    ((2048, 2048, 8192), (256, 256, 256)),     # llama3.2-1b's w1, w3
    ((2048, 8192, 2048), (256, 256, 256)),     # its w2
    ((2048, 2048, 10944), (256, 256, 256)),    # deepseek's ragged w1
    ((300, 320, 400), (128, 64, 256)), ((130, 192, 200), (64, 64, 128)),
    ((40, 64, 72), (64, 64, 64)), ((256, 512, 260), (256, 128, 64))])
def test_dispatch_nn_equals_the_walk_bitwise(cuda, skip, shape, block):
    """The float32 training forward (``dispatch.block_matmul_nn``,
    ``csrc/dispatch_bwd_f32.cu`` in its nn layout) on grids of SKIP, GEMM,
    SPDMM and SPMM codes, x with zero 16 x 16 tiles (so the walk skips
    some): bitwise the walk route, ``block_matmul`` cut to (m, n); within
    3e-4 of the largest |want| of the plain version; one launch, counted
    under ``dispatch``."""
    m, k, n = shape
    bm, bk, bn = block
    I, J, Kb = -(-m // bm), -(-n // bn), -(-k // bk)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m + n + len(skip))
    codes = torch.randint(1, 4, (I, J, Kb), generator=gen, device=cuda,
                          dtype=torch.int32)
    p = {"random": 0.25, "half": 0.5, "all": 1.1}[skip]
    codes[torch.rand((I, J, Kb), generator=gen, device=cuda) < p] = 0
    tiles = torch.rand((-(-m // 16), -(-k // 16)), generator=gen,
                       device=cuda) < 0.7
    keep = tiles.repeat_interleave(16, 0).repeat_interleave(16, 1)
    x = torch.randn((m, k), generator=gen, device=cuda) * keep[:m, :k]
    y = torch.randn((k, n), generator=gen, device=cuda) * k ** -0.5
    K.reset_launch_counts()
    got = dispatch.block_matmul_nn(x, y, codes, block)
    assert K.launch_counts()["dispatch"] == 1
    walk = dispatch.block_matmul(x, y, codes, block, pad_rows=False)[:m, :n]
    want = dispatch.block_matmul_plain(x, y, codes, block,
                                       pad_rows=False)[:m, :n]
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, walk)
    err = float((got.double() - want.double()).abs().max())
    assert err <= 3e-4 * max(float(want.abs().max()), 1.0), err
    if skip == "all":
        assert torch.all(got == 0) and not torch.signbit(got).any()


def test_dispatch_nn_raises_on_what_it_does_not_take(cuda):
    """bf16, mixed types, misaligned or non-unit-stride rows, a CPU
    operand, an edge outside EDGES and an operand under grad raise; nothing
    falls back to the walk."""
    block = (64, 64, 64)
    codes = torch.ones((2, 2, 1), dtype=torch.int32, device=cuda)
    x = torch.randn((128, 64), device=cuda)
    y = torch.randn((64, 128), device=cuda)
    flat = torch.zeros(1 + 128 * 64, device=cuda)
    odd = flat[1:].view(128, 64)                            # 4-byte offset
    wide = torch.zeros((128, 66), device=cuda)[:, :64]      # 264-byte rows
    K.reset_launch_counts()
    for a_, b_, blk, match in (
            (x.bfloat16(), y.bfloat16(), block, "expected a CUDA float32"),
            (x, y.bfloat16(), block, "expected a CUDA float32"),
            (odd, y, block, "16-byte aligned"),
            (wide, y, block, "16-byte aligned"),
            (x, torch.randn((128, 64), device=cuda).T, block,
             "unit column stride"),
            (x.cpu(), y, block, "expected a CUDA float32"),
            (x, y, (64, 32, 64), "not supported by the kernel")):
        c = codes if blk == block else torch.ones(
            (2, 2, 2), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match=match):
            dispatch.block_matmul_nn(a_, b_, c, blk)
    with torch.enable_grad(), pytest.raises(ValueError, match="no backward"):
        dispatch.block_matmul_nn(x.requires_grad_(), y, codes, block)
    assert K.launch_counts()["dispatch"] == 0


def test_float32_below_the_kernels_edges_keeps_two_launches(cuda):
    """BlockMatmulFn in float32: at (16, 64, 128) the two dispatch launches
    over the permuted grids, at (64, 64, 128) one dispatch_bwd launch per
    product; the gradients agree."""
    from repro_torch.core import dynasparse

    x = torch.randn((130, 192), device=cuda)
    w = torch.randn((192, 200), device=cuda)
    g = torch.randn((130, 200), device=cuda)
    grads = {}
    for block, want in (((16, 64, 128), (3, 0)), ((64, 64, 128), (1, 2))):
        I, J, Kb = -(-130 // block[0]), -(-200 // block[2]), -(-192 // block[1])
        codes = torch.ones((I, J, Kb), dtype=torch.int32, device=cuda)
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        K.reset_launch_counts()
        dynasparse.BlockMatmulFn.apply(xs, ws, codes, block).backward(g)
        torch.cuda.synchronize()
        c = K.launch_counts()
        assert (c["dispatch"], c["dispatch_bwd"]) == want
        grads[block] = (xs.grad, ws.grad)
    for a_, b_ in zip(*grads.values()):
        err = float((a_ - b_).abs().max())
        assert err <= 3e-4 * float(b_.abs().max()), err


def test_flash_attention_f32_raises_on_misaligned_data(cuda):
    flat = torch.zeros(1 + 2 * 16 * 64, device=cuda)
    odd = flat[1:].view(1, 2, 16, 64)                       # 4-byte offset
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.flash_attention.flash_attention(odd, odd, odd, bq=16, bk=16)


def test_cuda_routes_without_backward_refuse_a_gradient(cuda):
    """float32 static gemm/spdmm, the row-CSR route, edge_softmax, flash
    and a direct dispatch launch raise under grad instead of returning a
    result with no graph."""
    from repro_torch.core import dynasparse
    from repro_torch.core.ir import KernelType

    x = torch.randn(64, 48, device=cuda).requires_grad_()
    y = torch.randn(48, 32, device=cuda)
    for strategy in ("gemm", "s2"):
        with pytest.raises(ValueError, match="no backward"):
            dynasparse.dynasparse_matmul(x, y, strategy=strategy,
                                         block=(16, 16, 16))
    with pytest.raises(ValueError, match="no backward"):
        dynasparse.dynasparse_matmul(
            x, y, block=(16, 16, 16), format_aware=True,
            kernel_type=KernelType.AGGREGATE,
            fmt=torch.ones((), dtype=torch.int32, device=cuda))
    codes = torch.ones((4, 2, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        dispatch.block_matmul(x, y, codes, (16, 16, 16))
    a = (torch.rand(32, 32, device=cuda) < 0.3).float().requires_grad_()
    z = torch.randn(32, 8, device=cuda)
    att = torch.randn(8, 1, device=cuda)
    with pytest.raises(ValueError, match="no backward"):
        ops.edge_softmax(a, z, att, att)
    q = torch.randn(1, 2, 16, 16, device=cuda).requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(q, q.detach(), q.detach(), causal=True)
    with torch.no_grad():
        dynasparse.dynasparse_matmul(x, y, strategy="gemm",
                                     block=(16, 16, 16))


@pytest.mark.parametrize("dyn", [False, True])
def test_train_step_on_the_card_matches_the_cpu(cuda, dyn):
    """Two float32 steps of the smoke llama (dynasparse FFN on: its
    backward on the float32 dispatch_bwd kernel) on the card and on the
    CPU."""
    import dataclasses

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models import model_zoo
    from repro_torch.train import tree as tree_lib
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainState, make_train_step

    cfg = dataclasses.replace(_lm_cfg("llama3.2-1b", d_model=256,
                                      n_layers=2), dynasparse_ffn=dyn)
    pipe = TokenPipeline(cfg.vocab_size, 2, 64)
    outs = []
    for dev in ("cpu", cuda):
        bundle = model_zoo.build(cfg, device=dev)
        opt = AdamW(lr=1e-3, warmup_steps=1)
        step = make_train_step(bundle.loss_fn, opt,
                               decay=model_zoo.decay_mask(cfg))
        params = _on(model_zoo.build(cfg, device="cpu").init_params(3), dev)
        state = TrainState(params, opt.init(params))
        K.reset_launch_counts()
        for s in range(2):
            b = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in pipe.batch_for_step(s).items()}
            state, m = step(state, b)
        outs.append((float(m["loss"]), float(m["grad_norm"]),
                     [t.cpu() for t in tree_lib.flatten(state.params)[0]],
                     (K.launch_counts()["dispatch"],
                      K.launch_counts()["dispatch_bwd"])))
    (l0, g0, p0, _), (l1, g1, p1, launches) = outs
    assert abs(l0 - l1) <= 1e-4 * abs(l0) and abs(g0 - g1) <= 1e-3 * g0
    # 2 steps x 2 layers x 3 FFN products: one forward dispatch launch
    # (block_matmul_nn's, counted under dispatch) and two backward
    # dispatch_bwd launches (float32 at (256, 256, 256))
    assert launches == ((2 * 6, 2 * 6 * 2) if dyn else (0, 0))
    for a, b in zip(p0, p1):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# The dry run's slice on the card (chip_smoke.py phase 12, at small sizes)
# ---------------------------------------------------------------------------

def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_compressed_allreduce_on_one_nccl_rank_equals_the_cpu(cuda):
    """The int8 error-feedback all-reduce over a one-rank NCCL group: mean
    and residual bitwise the same call on the CPU over a gloo group (IEEE
    division and one rounding of the residual on both devices)."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives

    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        cpu = dist.new_group(ranks=[0], backend="gloo")
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        grads = {"w": torch.randn((300, 257), generator=gen, device=cuda,
                                  dtype=torch.bfloat16),
                 "b": torch.randn((33,), generator=gen, device=cuda) * 1e3,
                 "z": torch.zeros((7,), device=cuda)}
        res = {k: torch.randn(v.shape, generator=gen, device=cuda) * 1e-2
               for k, v in grads.items()}
        res["z"].zero_()
        mean, new_res = collectives.compressed_grad_allreduce(grads, None,
                                                              res)
        cmean, cres = collectives.compressed_grad_allreduce(
            {k: v.cpu() for k, v in grads.items()}, cpu,
            {k: v.cpu() for k, v in res.items()})
        for k in grads:
            assert mean[k].dtype == grads[k].dtype
            assert torch.equal(mean[k].cpu(), cmean[k]), k
            assert torch.equal(new_res[k].cpu(), cres[k]), k
        assert not mean["z"].any()
        x = torch.randn((65, 31), generator=gen, device=cuda)
        assert torch.equal(collectives.compressed_psum(x).cpu(),
                           collectives.compressed_psum(x.cpu(), cpu))
        q, s = collectives.quantize_int8(x.bfloat16())
        qc, sc = collectives.quantize_int8(x.bfloat16().cpu())
        assert torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("m,n,tile,dtype", [
    (2047, 8191, (256, 256), torch.bfloat16),
    (300, 200, (128, 128), torch.float32),
    (17, 33, (16, 16), torch.float32)])
def test_padded_tile_nnz_launches_once_and_is_exact(cuda, m, n, tile, dtype):
    x = sparse(m + n, m, n, 0.3, cuda).to(dtype)
    K.reset_launch_counts()
    got = ops.tile_nnz(x, tile=tile)
    torch.cuda.synchronize()
    assert K.launch_counts()["tile_nnz"] == 1
    assert got.shape == (-(-m // tile[0]), -(-n // tile[1]))
    assert torch.equal(got.cpu(), ops.tile_nnz(x.cpu(), tile=tile))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_dryrun_meta_count_equals_the_card_count(cuda, kind):
    """A smoke cell's 1-period cost proxy: the FLOPs counted on the meta
    device equal those of the same call on the card."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import model_zoo
    from repro_torch.train import tree as tree_lib

    mesh = make_test_mesh(8, 4)
    shape = ShapeCfg("s", 64, 2, kind)
    cfg = dryrun._variant(smoke_config("llama3.2-1b"), shape, mode="cost",
                          n_periods=1)
    cell = dryrun.build_cell(cfg, shape, mesh)
    params = model_zoo.build(cfg, cuda).init_params(0)

    def real(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.is_floating_point():
            return torch.zeros(x.shape, dtype=x.dtype, device=cuda)
        return torch.ones(x.shape, dtype=x.dtype, device=cuda)

    # the cell's arguments on the card, its params as initialised (the
    # counts read shapes only, but the card's run is a real one)
    args = tree_lib.tree_map(real, cell.args)
    if kind == "train":
        args = (args[0]._replace(params=params),) + tuple(args[1:])
    else:
        args = (params,) + tuple(args[1:])
    on_meta = dryrun.count(cell.fn, *cell.args, mesh=mesh)
    on_card = dryrun.count(cell.fn, *args, mesh=mesh)
    torch.cuda.synchronize()
    assert on_meta["flops"] == on_card["flops"] > 0
