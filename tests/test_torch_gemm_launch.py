"""The float32 kernels' launch shapes, on the CPU: ``gemm.gemm_launch``
(the gemm kernel's CTA tile) and ``dispatch.fma_launch`` (the float32
dispatch route's warps and CTAs) are pure functions of the shapes.  The
tiles cover the output exactly once and never split k, so the shape
changes no output's bits.  The kernels themselves are checked on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch, gemm

EDGES = dispatch.BLOCK_EDGES


def fma_cases(seed, n):
    """(rows, J, block) cases, rows from 1 to I * bm, ragged and exact."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        bm, bn = (int(EDGES[i]) for i in rng.integers(len(EDGES), size=2))
        bk = 16 * int(rng.integers(1, 40))
        I, J = (int(v) for v in rng.integers(1, 60, size=2))
        rows = int(rng.integers(1, I * bm + 1))
        yield rows, J, (bm, bk, bn)


def check_fma(rows, J, block, sms):
    bm, _, bn = block
    s = dispatch.fma_launch(rows, J, block, sms)
    # a warp stays inside one (bm, bn) block: its rows divide bm, its 16
    # columns divide bn
    assert s.warp_rows in (8, 16) and bm % s.warp_rows == 0
    assert bn % 16 == 0
    # at most FMA_MAX_WARPS warps per CTA
    assert 1 <= s.row_warps * s.col_warps <= dispatch.FMA_MAX_WARPS
    # the CTAs cover every output row and column once and nothing more
    # than their last tile: one CTA per output element, no split of k
    assert s.row_ctas * s.cta_rows >= rows > (s.row_ctas - 1) * s.cta_rows
    cols = J * bn
    assert s.col_ctas * s.cta_cols >= cols > (s.col_ctas - 1) * s.cta_cols
    assert not any(f.name.startswith("split")
                   for f in dataclasses.fields(s))
    return s


@pytest.mark.parametrize("seed", range(6))
def test_fma_launch_covers_the_output_once(seed):
    for case in fma_cases(seed, 300):
        check_fma(*case, sms=132)


@pytest.mark.parametrize("sms", [1, 8, 132, 100000])
def test_fma_launch_any_card_size(sms):
    for case in fma_cases(sms, 150):
        s = check_fma(*case, sms=sms)
        if sms == 1:            # every shape fills one SM: the largest CTA
            assert s.row_warps * s.col_warps == dispatch.FMA_MAX_WARPS


def test_fma_launch_is_a_pure_function_of_the_shape():
    dispatch.fma_launch.cache_clear()
    first = [dispatch.fma_launch(*c) for c in fma_cases(7, 200)]
    dispatch.fma_launch.cache_clear()
    assert first == [dispatch.fma_launch(*c) for c in fma_cases(7, 200)]


@pytest.mark.parametrize("rows,J", [(0, 4), (5, 0), (-1, 3)])
def test_fma_launch_nothing_to_write(rows, J):
    assert dispatch.fma_launch(rows, J, (64, 64, 16)) is None


# the GNN path on full-size CiteSeer (3327 vertices, 3703 features, hidden
# 16): the Aggregates at (64, 64, 16), the Updates at (16, 16, 16)
@pytest.mark.parametrize("rows,J,block,want", [
    # A_mean @ H0: 208 x 58 CTAs of 4 warps of 16 x 16 along the columns
    # (the 4 warps read the same x rows)
    (3328, 232, (64, 64, 16), (16, 1, 4, 208, 58)),
    (3327, 232, (64, 64, 16), (16, 1, 4, 208, 58)),
    # H0 @ W and A_mean @ H1 (16 wide): 8-row warps so that 416 of them
    # run, two per CTA so that the CTAs cover the card
    (3328, 1, (16, 16, 16), (8, 2, 1, 208, 1)),
    (3328, 1, (64, 64, 16), (8, 2, 1, 208, 1)),
])
def test_gnn_launch_shapes(rows, J, block, want):
    s = dispatch.fma_launch(rows, J, block, 132)
    assert (s.warp_rows, s.row_warps, s.col_warps, s.row_ctas,
            s.col_ctas) == want


@pytest.mark.parametrize("m,K,bk,words", [
    (3327, 52, 64, 208 * 52),        # 4 slices per k-block: one word
    (3327, 1, 3328, 208 * 7),        # 208 slices: 7 words
    (17, 3, 512, 8),                 # 32 slices: one word (6, to 16 bytes)
    (17, 3, 528, 2 * 3 * 2),         # 33 slices: two
    (0, 5, 64, 0)])
def test_fma_scratch_holds_a_word_per_32_slices(m, K, bk, words):
    assert dispatch.fma_scratch(m, K, bk, 16, True, True) == (words, 0, 0)


@pytest.mark.parametrize("x_aligned,y_aligned", [(True, True), (False, True),
                                                 (True, False),
                                                 (False, False)])
def test_fma_scratch_stages_only_unaligned_operands(x_aligned, y_aligned):
    """A_mean @ H0 on CiteSeer: x's nonzero tiles get room (one 16 x 16
    tile per 16-row tile and k slice) only when x's rows are unaligned;
    y's padded rows (3703 -> 3704 floats) only when y's are."""
    words, x_tiles, y_cols = dispatch.fma_scratch(3327, 52, 64, 3703,
                                                  x_aligned, y_aligned)
    assert words == 208 * 52
    assert x_tiles == (0 if x_aligned else 208 * (52 * 4) * 256)
    assert y_cols == (0 if y_aligned else 3704)


def gemm_cases(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        m, nn = (16 * int(v) for v in rng.integers(1, 400, size=2))
        yield m, nn


@pytest.mark.parametrize("sms", [1, 132, 100000])
def test_gemm_launch_tiles(sms):
    for m, n in gemm_cases(sms, 400):
        t = gemm.gemm_launch(m, n, sms)
        assert t in gemm.TILES
        # the large tile exactly when it is no wider than the output and
        # still launches a CTA per SM
        assert (t == 128) == (n >= 128 and -(-m // 128) * -(-n // 128)
                              >= sms)


@pytest.mark.parametrize("m,n,tile", [
    (3328, 3712, 128),     # A_mean @ H0: 26 x 29 = 754 CTAs of 128 x 128
    (3328, 16, 16),        # the Updates and A @ H1: 208 CTAs of 16 x 16
    (784, 784, 16), (1552, 1552, 128), (16, 16, 16)])
def test_gemm_launch_gnn_shapes(m, n, tile):
    assert gemm.gemm_launch(m, n, 132) == tile


def test_gemm_cpu_is_the_plain_version():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(48, 32)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    assert torch.equal(gemm.gemm(x, y), gemm.gemm_plain(x, y))
