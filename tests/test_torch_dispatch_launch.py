"""The bf16 dispatch route's launch shape (``dispatch.mma_launch``), on the
CPU: the host picks it from the rows that are really there, so it is a pure
function of the shapes; and the rows-only result (``pad_rows=False``) the
FFN asks for.  The kernel itself is checked on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch

BLOCKS = [(256, 256, 256), (128, 64, 256), (256, 32, 32), (64, 16, 128),
          (16, 16, 16), (32, 48, 64)]


def sweep(seed, n):
    """(m, I, J, K, block) cases: m from 1 to I * bm, ragged and exact."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        block = BLOCKS[rng.integers(len(BLOCKS))]
        I, J, K = (int(v) for v in rng.integers(1, 9, size=3))
        m = int(rng.integers(1, I * block[0] + 1))
        yield m, I, J, K, block


def check_shape(m, I, J, K, block, sms):
    bm, _, bn = block
    s = dispatch.mma_launch(m, I, J, K, block, sms)
    # row tiles cover m and nothing more: the last tile holds a real row
    assert s.cta_m in dispatch.MMA_ROWS and bm % s.cta_m == 0
    assert s.rows >= m and s.rows - s.cta_m < m
    assert s.rows <= I * bm
    # the columns are covered exactly, inside one block per CTA
    assert bn % s.cta_n == 0 and s.cta_n <= dispatch.MMA_COLS
    assert s.col_ctas * s.cta_n == J * bn
    # the k-blocks split into nonempty ranges, in order, covering [0, K)
    ranges = s.k_ranges(K)
    assert len(ranges) == s.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a < b for a, b in ranges)
    assert all(ranges[i][1] == ranges[i + 1][0]
               for i in range(len(ranges) - 1))
    # a split only when the tiles alone cannot fill the card
    tiles = s.row_ctas * s.col_ctas
    assert s.splits == 1 or tiles < sms
    return s


@pytest.mark.parametrize("seed", range(6))
def test_launch_shape_covers_rows_and_partitions_k(seed):
    for case in sweep(seed, 200):
        check_shape(*case, sms=132)


@pytest.mark.parametrize("sms", [1, 8, 132, 100000])
def test_launch_shape_any_card_size(sms):
    for case in sweep(sms, 100):
        s = check_shape(*case, sms=sms)
        if sms == 100000:      # never enough tiles: split every k-block
            assert s.splits == case[3]


@pytest.mark.parametrize("m", [0, -3])
def test_no_rows_no_launch(m):
    assert dispatch.mma_launch(m, 2, 32, 8, (256, 256, 256)) is None


@pytest.mark.parametrize("m,cta_m", [(1, 16), (4, 16), (16, 16), (17, 32),
                                     (33, 64), (65, 128), (300, 128),
                                     (512, 128)])
def test_row_tile_is_the_smallest_that_holds_m(m, cta_m):
    s = dispatch.mma_launch(m, 2, 32, 8, (256, 256, 256))
    assert (s.cta_m, s.row_ctas) == (cta_m, -(-m // cta_m))


def test_row_tile_never_crosses_a_block():
    s = dispatch.mma_launch(100, 4, 4, 4, (32, 16, 16))
    assert (s.cta_m, s.row_ctas, s.cta_n) == (32, 4, 16)


# the LM's FFN at (256, 256, 256): d_model 2048, d_ff 8192
@pytest.mark.parametrize("m,I,J,K,want", [
    (4, 1, 32, 8, (16, 128, 1, 64, 8)),       # decode, w1: 512 CTAs
    (4, 1, 8, 32, (16, 128, 1, 16, 32)),      # decode, w2: 512 CTAs
    (512, 2, 32, 8, (128, 128, 4, 64, 1)),    # prefill, w1: 256 CTAs
    (512, 2, 8, 32, (128, 128, 4, 16, 5)),    # prefill, w2: 320 CTAs
])
def test_lm_ffn_launch_shapes(m, I, J, K, want):
    s = dispatch.mma_launch(m, I, J, K, (256, 256, 256), 132)
    assert (s.cta_m, s.cta_n, s.row_ctas, s.col_ctas, s.splits) == want
    check_shape(m, I, J, K, (256, 256, 256), 132)


def test_single_k_block_is_never_split():
    s = dispatch.mma_launch(4, 1, 1, 1, (256, 256, 256))
    assert s.splits == 1 and s.k_ranges(1) == [(0, 1)]


@pytest.mark.parametrize("m,I,J,K", [(1, 1, 32, 8), (4, 1, 8, 32),
                                     (300, 2, 32, 8), (512, 2, 8, 32)])
def test_scratch_holds_x_flags_then_aligned_partials(m, I, J, K):
    block = (256, 256, 256)
    s = dispatch.mma_launch(m, I, J, K, block)
    flags, partials = dispatch._scratch_sizes(s, m, K * 256, J * 256)
    # one int32 flag per 16x16 tile of the real rows, padded to 16 bytes
    assert flags >= -(-m // 16) * (K * 16) and flags % 4 == 0
    assert flags - -(-m // 16) * (K * 16) < 4
    # a split's partials: x's m rows per split, else none
    assert partials == (s.splits * m * J * 256 if s.splits > 1 else 0)


def test_no_rows_no_scratch():
    assert dispatch._scratch_sizes(None, 0, 2048, 8192) == (0, 0)


@pytest.mark.parametrize("m", [1, 4, 17, 70])
@pytest.mark.parametrize("block", [(16, 16, 16), (32, 32, 16), (64, 16, 32)])
def test_rows_only_is_the_padded_product_cut_to_m(m, block):
    """``pad_rows=False`` returns x's m rows of the padded product (the
    FFN's call: the bf16 route then never writes the padding rows)."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(m, 90)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(90, 40)).astype(np.float32))
    bm, bk, bn = block
    codes = torch.from_numpy(rng.integers(0, 4, size=(
        -(-m // bm), -(-40 // bn), -(-90 // bk))).astype(np.int32))
    padded = dispatch.block_matmul(x, y, codes, block)
    rows = dispatch.block_matmul(x, y, codes, block, pad_rows=False)
    assert rows.shape == (m, padded.shape[1])
    assert torch.equal(rows, padded[:m]) and not padded[m:].any()
    flag = torch.tensor(1, dtype=torch.int32)
    skipped = dispatch.block_matmul(x, y, codes, block, skip=flag,
                                    pad_rows=False)
    assert skipped.shape == (m, padded.shape[1]) and not skipped.any()
    with pytest.raises(ValueError):     # out takes the padded shape only
        dispatch.block_matmul(x, y, codes, block, out=padded,
                              pad_rows=False)
