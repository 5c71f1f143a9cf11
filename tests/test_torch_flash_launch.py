"""The float32 flash kernel's launch shape (``flash_launch_f32``), a pure
function: every query row of every (b, h) is covered by exactly one CTA,
and the CTAs run longest first (the last query block of every (b, h)
before the one ahead of it), as ``csrc/flash_attention.cu`` orders them."""
import pytest

from repro_torch.kernels import flash_attention as fa


def processed(row, sq, skv, bq, bk):
    """Keys the reference processes for a causal query row (its kv-block
    skip, queries aligned to the end of the kv)."""
    q_end = (row // bq + 1) * bq - 1 + skv - sq
    return 0 if q_end < 0 else min(skv, (q_end // bk + 1) * bk)


@pytest.mark.parametrize("bh,sq", [(1, 1), (2, 40), (16, 128), (3, 300),
                                   (64, 2048), (5, 129)])
def test_every_row_once_longest_first(bh, sq):
    s = fa.flash_launch_f32(bh, sq)
    assert s.ctas == s.query_blocks * bh
    seen = {}
    lengths = []
    for cta in range(s.ctas):
        h, r0, r1 = s.cta_rows(cta)
        assert 0 <= h < bh and 0 <= r0 < r1 <= sq and r1 - r0 <= s.rows
        for r in range(r0, r1):
            assert (h, r) not in seen
            seen[(h, r)] = cta
        # the CTA's walk: the keys its last (longest) row processes
        lengths.append(processed(r1 - 1, sq, sq, 16, 16))
    assert len(seen) == bh * sq
    assert lengths == sorted(lengths, reverse=True)
    assert fa.flash_launch_f32(bh, sq) is s          # cached
