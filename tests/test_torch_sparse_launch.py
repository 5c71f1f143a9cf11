"""The block-sparse kernels' launch shapes, on the CPU.

``spdmm.spdmm_launch`` (the wide route of 16 x 128 CTAs or the warp route)
and ``spmm.spmm_launch`` are pure functions of the output's shape, and
``spdmm.row_order_plain`` puts the tile-rows longest first.  Unit w of a
launch covers row unit ``w // col_units`` of that order and column unit
``w % col_units``, as the kernels read it; every output must be covered
exactly once and k is never split, so the shape changes no output's bits.  The
kernels themselves are checked on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``; on CPU tensors the wrappers are their plain
versions, held here against the JAX package's Pallas kernels in interpret
mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.core import formats
from repro_torch.kernels import ops, spdmm, spmm

TOL = dict(atol=3e-4, rtol=3e-4)
LAUNCHES = {"spdmm": (spdmm.spdmm_launch, spdmm.MAX_WARPS),
            "spmm": (spmm.spmm_launch, spmm.MAX_WARPS)}


def covered(s, order, tm, rows, n):
    """How many units cover each 8-row x 16-column cell of the output,
    walking the launch as the kernels do."""
    hits = np.zeros((rows // 8, -(-n // 16)), dtype=np.int64)
    subs = tm // s.unit_rows
    for w in range(s.ctas * s.per_cta):
        if w >= s.row_units * s.col_units:
            continue                      # a warp past the last unit exits
        rank, cu = divmod(w, s.col_units)
        r0 = int(order[rank // subs]) * tm + rank % subs * s.unit_rows
        c0 = cu * s.unit_cols
        hits[r0 // 8:(r0 + s.unit_rows) // 8,
             c0 // 16:min(c0 + s.unit_cols, n) // 16] += 1
    return hits


def cases(seed, count):
    """(mb, tm, n) output shapes: tile edges and widths multiples of 16."""
    rng = np.random.default_rng(seed)
    for _ in range(count):
        tm = 16 * int(rng.integers(1, 9))
        mb = int(rng.integers(1, 40))
        n = 16 * int(rng.integers(1, 40))
        yield mb, tm, n


def check(kind, mb, tm, n, sms, seed=0):
    launch, max_warps = LAUNCHES[kind]
    s = launch(mb * tm, n, sms)
    assert s.unit_rows in (8, 16) and tm % s.unit_rows == 0
    assert s.row_units * s.unit_rows == mb * tm
    assert (s.col_units - 1) * s.unit_cols < n <= s.col_units * s.unit_cols
    if s.wide:
        assert kind == "spdmm" and n >= spdmm.WIDE_COLS
        assert s.unit_rows == 16 and s.per_cta == 1
    else:
        assert s.unit_cols == spdmm.WARP_COLS
        assert 1 <= s.per_cta <= max_warps
    assert s.ctas == -(-s.row_units * s.col_units // s.per_cta)
    counts = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 5, mb).astype(np.int32))
    order = spdmm.row_order_plain(counts).numpy()
    assert (covered(s, order, tm, mb * tm, n) == 1).all()
    assert not any(f.name.startswith("split")
                   for f in dataclasses.fields(s))
    return s


@pytest.mark.parametrize("kind", sorted(LAUNCHES))
@pytest.mark.parametrize("seed", range(3))
def test_launch_covers_the_output_once(kind, seed):
    for i, (mb, tm, n) in enumerate(cases(seed, 60)):
        check(kind, mb, tm, n, sms=132, seed=i)


@pytest.mark.parametrize("kind", sorted(LAUNCHES))
@pytest.mark.parametrize("sms", [1, 8, 132, 100000])
def test_launch_any_card_size(kind, sms):
    for mb, tm, n in cases(sms, 40):
        s = check(kind, mb, tm, n, sms)
        if sms == 1 and not s.wide:     # one SM: the largest CTA
            assert s.per_cta == LAUNCHES[kind][1]
        if sms == 100000:               # 16-row warps would not fill it
            assert s.unit_rows == (16 if s.wide else 8)


@pytest.mark.parametrize("kind", sorted(LAUNCHES))
def test_launch_is_a_pure_function_of_the_shape(kind):
    launch = LAUNCHES[kind][0]
    shapes = [(mb * tm, n) for mb, tm, n in cases(7, 100)]
    launch.cache_clear()
    first = [launch(*sh) for sh in shapes]
    launch.cache_clear()
    assert first == [launch(*sh) for sh in shapes]


@pytest.mark.parametrize("kind", sorted(LAUNCHES))
@pytest.mark.parametrize("rows,n", [(0, 16), (16, 0), (-16, 32)])
def test_launch_nothing_to_write(kind, rows, n):
    assert LAUNCHES[kind][0](rows, n) is None


@pytest.mark.parametrize("seed", range(4))
def test_row_order_is_a_long_rows_first_permutation(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 151, int(rng.integers(1, 300))).astype(np.int32)
    order = spdmm.row_order_plain(torch.from_numpy(counts))
    assert order.dtype == torch.int32
    o = order.numpy()
    assert sorted(o.tolist()) == list(range(len(counts)))
    assert (np.diff(counts[o]) <= 0).all()            # longest first
    for c in np.unique(counts):                       # ties in row order
        same = o[counts[o] == c]
        assert (np.diff(same) > 0).all()


# the GNN path on full-size CiteSeer (3327 vertices padded to 3328, 3703
# features padded to 3712, hidden 16), at 16 x 16 tiles
@pytest.mark.parametrize("kind,rows,n,want", [
    # A_mean @ H0 under s1/s2: 208 x 29 CTAs of 16 x 128
    ("spdmm", 3328, 3712, (16, 128, 208, 29, 1)),
    # the s2 Updates (Block-CSR(H0) @ W) and A_mean @ H1: 416 warps of 8
    # rows, two a CTA, so that 208 CTAs cover the card
    ("spdmm", 3328, 16, (8, 16, 416, 1, 2)),
    # the second Aggregate's and a 48-wide product: 16-row warps suffice
    ("spdmm", 3328, 48, (16, 16, 208, 3, 4)),
    # A_mean x H0 through ops.matmul(SPMM): 8 warps on neighbouring tiles
    ("spmm", 3328, 3712, (16, 16, 208, 232, 8)),
])
def test_gnn_launch_shapes(kind, rows, n, want):
    s = LAUNCHES[kind][0](rows, n, 132)
    assert (s.unit_rows, s.unit_cols, s.row_units, s.col_units,
            s.per_cta) == want


def sparse(seed, m, n, density):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n)).astype(np.float32)
    return x * (rng.random((m, n)) < density)


@pytest.mark.parametrize("tile", [(16, 16), (32, 32)])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.4])
def test_cpu_wrappers_are_the_plain_versions(tile, density):
    x = torch.from_numpy(sparse(1, 64, 96, density))
    y = torch.from_numpy(sparse(2, 96, 64, 0.3))
    xb = formats.dense_to_bcsr(x, tile)
    yb = formats.dense_to_bcsc(y, (tile[1], tile[1]))
    plan = spmm.plan_intersection(xb, yb)
    assert torch.equal(spdmm.spdmm(xb, y), spdmm.spdmm_plain(xb, y))
    assert torch.equal(spmm.spmm(xb, yb, plan), spmm.spmm_plain(xb, yb, plan))


@pytest.mark.parametrize("shape", [(48, 32, 16), (40, 70, 48), (64, 96, 144)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_cpu_wrappers_match_pallas(shape, density):
    """The narrow (16, 48) and wide (144) widths, against the reference's
    kernels run in interpret mode."""
    m, k, n = shape
    xn, yn = sparse(m + k, m, k, density), sparse(n, k, n, 0.4)
    xt, yt = torch.from_numpy(xn), torch.from_numpy(yn)
    xj, yj = jnp.asarray(xn), jnp.asarray(yn)
    pairs = [(ops.spdmm(xt, yt, tile=(16, 16), bn=16),
              j_ops.spdmm(xj, yj, tile=(16, 16), bn=16)),
             (ops.spmm(xt, yt, tile=(16, 16)),
              j_ops.spmm(xj, yj, tile=(16, 16)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
