"""The row-CSR kernel's launch shape and the bf16 routes, on the CPU.

``csr_spmm.csr_launch`` is a pure function of (rows, width, slot cap, SMs);
warp u of a launch takes the unit the kernel derives from u (heavy units of
one rank and a 32-column strip first, then light units of ``32 // group``
ranks over a strip of ``strip_cols`` columns).  Every (rank, column) of
the output must be covered exactly once, a row's slots are never split,
and 16-wide outputs leave no lane idle.  The kernel itself is held
against ``gemm`` bitwise on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The bf16 routes (``ops.csr_spmm``, the format-aware executor and the static
strategies, which now walk the bf16 ``dispatch``'s plain version on the
CPU) are held against the JAX package at the bf16 tolerance 5e-2
(``tests/test_kernels.py``); the reference's Pallas ``csr_spmm`` runs in
interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynasparse as j_dyn
from repro.core import formats as j_fmt
from repro.core.ir import KernelType as JKT
from repro.kernels import ops as j_ops
from repro_torch.core import dynasparse as t_dyn
from repro_torch.core import formats as t_fmt
from repro_torch.core.ir import KernelType as TKT
from repro_torch.kernels import csr_spmm, ops

BF16_TOL = dict(atol=5e-2, rtol=5e-2)


def units(s, m):
    """Yield (ranks, first column, columns) for each hub CTA and each warp
    that holds work, walking the grid as the kernel does; ranks lists one
    rank per lane (-1 for a lane without a row)."""
    for b in range(s.hub_ctas):
        rank, strip = divmod(b, s.hub_strips)
        yield [rank] * 32, strip * 32, 32
    groups = s.groups(m)
    for u in range((s.ctas - s.hub_ctas) * s.per_cta):
        if u < s.heavy_units:
            w, strip = divmod(u, s.heavy_strips)
            ranks = [s.hub_rows + w * s.rows_per_warp + lane // s.group
                     for lane in range(32)]
            yield ([r if r < s.heavy_rows else -1 for r in ranks],
                   strip * s.group, s.group)
            continue
        v = u - s.heavy_units
        if v >= groups * s.strips:
            continue                      # a warp past the last unit exits
        strip, g = divmod(v, groups)
        ranks = [s.heavy_rows + g * s.rows_per_warp + lane // s.group
                 for lane in range(32)]
        yield ([r if r < m else -1 for r in ranks], strip * s.strip_cols,
               s.strip_cols)


def coverage(s, m, n):
    hits = np.zeros((m, n), dtype=np.int64)
    for ranks, c0, width in units(s, m):
        for r in sorted(set(ranks) - {-1}):
            hits[r, c0:min(c0 + width, n)] += 1
    return hits


def check(m, n, cap, sms):
    s = csr_spmm.csr_launch(m, n, cap, sms)
    assert (s.group, s.strip_cols) == ((16, 16) if n <= 16 else (
        32, csr_spmm.LIGHT_COLS))
    assert 1 <= s.per_cta <= csr_spmm.MAX_WARPS
    assert s.ctas == s.hub_ctas + -(-s.units(m) // s.per_cta)
    assert bool(s.hub_rows) == (cap > csr_spmm.HUB_SLOTS // 2)
    if s.hub_rows:
        assert s.per_cta == csr_spmm.MAX_WARPS
        assert s.hub_rows == min(m, csr_spmm.HUB_ROWS)
        assert s.hub_strips == -(-n // 32)
    assert (s.strips - 1) * s.strip_cols < n <= s.strips * s.strip_cols
    assert s.heavy_rows <= min(m, csr_spmm.HEAVY_ROWS)
    assert bool(s.heavy_rows) == (cap > csr_spmm.LONG_SLOTS)
    if s.heavy_rows > s.hub_rows:
        assert s.heavy_strips == -(-n // s.group)
    assert (coverage(s, m, n) == 1).all()
    return s


def cases(seed, count):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        yield (int(rng.integers(1, 70)), int(rng.integers(1, 2500)),
               int(rng.choice([0, 3, 8, 9, 576])))


@pytest.mark.parametrize("seed", range(3))
def test_launch_covers_each_row_and_column_once(seed):
    for m, n, cap in cases(seed, 40):
        check(m, n, cap, sms=132)


@pytest.mark.parametrize("sms", [1, 8, 132, 100000])
def test_launch_any_card_size(sms):
    for m, n, cap in cases(sms, 25):
        s = check(m, n, cap, sms)
        if sms == 1:
            assert s.per_cta == csr_spmm.MAX_WARPS


def test_launch_is_a_pure_function_of_the_shape():
    shapes = list(cases(7, 60))
    csr_spmm.csr_launch.cache_clear()
    first = [csr_spmm.csr_launch(*sh) for sh in shapes]
    csr_spmm.csr_launch.cache_clear()
    assert first == [csr_spmm.csr_launch(*sh) for sh in shapes]


@pytest.mark.parametrize("m,n", [(0, 16), (16, 0), (-3, 32)])
def test_launch_nothing_to_write(m, n):
    assert csr_spmm.csr_launch(m, n, 576) is None


def test_hub_row_is_split_only_by_columns():
    """CiteSeer's first Aggregate (3327 rows, 3703 wide, rmax 576): the
    longest ranks walk 32-column strips, each unit one whole row."""
    m, n = 3327, 3703
    s = csr_spmm.csr_launch(m, n, 576, 132)
    assert (s.heavy_rows, s.heavy_strips, s.strips) == (48, 116, 4)
    assert (s.hub_rows, s.hub_strips, s.per_cta) == (4, 116, 4)
    hub = [(c0, w) for ranks, c0, w in units(s, m) if 0 in ranks]
    assert len(hub) == s.hub_strips
    for ranks, c0, w in units(s, m):
        if 0 in ranks:
            assert set(ranks) == {0} and w == 32
    assert s.heavy_units == 44 * 116
    cols = sorted(c for c0, w in hub for c in range(c0, min(c0 + w, n)))
    assert cols == list(range(n))
    # with short rows only, there are no heavy ranks
    assert csr_spmm.csr_launch(m, n, 8, 132).heavy_rows == 0


@pytest.mark.parametrize("m", [3327, 3328, 64, 2])
def test_sixteen_wide_launch_keeps_every_lane_busy(m):
    """The second Aggregate (16 wide): two rows a warp, 16 lanes each (the
    heavy ranks too), so every lane of every warp but an odd last one owns
    a real output; the hub units are CTAs of their own."""
    s = csr_spmm.csr_launch(m, 16, 576, 132)
    assert (s.group, s.rows_per_warp, s.strip_cols, s.hub_rows,
            s.heavy_rows) == (16, 2, 16, min(m, 4), min(m, 48))
    idle = [ranks.count(-1) for ranks, _, _ in list(units(s, m))[
        s.hub_ctas:]]
    assert sum(idle) == (m % 2) * 16
    assert (coverage(s, m, 16) == 1).all()


def sparse(seed, m, n, density):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n)).astype(np.float32)
    return x * (rng.random((m, n)) < density)


def bf16_pair(x):
    return torch.from_numpy(x).bfloat16(), jnp.asarray(x, dtype=jnp.bfloat16)


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


@pytest.mark.parametrize("shape", [(33, 40, 16), (20, 70, 17), (48, 30, 64)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5])
def test_bf16_csr_spmm_matches_pallas(shape, density):
    m, k, n = shape
    (xt, xj), (yt, yj) = bf16_pair(sparse(m, m, k, density)), bf16_pair(
        sparse(n, k, n, 0.5))
    got = ops.csr_spmm(xt, yt, rmax=k)
    want = j_ops.csr_spmm(xj, yj, rmax=k, bn=16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(as_np(got), as_np(want), **BF16_TOL)
    ell_t, ell_j = t_fmt.dense_to_ell(xt, 8), j_fmt.dense_to_ell(xj, 8)
    np.testing.assert_allclose(as_np(ops.csr_spmm(ell_t, yt)),
                               as_np(j_ops.csr_spmm(ell_j, yj, bn=16)),
                               **BF16_TOL)


@pytest.mark.parametrize("rmax,want_csr", [(40, 1), (3, 0)])
def test_bf16_format_aware_executor_matches_reference(rmax, want_csr):
    """The same ``fmt`` (CSR) and codes on both sides: the CSR route when
    every row fits ``csr_rmax``, else the block path."""
    m, k, n = 40, 36, 24
    (xt, xj), (yt, yj) = bf16_pair(sparse(1, m, k, 0.1)), bf16_pair(
        sparse(2, k, n, 0.6))
    block = (16, 16, 16)
    codes = np.random.default_rng(3).integers(
        0, 4, (3, 2, 3)).astype(np.int32)
    got = t_dyn.dynasparse_matmul(
        xt, yt, codes=torch.from_numpy(codes), block=block,
        fmt=torch.tensor(1, dtype=torch.int32), format_aware=True,
        csr_rmax=rmax)
    want = j_dyn.dynasparse_matmul(
        xj, yj, codes=jnp.asarray(codes), block=block,
        fmt=jnp.asarray(1, jnp.int32), format_aware=True, csr_rmax=rmax)
    assert int(got.fmt) == int(want.fmt) == want_csr
    assert got.out.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got.out), as_np(want.out), **BF16_TOL)
    np.testing.assert_array_equal(got.out_counts.numpy(),
                                  np.asarray(want.out_counts))


@pytest.mark.parametrize("strategy", ["gemm", "s1", "s2"])
@pytest.mark.parametrize("block", [(16, 16, 16), (32, 16, 64)])
def test_bf16_static_strategies_match_reference(strategy, block):
    """bf16 static grids take the bf16 dispatch route (its plain version
    here) and agree with the reference's executor."""
    m, k, n = 50, 40, 70
    (xt, xj), (yt, yj) = bf16_pair(sparse(4, m, k, 0.2)), bf16_pair(
        sparse(5, k, n, 0.5))
    got = t_dyn.dynasparse_matmul(xt, yt, strategy=strategy, block=block,
                                  kernel_type=TKT.AGGREGATE)
    want = j_dyn.dynasparse_matmul(xj, yj, strategy=strategy, block=block,
                                   kernel_type=JKT.AGGREGATE)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert got.out.dtype == torch.bfloat16 and got.out.shape == (m, n)
    np.testing.assert_allclose(as_np(got.out), as_np(want.out), **BF16_TOL)
