"""The port's flat COO/CSR formats, profiler helpers and host planners
against the JAX package.

Inputs are drawn with numpy from a seed and given to both packages.
Integers must be equal and values bitwise equal (float32 and bf16), but
for the named tolerances: ``dynasparse_dense_equivalent`` within 3e-4
(float32) and 5e-2 (bf16), two float32 matmul libraries summing in their
own order.  ``predict_output_density`` on float32 tensors is held
exactly: the port raises to an integer power by binary exponentiation,
as ``jnp`` does (``torch.pow`` is more than 1e-6 relative away after the
subtraction from 1).
The port's ``csr_to_ell`` leaves column ``k - 1`` in a row's empty slots,
as its ``dense_to_ell`` and the reference's ``dense_to_ell`` do; the
reference's ``csr_to_ell`` writes column 0 there.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analyzer as r_analyzer
from repro.core import dynasparse as r_dyn
from repro.core import formats as _r_formats
from repro.core import perf_model as r_pm
from repro.core import profiler as r_profiler
from repro_torch.core import analyzer as p_analyzer
from repro_torch.core import dynasparse as p_dyn
from repro_torch.core import formats as p_formats
from repro_torch.core import perf_model as p_pm
from repro_torch.core import profiler as p_profiler

# The reference's converters, each compiled as one program: they move
# integers and values without arithmetic (their adds add zeros), so
# compiled and op-by-op runs agree, and one compile per shape keeps the
# file inside its time.
r_formats = types.SimpleNamespace(
    dense_to_coo=jax.jit(_r_formats.dense_to_coo, static_argnums=1),
    dense_to_csr=jax.jit(_r_formats.dense_to_csr, static_argnums=1),
    dense_to_ell=jax.jit(_r_formats.dense_to_ell, static_argnums=1),
    csr_to_ell=jax.jit(_r_formats.csr_to_ell, static_argnums=1),
    dense_to_bcsr=jax.jit(_r_formats.dense_to_bcsr, static_argnums=1),
    **{f: jax.jit(getattr(_r_formats, f))
       for f in ("coo_to_dense", "coo_to_csr", "csr_to_coo",
                 "csr_to_dense", "_csr_rows", "ell_to_dense")})

# (shape, density, zero rows, dtype): ragged shapes, a single row and
# column, all-zero rows, an all-zero matrix, bf16 values
CASES = [((1, 17), 0.4, (), "float32"), ((23, 1), 0.5, (), "float32"),
         ((33, 7), 0.4, (3,), "float32"), ((33, 7), 0.4, (3,), "bfloat16"),
         ((16, 16), 0.3, (0, 15), "float32"),
         ((40, 24), 0.15, (7,), "bfloat16"), ((8, 12), 0.0, (), "float32")]


def _draw(shape, density, zero_rows, dtype, seed=0):
    """Float32 values on a sparse mask, rounded to bf16 first when asked,
    so both packages hold the same numbers."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    x *= rng.random(shape) < density
    x[list(zero_rows)] = 0.0
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
        return x, jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    return x, jnp.asarray(x), torch.from_numpy(x.copy())


def _np(a) -> np.ndarray:
    """A port tensor or a reference array as numpy, bf16 widened to float32
    (exact)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return a


def _same(got, want, what):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if g.dtype.kind == "f":
        assert g.dtype == w.dtype, (what, g.dtype, w.dtype)
        # bit patterns: -0.0 and 0.0 must not pass for each other
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=what)
    else:
        assert g.dtype == np.int32 and w.dtype == np.int32, (what, g.dtype)
        np.testing.assert_array_equal(g, w, err_msg=what)


def _same_coo(p, r):
    assert p.capacity == r.capacity and p.shape == tuple(r.shape)
    for f in ("rows", "cols", "values", "nnz"):
        _same(getattr(p, f), getattr(r, f), f)


def _same_csr(p, r):
    assert p.capacity == r.capacity and p.shape == tuple(r.shape)
    for f in ("indptr", "indices", "values"):
        _same(getattr(p, f), getattr(r, f), f)
    _same(p.nnz, r.nnz, "nnz")


def _capacities(x):
    nnz = int(np.count_nonzero(x))
    # default (m * n), exact (nnz; at least 1 slot), overflowing
    return [None, max(nnz, 1), max(nnz // 2, 1)]


@pytest.mark.parametrize("shape,density,zero_rows,dtype", CASES)
def test_dense_to_coo_and_back(shape, density, zero_rows, dtype):
    x, xr, xp = _draw(shape, density, zero_rows, dtype)
    for cap in _capacities(x):
        r, p = r_formats.dense_to_coo(xr, cap), p_formats.dense_to_coo(xp, cap)
        _same_coo(p, r)
        _same(p.density(), r.density(), "density")
        _same(p_formats.coo_to_dense(p), r_formats.coo_to_dense(r),
              f"coo_to_dense cap={cap}")
        _same(p_formats.coo_to_csr(p).indptr,
              r_formats.coo_to_csr(r).indptr, "coo_to_csr indptr")
        _same_csr(p_formats.coo_to_csr(p), r_formats.coo_to_csr(r))
    # the round trip is exact when nothing overflows (by value: the
    # input's -0.0 products come back as 0.0, in both packages)
    np.testing.assert_array_equal(
        _np(p_formats.coo_to_dense(p_formats.dense_to_coo(xp))), x)


@pytest.mark.parametrize("shape,density,zero_rows,dtype", CASES)
def test_dense_to_csr_and_back(shape, density, zero_rows, dtype):
    x, xr, xp = _draw(shape, density, zero_rows, dtype, seed=1)
    for cap in _capacities(x):
        r, p = r_formats.dense_to_csr(xr, cap), p_formats.dense_to_csr(xp, cap)
        _same_csr(p, r)
        _same(p.density(), r.density(), "density")
        _same(p_formats._csr_rows(p), r_formats._csr_rows(r), "_csr_rows")
        _same(p_formats.csr_to_dense(p), r_formats.csr_to_dense(r),
              f"csr_to_dense cap={cap}")
        _same_coo(p_formats.csr_to_coo(p), r_formats.csr_to_coo(r))
    np.testing.assert_array_equal(
        _np(p_formats.csr_to_dense(p_formats.dense_to_csr(xp))), x)


def test_csr_capacity_clamp_drops_trailing():
    """The reference's clamp case (tests/test_formats.py:182) in the port."""
    c = p_formats.dense_to_csr(torch.ones((4, 4)), capacity=10)
    assert int(c.nnz) == 10 and c.indptr.tolist() == [0, 4, 8, 10, 10]
    back = p_formats.csr_to_dense(c)
    assert bool((back[:2] == 1).all()) and bool((back[2, :2] == 1).all())
    assert bool((back[2, 2:] == 0).all()) and bool((back[3] == 0).all())


def test_coo_capacity_overflow_drops_into_pad():
    """The reference's overflow case (tests/test_formats.py:281)."""
    coo = p_formats.dense_to_coo(torch.ones((4, 4)), capacity=8)
    assert int(coo.nnz) == 8 and tuple(coo.rows.shape) == (8,)
    assert coo.rows.dtype == coo.cols.dtype == torch.int32


@pytest.mark.parametrize("shape,density,zero_rows,dtype", CASES)
@pytest.mark.parametrize("rmax", [1, 8])
def test_csr_to_ell(shape, density, zero_rows, dtype, rmax):
    x, xr, xp = _draw(shape, density, zero_rows, dtype, seed=2)
    caps = _capacities(x)
    for cap in (caps[0], caps[2]):          # default and overflowing
        r = r_formats.csr_to_ell(r_formats.dense_to_csr(xr, cap), rmax)
        p = p_formats.csr_to_ell(p_formats.dense_to_csr(xp, cap), rmax)
        _same(p.values, r.values, "values")
        _same(p.row_counts, r.row_counts, "row_counts")
        filled = (np.arange(rmax)[None, :]
                  < np.minimum(_np(r.row_counts), rmax)[:, None])
        pc, rc = _np(p.cols), _np(r.cols)
        np.testing.assert_array_equal(pc[filled], rc[filled])
        # empty slots: the reference writes 0, the port dense_to_ell's k - 1
        assert np.all(rc[~filled] == 0)
        assert np.all(pc[~filled] == shape[1] - 1)
        _same(p_formats.ell_to_dense(p), r_formats.ell_to_dense(r),
              "ell_to_dense")
    # no capacity cut: the port's two converters give one ELLMatrix, and
    # the reference's dense_to_ell the same integers
    via = p_formats.csr_to_ell(p_formats.dense_to_csr(xp), rmax)
    direct = p_formats.dense_to_ell(xp, rmax)
    r_direct = r_formats.dense_to_ell(xr, rmax)
    for f in ("values", "cols", "row_counts"):
        _same(getattr(via, f), getattr(direct, f), f)
        _same(getattr(via, f), getattr(r_direct, f), f"reference {f}")


@pytest.mark.parametrize("shape,tile", [((40, 24), (8, 8)), ((33, 7), (4, 4)),
                                        ((16, 16), (16, 16)),
                                        ((8, 12), (4, 4))])
def test_block_csr_tile_density(shape, tile):
    x, xr, xp = _draw(shape, 0.05, (), "float32", seed=3)
    r, p = r_formats.dense_to_bcsr(xr, tile), p_formats.dense_to_bcsr(xp, tile)
    _same(p.tile_density(), r.tile_density(), "tile_density")


# (shape, block, tile, dtype): ragged edges, blocks of a non-power-of-two
# tile count (the reference's mean multiplies by the reciprocal), bf16
PROFILE_CASES = [((40, 24), (16, 8), (4, 4), "float32"),
                 ((33, 7), (9, 3), (3, 1), "bfloat16"),
                 ((64, 48), (12, 12), (4, 4), "float32"),
                 ((16, 16), (16, 16), (16, 16), "bfloat16"),
                 ((50, 70), (15, 21), (5, 7), "float32")]


@pytest.mark.parametrize("shape,block,tile,dtype", PROFILE_CASES)
def test_tile_profiles(shape, block, tile, dtype):
    x, xr, xp = _draw(shape, 0.04, (0,), dtype, seed=4)
    _same(p_profiler.tile_occupancy(xp, tile),
          r_profiler.tile_occupancy(xr, tile), "tile_occupancy")
    _same(p_profiler.block_tile_density(xp, block, tile),
          r_profiler.block_tile_density(xr, block, tile),
          "block_tile_density")
    mask = (np.random.default_rng(5).random(shape) < 0.5).astype(np.float32)
    _same(p_profiler.block_density_from_mask(torch.from_numpy(mask), block),
          r_profiler.block_density_from_mask(jnp.asarray(mask), block),
          "block_density_from_mask")


def test_profiler_tile_occupancy_is_not_the_dispatch_one():
    from repro_torch.kernels import dispatch
    x = torch.zeros((32, 32))
    x[0, 0] = 1.0
    assert p_profiler.tile_occupancy(x, (16, 16)).dtype == torch.float32
    assert dispatch.tile_occupancy(x).dtype == torch.uint8


def _densities(rng, shape):
    """Block densities with exact zeros, ones, the thresholds (0.5 and
    2/p_sys = 0.125) and their float32 neighbours."""
    pts = np.array([0.0, 1.0, 0.5, 0.125, np.nextafter(0.5, 0),
                    np.nextafter(0.125, 0), np.nextafter(0.125, 1),
                    1 / 256, 1 / 4096, 0.97265625], np.float64)
    d = rng.random(shape)
    pick = rng.random(shape) < 0.4
    d[pick] = rng.choice(pts, size=int(pick.sum()))
    return d


MODELS = [("fpga", r_pm.FPGACostModel(), p_pm.FPGACostModel()),
          ("tpu", r_pm.TPUCostModel(), p_pm.TPUCostModel())]


@pytest.mark.parametrize("name,rmodel,pmodel", MODELS)
@pytest.mark.parametrize("seed", range(3))
def test_plan_kernel_and_histogram(name, rmodel, pmodel, seed):
    rng = np.random.default_rng(seed)
    dx, dy = _densities(rng, (5, 7)), _densities(rng, (7, 4))
    dims = (16, 32, 16) if name == "fpga" else (128, 128, 128)
    r = r_analyzer.plan_kernel(rmodel, dx, dy, dims)
    p = p_analyzer.plan_kernel(pmodel, dx, dy, dims)
    assert len(p) == len(r) == 5 * 4
    for a, b in zip(p, r):
        assert (a.i, a.k) == (b.i, b.k)
        np.testing.assert_array_equal(a.primitives, b.primitives)
        assert a.primitives.dtype == np.int32
        np.testing.assert_array_equal(a.sparse_is_lhs, b.sparse_is_lhs)
        assert a.est_cost == b.est_cost
        assert a.skipped == b.skipped
    np.testing.assert_array_equal(p_analyzer.primitive_histogram(p),
                                  r_analyzer.primitive_histogram(r))
    one = p_analyzer.plan_task(pmodel, dx[2], dy[:, 1], dims, i=2, k=1)
    ref = r_analyzer.plan_task(rmodel, dx[2], dy[:, 1], dims, i=2, k=1)
    assert one.est_cost == ref.est_cost
    np.testing.assert_array_equal(one.primitives, ref.primitives)


@pytest.mark.parametrize("name,rmodel,pmodel", MODELS)
@pytest.mark.parametrize("strategy", ["dynamic", "s1", "s2", "gemm"])
def test_plan_kernel_host(name, rmodel, pmodel, strategy):
    """The simulator's planner from float64 host densities: the port rounds
    them to float32 as the reference's jnp does, so codes near a threshold
    agree; chunking over output rows changes nothing."""
    from repro.core.ir import KernelType as RK
    from repro_torch.core.ir import KernelType as PK
    rng = np.random.default_rng(7)
    dx, dy = _densities(rng, (9, 6)), _densities(rng, (6, 5))
    for chunk in (2e6, 40):
        rc, rcost = r_analyzer.plan_kernel_host(
            strategy, dx, dy, (16, 16, 16), rmodel,
            kernel_type=RK.AGGREGATE, chunk_elems=chunk)
        pc, pcost = p_analyzer.plan_kernel_host(
            strategy, dx, dy, (16, 16, 16), pmodel,
            kernel_type=PK.AGGREGATE, chunk_elems=chunk, device="cpu")
        np.testing.assert_array_equal(pc, rc)
        assert pc.dtype == np.int32 and pcost.dtype == np.float64
        np.testing.assert_array_equal(pcost, rcost)


def test_predict_output_density():
    rng = np.random.default_rng(8)
    ax, ay = rng.random((6, 5)), rng.random((6, 5)) * 0.1
    for n in (1, 2, 16, 300, 1000):
        np.testing.assert_array_equal(p_pm.predict_output_density(ax, ay, n),
                                      r_pm.predict_output_density(ax, ay, n))
        assert (p_pm.predict_output_density(0.01, 0.2, n)
                == r_pm.predict_output_density(0.01, 0.2, n))
        got = p_pm.predict_output_density(
            torch.from_numpy(ax.astype(np.float32)),
            torch.from_numpy(ay.astype(np.float32)), n)
        want = r_pm.predict_output_density(
            jnp.asarray(ax, jnp.float32), jnp.asarray(ay, jnp.float32), n)
        _same(got, want, f"n={n}")


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-4), ("bfloat16", 5e-2)])
def test_dynasparse_dense_equivalent(dtype, tol):
    _, xr, xp = _draw((40, 24), 0.3, (5,), dtype, seed=9)
    _, yr, yp = _draw((24, 18), 0.6, (), dtype, seed=10)
    got = p_dyn.dynasparse_dense_equivalent(xp, yp)
    want = r_dyn.dynasparse_dense_equivalent(xr, yr)
    assert got.dtype == xp.dtype and _np(want).shape == tuple(got.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
