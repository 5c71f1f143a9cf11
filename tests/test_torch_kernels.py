"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; the reference runs
its Pallas kernels in interpret mode (``repro.kernels.ops``), at tile 16
and small shapes.  f32 tolerance 3e-4, as in ``tests/test_kernels.py``.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dynasparse as j_dyn
from repro.core.perf_model import Primitive as JPrim
from repro.kernels import ops as j_ops
from repro_torch.core.perf_model import Primitive as TPrim
from repro_torch.kernels import dispatch, ops

TOL = dict(atol=3e-4, rtol=3e-4)


def sparse(seed, m, n, density):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, n)).astype(np.float32)
    return x * (rng.random((m, n)) < density)


def both(x):
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("shape", [(16, 16, 16), (33, 7, 40), (64, 50, 32)])
@pytest.mark.parametrize("density", [0.0, 0.05, 0.4])
def test_primitives_match_pallas(shape, density):
    m, k, n = shape
    (xt, xj), (yt, yj) = both(sparse(m + k, m, k, density)), both(
        sparse(n, k, n, 0.4))
    pairs = [
        (ops.gemm(xt, yt, tile=(16, 16, 16)),
         j_ops.gemm(xj, yj, tile=(16, 16, 16))),
        (ops.spdmm(xt, yt, tile=(16, 16), bn=16),
         j_ops.spdmm(xj, yj, tile=(16, 16), bn=16)),
        (ops.spdmm(yt.T, xt.T, tile=(16, 16), bn=16, sparse_rhs=True),
         j_ops.spdmm(yj.T, xj.T, tile=(16, 16), bn=16, sparse_rhs=True)),
        (ops.spmm(xt, yt, tile=(16, 16)), j_ops.spmm(xj, yj, tile=(16, 16))),
        (ops.csr_spmm(xt, yt, rmax=k), j_ops.csr_spmm(xj, yj, rmax=k,
                                                      bn=16)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=str(i))


@pytest.mark.parametrize("prim", list(TPrim))
def test_matmul_dispatch_matches_pallas(prim):
    (xt, xj), (yt, yj) = both(sparse(1, 40, 24, 0.2)), both(
        sparse(2, 24, 20, 0.5))
    got = ops.matmul(xt, yt, prim, tile=(16, 16))
    want = j_ops.matmul(xj, yj, JPrim(int(prim)), tile=(16, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (40, 20)


@pytest.mark.parametrize("rmax", [2, 8])
def test_csr_spmm_prebuilt_ell_caps_at_rmax(rmax):
    """A prebuilt ELL view is used as given and rows over rmax are cut,
    as in the reference (``ops.py:83-99``)."""
    from repro.core import formats as j_fmt
    from repro_torch.core import formats as t_fmt
    (xt, xj), (yt, yj) = both(sparse(3, 30, 20, 0.3)), both(
        sparse(4, 20, 12, 0.6))
    got = ops.csr_spmm(t_fmt.dense_to_ell(xt, rmax), yt)
    want = j_ops.csr_spmm(j_fmt.dense_to_ell(xj, rmax), yj, bn=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("block", [(16, 16, 16), (32, 32, 16), (16, 32, 32)])
def test_block_path_matches_reference_dispatch(block):
    """The dispatch kernel's plain version equals the reference's block
    path run with the same code grid (``codes`` bypass, XLA dot path)."""
    m, k, n = 70, 90, 40
    (xt, xj), (yt, yj) = both(sparse(5, m, k, 0.1)), both(
        sparse(6, k, n, 0.3))
    bm, bk, bn = block
    shape = (-(-m // bm), -(-n // bn), -(-k // bk))
    codes = np.random.default_rng(7).integers(0, 4, shape).astype(np.int32)
    got = dispatch.block_matmul(xt, yt, torch.from_numpy(codes), block)
    want = j_dyn.dynasparse_matmul(xj, yj, codes=jnp.asarray(codes),
                                   block=block).out
    np.testing.assert_allclose(got[:m, :n].numpy(), np.asarray(want), **TOL)
    skipped = dispatch.block_matmul(xt, yt, torch.from_numpy(codes), block,
                                    skip=torch.tensor(1, dtype=torch.int32))
    assert torch.count_nonzero(skipped) == 0
