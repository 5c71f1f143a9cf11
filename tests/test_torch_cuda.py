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
from repro_torch.core.perf_model import Primitive
from repro_torch.kernels import dispatch, ops

TOL = dict(atol=3e-4, rtol=3e-4)


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
    assert all(v >= 1 for v in K.launch_counts().values())
