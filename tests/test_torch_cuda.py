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
    launched = K.launch_counts()
    assert all(launched[name] >= 1 for name in (
        "gemm", "spdmm", "spmm", "csr_spmm", "dispatch", "tile_nnz"))


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


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,sq,skv,bq,bk", [
    (True, 128, 128, 128, 128), (True, 40, 40, 16, 16),
    (False, 64, 128, 64, 128), (True, 80, 48, 16, 16),
    (True, 48, 40, 16, 8), (True, 300, 300, 128, 128)])
def test_flash_attention_kernel_matches_plain(cuda, d, causal, sq, skv, bq,
                                              bk):
    g = torch.Generator(device=cuda)
    g.manual_seed(d + sq)
    q = torch.randn((2, 8, sq, d), generator=g, device=cuda)
    k = torch.randn((2, 2, skv, d), generator=g, device=cuda)
    v = torch.randn((2, 2, skv, d), generator=g, device=cuda)
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
    tol = TOL if dtype == torch.float32 else dict(atol=5e-2, rtol=5e-2)
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
    params = prune_ffn(dense.init_params(0), 0.1)
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
