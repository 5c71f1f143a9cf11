"""The port's training inputs and gradients against the reference (CPU).

* ``TokenPipeline`` (``data/tokens.py``) bitwise the reference's, batches
  and stub frames, over seeds, steps and shards;
* ``dynasparse_matmul``'s gradient (``core/dynasparse.BlockMatmulFn``:
  one ``dispatch`` forward; backward ``dispatch_bwd``'s two products over
  the forward's grid on bf16 and float32 with every edge in {64, 128,
  256}, else two ``dispatch`` launches over the permuted code grid) against
  ``jax.grad`` of the reference's, with zero blocks planted
  in x and in w: float32 within 3e-4, bf16 within 5e-2 (relative to the
  largest gradient), and dx exactly 0 in every block the forward SKIPped,
  as the reference's ``lax.switch`` gives, where the dense ``g @ w.T`` is
  not;
* the refusals: a CUDA kernel with no backward under grad, flash on both
  devices (the reference's ``jax.grad`` through its flash kernel fails);
* one float32 train step of the smoke deepseek, whisper and xlstm
  (``torch_train_pairs.family_step``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import dynasparse as j_dyn
from repro.core.perf_model import TPUCostModel as JTPUCostModel
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.kernels import ops as j_ops
from repro.models import model_zoo as j_zoo
from repro_torch.configs import smoke_config
from repro_torch.core import dynasparse
from repro_torch.core.perf_model import Primitive, TPUCostModel
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import build, dispatch, dispatch_bwd, ops
from repro_torch.models import model_zoo
from torch_train_pairs import family_step


@pytest.mark.parametrize("seed,vocab,batch,seq", [
    (0, 256, 4, 32), (3, 1000, 8, 16), (7, 128256, 2, 64)])
def test_token_pipeline_is_bitwise_the_reference(seed, vocab, batch, seq):
    want, got = (JTokenPipeline(vocab, batch, seq, seed=seed),
                 TokenPipeline(vocab, batch, seq, seed=seed))
    for step in (0, 1, 5, 1234):
        for shard, n_shards in ((0, 1), (0, 2), (1, 2)):
            a = want.batch_for_step(step, shard=shard, n_shards=n_shards)
            b = got.batch_for_step(step, shard=shard, n_shards=n_shards)
            assert set(a) == set(b) == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(b["tokens"][:, 1:],
                                          b["labels"][:, :-1])
        fa = want.frames_for_step(step, 24, shard=1, n_shards=2)
        fb = got.frames_for_step(step, 24, shard=1, n_shards=2)
        assert fb.dtype == np.float32 and fb.shape == (batch // 2, seq, 24)
        np.testing.assert_array_equal(fa, fb)
    with pytest.raises(ValueError):
        got.batch_for_step(0, n_shards=3 if batch % 3 else 5)


# ------------------------------------------------------------ dispatch VJP

def _operands(m, k, n, block, seed, sparse_rows):
    """x (m, k) and w (k, n) with one zero block planted in each, g (m, n);
    ``sparse_rows`` thins x's second block row to 5 % so that the planner
    picks SpDMM/SPMM steps there."""
    bm, bk, bn = block
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    x[:bm, bk:2 * bk] = 0
    w[:bk, bn:2 * bn] = 0
    if sparse_rows:
        x[bm:2 * bm] *= rng.random((bm, k)) < 0.05
    return x, w, g


def _grad_fns(fn):
    """Names of the autograd nodes reachable from ``fn``."""
    seen, stack, names = set(), [fn], set()
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        names.add(type(f).__name__)
        stack += [n for n, _ in f.next_functions]
    return names


CASES = [((70, 96, 80), (32, 32, 32), False),
         ((100, 64, 48), (32, 16, 16), True),
         ((40, 160, 300), (16, 64, 128), True),
         ((300, 320, 400), (128, 64, 256), True)]


@pytest.mark.parametrize("dtype,tol", [("float32", 3e-4),
                                       ("bfloat16", 5e-2)])
@pytest.mark.parametrize("shape,block,sparse_rows", CASES)
def test_dynasparse_grad_is_the_reference_masked_vjp(
        monkeypatch, dtype, tol, shape, block, sparse_rows):
    x, w, g = _operands(*shape, block, 11, sparse_rows)
    bm, bk, bn = block
    jdt = getattr(jnp, dtype)

    def ref(x_, w_):
        r = j_dyn.dynasparse_matmul(x_, w_, strategy="dynamic", block=block,
                                    cost_model=JTPUCostModel())
        return jnp.sum(r.out.astype(jnp.float32) * jnp.asarray(g)), r.codes

    (_, jcodes), (jgx, jgw) = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(jnp.asarray(x, jdt),
                                          jnp.asarray(w, jdt))

    calls = []
    for mod, name in ((dispatch, "block_matmul"),
                      (dispatch, "block_matmul_nn"),
                      (dispatch_bwd, "block_matmul_nt"),
                      (dispatch_bwd, "block_matmul_tn")):
        def spy(x_, y_, codes, blk, _real=getattr(mod, name), _name=name,
                **kw):
            calls.append((_name, tuple(x_.shape), tuple(y_.shape), blk,
                          sorted(set(codes.flatten().tolist()))))
            return _real(x_, y_, codes, blk, **kw)

        monkeypatch.setattr(mod, name, spy)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    res = dynasparse.dynasparse_matmul(tx, tw, strategy="dynamic",
                                       block=block,
                                       cost_model=TPUCostModel())
    np.testing.assert_array_equal(res.codes.numpy(), np.asarray(jcodes))
    assert "BlockMatmulFnBackward" in _grad_fns(res.out.grad_fn)
    (res.out.float() * torch.from_numpy(g)).sum().backward()
    # one forward launch (float32 at every edge in {64, 128, 256} on the
    # tiled block_matmul_nn, else the walk), then dx and dw: on bf16 and
    # float32 grids at those edges dispatch_bwd's two products over the
    # forward's codes, else two dispatch launches over the permuted grids,
    # whose codes are GEMM wherever the forward ran a step
    m, k = x.shape
    n = w.shape[1]
    if dispatch_bwd.takes(tdt, block):
        forward = ("block_matmul_nn" if tdt == torch.float32
                   else "block_matmul")
        assert [c[:4] for c in calls] == [
            (forward, (m, k), (k, n), block),
            ("block_matmul_nt", (m, n), (k, n), block),
            ("block_matmul_tn", (m, k), (m, n), block)]
        assert calls[1][4] == calls[2][4] == calls[0][4]
    else:
        assert [c[:4] for c in calls] == [
            ("block_matmul", (m, k), (k, n), block),
            ("block_matmul", (m, n), (n, k), (bm, bn, bk)),
            ("block_matmul", (k, m), (m, n), (bk, bm, bn))]
        assert set(calls[1][4]) <= {0, 1} and set(calls[2][4]) <= {0, 1}
    if sparse_rows:
        assert set(np.unique(np.asarray(jcodes))) & {2, 3}
    for got, want in ((tx.grad, jgx), (tw.grad, jgw)):
        assert got.dtype == tdt
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= tol, err
    # the SKIPped block (0, 1) of x: the reference's gradient and the
    # port's are exactly 0 there, the dense one is not
    skipped = np.asarray(jcodes)[0, :, 1] == Primitive.SKIP
    assert skipped.all()
    assert np.all(tx.grad.float().numpy()[:bm, bk:2 * bk] == 0)
    assert np.all(np.asarray(jgx, np.float32)[:bm, bk:2 * bk] == 0)
    assert np.abs((g @ w.T)[:bm, bk:2 * bk]).max() > 1.0
    # w's zero block (0, 1) is SKIPped by every row block: dw is 0 there
    assert np.all(tw.grad.float().numpy()[:bk, bn:2 * bn] == 0)


def test_dynasparse_without_grad_takes_no_function():
    x, w, _ = _operands(70, 96, 80, (32, 32, 32), 2, False)
    tx = torch.from_numpy(x)
    out = dynasparse.dynasparse_matmul(tx, torch.from_numpy(w),
                                       block=(32, 32, 32)).out
    assert out.grad_fn is None
    with torch.no_grad():
        out = dynasparse.dynasparse_matmul(
            tx.requires_grad_(), torch.from_numpy(w), block=(32, 32, 32)).out
    assert out.grad_fn is None


def test_backward_blocks_must_suit_the_kernel():
    """On CUDA the permuted grids take every edge as a row or column edge
    of the kernel: a 48-deep k-block has no backward."""
    dynasparse._check_backward_block((256, 256, 256))
    dynasparse._check_backward_block((32, 16, 128))
    with pytest.raises(ValueError, match="no backward"):
        dynasparse._check_backward_block((64, 48, 64))


def test_a_kernel_without_backward_refuses_a_gradient():
    """``build.refuse_grad`` guards every CUDA route but ``dispatch``'s
    Function: under grad with an operand that requires one it raises,
    otherwise it lets the launch go."""
    a = torch.ones(4, requires_grad=True)
    b = torch.ones(4)
    build.refuse_grad("gemm", b, b)
    with torch.no_grad():
        build.refuse_grad("gemm", a, b)
    with pytest.raises(ValueError, match="gemm: the kernel has no "
                                         "backward"):
        build.refuse_grad("gemm", b, a)


def test_flash_refuses_a_gradient_as_the_reference_does():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 4, 16, 16)).astype(np.float32)
    kv = rng.normal(size=(1, 2, 16, 16)).astype(np.float32)
    with pytest.raises(AssertionError):   # the reference's kernel: no VJP
        jax.grad(lambda q_: j_ops.flash_attention(
            q_, jnp.asarray(kv), jnp.asarray(kv), causal=True).sum())(
                jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(kv)
    with pytest.raises(ValueError, match="no backward"):
        ops.flash_attention(tq, tkv, tkv, causal=True)
    with torch.no_grad():     # forward only still runs
        assert ops.flash_attention(tq, tkv, tkv, causal=True).shape == \
            q.shape
    # and through the model: a flash loss has no gradient in either package
    cfg = dataclasses.replace(smoke_config("llama3.2-1b", n_layers=1),
                              attn_impl="flash", dtype="float32")
    bundle = model_zoo.build(cfg, device="cpu")
    params = bundle.init_params(0)
    params["embed"].requires_grad_()
    toks = torch.from_numpy(rng.integers(0, 512, (1, 16)))
    with pytest.raises(ValueError, match="no backward"):
        bundle.loss_fn(params, {"tokens": toks, "labels": toks})
    jcfg = dataclasses.replace(j_smoke("llama3.2-1b", n_layers=1),
                               attn_impl="flash", dtype="float32")
    jb = j_zoo.build(jcfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    jt = jnp.asarray(toks.numpy(), jnp.int32)
    with pytest.raises(AssertionError):
        jax.grad(jb.loss_fn)(jp, {"tokens": jt, "labels": jt})


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "whisper-large-v3",
                                  "xlstm-125m"])
def test_one_float32_step_of_each_family(arch):
    """One float32 train step of the family's smoke config against the
    reference's jitted one (``torch_train_pairs.family_step``; jamba:
    ``tests/test_torch_train_loop.py``)."""
    family_step(arch)
