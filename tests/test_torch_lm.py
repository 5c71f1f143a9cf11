"""The port's LM stack and its two LM kernels against the JAX package.

Same numpy inputs (from a seed) through both; the JAX side runs its Pallas
kernels as its own tests do (``repro.kernels.ops`` in interpret mode on
the CPU), the port its plain PyTorch versions (CPU tensors).  Params are
the reference's, carried over with ``model_zoo.params_from_reference``.
Tolerances: kernels f32 3e-5 (``tests/test_kernels.py:88``), bf16 5e-2;
layers f32 1e-5; whole forward f32 relative 1e-4, bf16 relative 3e-2
(``tests/test_models_smoke.py:85``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import dynasparse as j_dyn
from repro.core.perf_model import TPUCostModel as JTPU
from repro.kernels import ops as j_ops
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch.configs import smoke_config
from repro_torch.core import dynasparse as t_dyn
from repro_torch.core.perf_model import TPUCostModel
from repro_torch.kernels import ops, profile
from repro_torch.models import attention, layers, model_zoo, transformer


def rnd(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def t2np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- kernels --

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,skv,h,hkv", [
    (32, 32, 3, 3), (16, 64, 3, 3), (40, 64, 3, 3), (40, 40, 4, 2),
    (24, 40, 8, 2), (48, 32, 2, 2)])
def test_flash_attention_matches_pallas(causal, sq, skv, h, hkv):
    """GQA, front padding of q and kv (40 and 24 rows at bq = bk = 16) and
    rows with no visible key (sq > skv) all as the reference computes."""
    if not causal and skv % 16:
        with pytest.raises(ValueError, match="non-causal"):
            ops.flash_attention(torch.zeros(1, h, sq, 16),
                                torch.zeros(1, hkv, skv, 16),
                                torch.zeros(1, hkv, skv, 16), bq=16, bk=16)
        return
    q, k, v = (rnd(sq, 2, h, sq, 16), rnd(skv, 2, hkv, skv, 16),
               rnd(skv + 1, 2, hkv, skv, 16))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, bq=16,
                              bk=16)
    want = j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, bq=16, bk=16)
    np.testing.assert_allclose(t2np(got), np.asarray(want), atol=3e-5,
                               rtol=3e-5)


def test_flash_attention_default_blocks_bf16():
    q, k, v = rnd(1, 2, 4, 40, 32), rnd(2, 2, 2, 40, 32), rnd(3, 2, 2, 40, 32)
    got = ops.flash_attention(*(torch.from_numpy(a).bfloat16()
                                for a in (q, k, v)), causal=True)
    want = j_ops.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(t2np(got), np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,tile", [
    ((100, 70), (16, 16)), ((130, 50), (64, 16)), ((300, 520), (256, 256)),
    ((33, 7), (8, 128))])
def test_tile_nnz_exact(dtype, shape, tile):
    x = rnd(7, *shape) * (np.random.default_rng(8).random(shape) < 0.2)
    got = profile.tile_nnz(torch.from_numpy(x).to(getattr(torch, dtype)),
                           tile)
    want = j_ops.tile_nnz(jnp.asarray(x, dtype), tile=tile)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dynasparse_bf16_block256_matches_reference():
    """The LM's FFN call: bf16 operands, (256, 256, 256) blocks, the TPU
    cost model.  Codes and densities exact, values at bf16 tolerance."""
    x = rnd(11, 300, 520)
    x[:, 256:] *= np.random.default_rng(12).random((300, 264)) < 0.05
    w = rnd(13, 520, 600) * (np.random.default_rng(14).random((520, 600))
                             < 0.1)
    w[:256, 256:512] = 0.0
    kw = dict(strategy="dynamic", block=(256, 256, 256))
    got = t_dyn.dynasparse_matmul(torch.from_numpy(x).bfloat16(),
                                  torch.from_numpy(w).bfloat16(),
                                  cost_model=TPUCostModel(), **kw)
    want = j_dyn.dynasparse_matmul(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w, jnp.bfloat16),
                                   cost_model=JTPU(), **kw)
    assert got.out.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    assert len(np.unique(got.codes.numpy())) > 1
    np.testing.assert_array_equal(got.dens_x.numpy(), np.asarray(want.dens_x))
    np.testing.assert_array_equal(got.dens_y.numpy(), np.asarray(want.dens_y))
    np.testing.assert_allclose(t2np(got.out), np.asarray(want.out, np.float32),
                               atol=5e-2, rtol=5e-2)


# -------------------------------------------------------------- layers --

def test_rmsnorm_rope_mlp_match_reference():
    cfg = j_smoke("llama3.2-1b", dtype="float32")
    tcfg = smoke_config("llama3.2-1b", dtype="float32")
    x, scale = rnd(1, 2, 8, 128), rnd(2, 128) * 0.1
    np.testing.assert_allclose(
        t2np(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))),
        np.asarray(j_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-5, rtol=1e-5)
    pos = np.arange(3, 11)
    sin, cos = layers.rope_tables(torch.from_numpy(pos), 32, 5e5)
    jsin, jcos = j_layers.rope_tables(jnp.asarray(pos), 32, 5e5)
    np.testing.assert_allclose(t2np(sin), np.asarray(jsin), atol=1e-5)
    xr = rnd(3, 2, 8, 4, 32)
    for frac in (1.0, 0.5):
        np.testing.assert_allclose(
            t2np(layers.apply_rope(torch.from_numpy(xr), sin, cos, frac)),
            np.asarray(j_layers.apply_rope(jnp.asarray(xr), jsin, jcos,
                                           frac)), atol=1e-5, rtol=1e-5)
    p = {"w1": rnd(4, 128, 256) * 0.1, "w2": rnd(5, 256, 128) * 0.1,
         "w3": rnd(6, 128, 256) * 0.1}
    got = layers.mlp(torch.from_numpy(x),
                     {k: torch.from_numpy(v) for k, v in p.items()}, tcfg)
    want = j_layers.mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg)
    np.testing.assert_allclose(t2np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# --------------------------------------------------------------- model --

def pair(dtype="float32", **kw):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = j_smoke("llama3.2-1b", n_layers=2, dtype=dtype, **kw)
    tcfg = smoke_config("llama3.2-1b", n_layers=2, dtype=dtype, **kw)
    jp = j_tf.init_params(jcfg, jax.random.PRNGKey(0))
    tp = model_zoo.params_from_reference(to_np(jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def tokens(seed, b, s, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_forward_matches_reference_for_each_attn_impl(dtype, tol):
    toks = tokens(0, 2, 32)
    jcfg, tcfg, jp, tp = pair(dtype)
    for impl in ("einsum", "chunked", "flash"):
        jc = dataclasses.replace(jcfg, attn_impl=impl, attn_chunk=8)
        tc = dataclasses.replace(tcfg, attn_impl=impl, attn_chunk=8)
        want, _, _ = j_tf.forward(jc, jp, jnp.asarray(toks))
        got, _, _ = transformer.forward(tc, tp, torch.from_numpy(toks))
        assert got.dtype == tc.jdtype
        assert rel_err(t2np(got), want) < tol, impl


def test_loss_fn_matches_reference():
    jcfg, tcfg, jp, tp = pair()
    batch = {"tokens": tokens(1, 2, 32), "labels": tokens(2, 2, 32)}
    want = float(j_tf.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, batch)))
    got = float(transformer.loss_fn(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(got - want) < 1e-4, (got, want)


def test_stack_and_layers_layouts_carry_over_alike():
    jcfg, tcfg, jp, tp = pair()
    ju = dataclasses.replace(jcfg, scan_layers=False)
    tu = model_zoo.params_from_reference(to_np(_restack(jp)), tcfg,
                                         device="cpu")
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(tu)):
        assert torch.equal(a, b)
    toks = tokens(3, 2, 16)
    want, _, _ = j_tf.forward(ju, _restack(jp), jnp.asarray(toks))
    got, _, _ = transformer.forward(tcfg, tu, torch.from_numpy(toks))
    assert rel_err(t2np(got), want) < 1e-4


def _restack(jp):
    """The reference's scanned params, unrolled for its layers layout."""
    return dict({k: v for k, v in jp.items() if k != "stack"},
                layers=[jax.tree.map(lambda a, i=i: a[i], jp["stack"][0])
                        for i in range(2)])


@pytest.mark.parametrize("impl", ["chunked", "einsum"])
def test_prefill_and_decode_logits_match_reference(impl):
    jcfg, tcfg, jp, tp = pair(attn_impl=impl)
    toks = tokens(4, 2, 12)
    jl, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :11]), max_seq=16)
    tl, tc = transformer.prefill(tcfg, tp, torch.from_numpy(toks[:, :11]),
                                 max_seq=16)
    assert rel_err(t2np(tl), jl) < 1e-4
    jd, _ = j_tf.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 11:]),
                             jnp.int32(11))
    td, _ = transformer.decode_step(tcfg, tp, tc,
                                    torch.from_numpy(toks[:, 11:]), 11)
    assert rel_err(t2np(td), jd) < 1e-4
    # the decode step continues the prefill as the full forward does
    full, _, _ = transformer.forward(tcfg, tp, torch.from_numpy(toks))
    want = full[:, -1] @ transformer.lm_head(tcfg, tp).T
    assert rel_err(t2np(td), t2np(want)) < 1e-4


def test_flash_with_a_cache_is_refused_as_in_the_reference():
    jcfg, tcfg, jp, tp = pair(attn_impl="flash")
    toks = tokens(5, 1, 8)
    with pytest.raises(AssertionError):
        j_tf.prefill(jcfg, jp, jnp.asarray(toks), max_seq=16)
    with pytest.raises(ValueError, match="kv_len must be None"):
        transformer.prefill(tcfg, tp, torch.from_numpy(toks), max_seq=16)
    q = torch.zeros(1, 4, 4, 32)
    kv = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="kv_len"):
        attention.attend(q, kv, kv, tcfg, kv_len=4)
