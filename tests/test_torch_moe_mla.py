"""The port's MoE FFN and MLA attention against the JAX package's.

Same seeded numpy inputs and the reference's params through both.  MoE
routing (experts, kept choices, capacity slots) must be equal as
integers; the reference's integers are recomputed here with its own jnp
expressions (``repro/models/layers.py:149-171``), and its ``moe_ffn``
output is checked beside them.  Tolerances: float32 layers 1e-5; whole
forward relative 1e-4 (float32) and 3e-2 (bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch.configs import smoke_config
from repro_torch.models import attention, layers, transformer
from torch_lm_pairs import (BF16_BLOCKWISE, RNG, PinnedRouting,
                            blockwise_rel, decode_cfg, pair, rel_err, rnd,
                            t2np, to_torch, tokens)


def j_routing(x, p, cfg):
    """The reference's routing integers, by its own expressions."""
    m = cfg.moe
    d = cfg.d_model
    t = int(np.prod(x.shape[:-1]))
    xf = x.reshape(t, d)
    gsz = min(m.group_size, t)
    pad = (-t) % gsz
    if pad:
        xf = jnp.pad(xf, ((0, pad), (0, 0)))
    g = xf.shape[0] // gsz
    xg = xf.reshape(g, gsz, d)
    logits = jnp.einsum("gsd,de->gse", xg, p["router"].astype(x.dtype))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    gate_w, gate_i = jax.lax.top_k(probs, m.top_k)
    gate_w = gate_w / jnp.maximum(gate_w.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gate_i, m.n_experts, dtype=jnp.bfloat16)
    if pad:
        valid = (jnp.arange(g * gsz) < t).reshape(g, gsz)
        onehot = onehot * valid[..., None, None].astype(onehot.dtype)
    pos = jnp.cumsum(onehot.reshape(g, gsz * m.top_k, m.n_experts).astype(
        jnp.float32), axis=1)
    pos = pos.reshape(g, gsz, m.top_k, m.n_experts) * onehot - 1.0
    pos_k = jnp.max(pos, axis=-1).astype(jnp.int32)
    cap = j_layers.moe_capacity(m)
    keep = (pos_k >= 0) & (pos_k < cap)
    return {"gate_w": gate_w, "gate_i": gate_i, "pos": pos_k, "keep": keep,
            "slot": jnp.where(keep, pos_k, cap)}


def moe_case(arch, dtype=jnp.float32, **moe_kw):
    jcfg = j_smoke(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                             **moe_kw))
    tcfg = smoke_config(arch)
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                             **moe_kw))
    jp = j_layers.init_moe(RNG, jcfg, dtype)
    return jcfg, tcfg, jp


@pytest.mark.parametrize("arch,moe_kw,shape", [
    # grok smoke: 4 experts top-2, group 32; 33 tokens -> a padded group
    ("grok-1-314b", {}, (3, 11)),
    ("grok-1-314b", {"top_k": 1}, (2, 16)),
    ("grok-1-314b", {"capacity_factor": 0.25}, (2, 64)),      # drops
    ("grok-1-314b", {"group_size": 8, "capacity_factor": 0.6}, (5, 7)),
    ("deepseek-v2-lite-16b", {}, (2, 20)),                    # + shared
    ("deepseek-v2-lite-16b", {"n_experts": 6, "top_k": 3}, (1, 40)),
])
def test_moe_routing_and_output_match_reference(arch, moe_kw, shape):
    jcfg, tcfg, jp = moe_case(arch, **moe_kw)
    x = rnd(1, *shape, jcfg.d_model)
    want = j_routing(jnp.asarray(x), jp, jcfg)
    tp = to_torch(jp)
    xt = torch.from_numpy(x)
    m = tcfg.moe
    t = int(np.prod(shape))
    gsz = min(m.group_size, t)
    xf = torch.nn.functional.pad(xt.reshape(t, -1), (0, 0, 0, (-t) % gsz))
    got = layers.moe_routing(xf.reshape(-1, gsz, tcfg.d_model), tp, m, t)
    for name in ("gate_i", "pos", "keep", "slot"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), name)
    np.testing.assert_allclose(got["gate_w"].numpy(),
                               np.asarray(want["gate_w"]), atol=1e-6)
    out, aux = layers.moe_ffn(xt, tp, tcfg)
    jout, jaux = j_layers.moe_ffn(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(t2np(out), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(aux) - float(jaux)) < 1e-6, (float(aux), float(jaux))
    if "capacity_factor" in moe_kw and not tcfg.moe.n_shared:
        # dropped choices: tokens whose every choice was dropped are zero
        dropped = ~got["keep"].reshape(-1, m.top_k)[:t].any(1).numpy()
        assert dropped.any()
        zero = np.abs(np.asarray(jout)).reshape(t, -1).max(1) == 0
        np.testing.assert_array_equal(dropped, zero)


def test_moe_ties_go_to_the_lower_expert_as_in_jax_top_k():
    jcfg, tcfg, jp = moe_case("grok-1-314b", top_k=2)
    jp = dict(jp)
    r = np.array(jp["router"])
    r[:, 2] = r[:, 1]                 # experts 1 and 2 always tie
    r[:, 3] = r[:, 0]                 # and so do 0 and 3
    jp["router"] = jnp.asarray(r)
    x = rnd(2, 2, 16, jcfg.d_model)
    want = j_routing(jnp.asarray(x), jp, jcfg)
    got = layers.moe_routing(torch.from_numpy(x).reshape(1, 32, -1),
                             to_torch(jp), tcfg.moe, 32)
    gi = got["gate_i"].numpy()
    np.testing.assert_array_equal(gi, np.asarray(want["gate_i"]))
    # top-2 always takes a tied pair, the lower expert first
    assert (gi[..., 0] < gi[..., 1]).all()
    out, _ = layers.moe_ffn(torch.from_numpy(x), to_torch(jp), tcfg)
    jout, _ = j_layers.moe_ffn(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(t2np(out), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)


def test_moe_bf16_routing_and_shared_experts_under_dynasparse():
    """bf16 params: routing integers equal; the shared experts run
    through ``_linear`` (the Dynasparse path) when ``dynasparse_ffn``."""
    jcfg, tcfg, jp = moe_case("deepseek-v2-lite-16b", dtype=jnp.bfloat16)
    x = rnd(3, 2, 32, jcfg.d_model)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    tp = to_torch(jp)
    tp = {k: (v if k == "router" else
              jax.tree.map(lambda a: a.bfloat16(), v)) for k, v in tp.items()}
    want = j_routing(xj, jp, jcfg)
    got = layers.moe_routing(xt, tp, tcfg.moe, 64)
    for name in ("gate_i", "keep", "slot"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), name)
    jout, _ = j_layers.moe_ffn(xj, jp, jcfg)
    for ds in (False, True):
        tc = dataclasses.replace(tcfg, dynasparse_ffn=ds)
        out, _ = layers.moe_ffn(xt, tp, tc)
        assert out.dtype == torch.bfloat16
        assert rel_err(t2np(out), np.asarray(jout, np.float32)) < 3e-2


# ------------------------------------------------------------------ MLA --

def mla_case(seed=0, **kw):
    jcfg = j_smoke("deepseek-v2-lite-16b", dtype="float32", **kw)
    tcfg = smoke_config("deepseek-v2-lite-16b", dtype="float32", **kw)
    jp = j_attn.init_mla(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, tcfg, jp, to_torch(jp)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("impl", ["chunked", "einsum"])
def test_mla_prefill_and_cached_decode_match_reference(absorbed, impl):
    jcfg, tcfg, jp, tp = mla_case(attn_impl=impl, attn_chunk=4)
    x = rnd(4, 2, 12, jcfg.d_model, scale=0.5)
    pos = np.arange(12)
    kw = dict(absorbed=absorbed)
    # no cache: the whole sequence
    want, _ = j_attn.mla_attention(jnp.asarray(x), jp, jcfg,
                                   positions=jnp.asarray(pos), **kw)
    got, _ = attention.mla_attention(torch.from_numpy(x), tp, tcfg,
                                     positions=torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(t2np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # prefill 11 tokens into a 16-slot latent cache, then decode token 11
    m = jcfg.mla
    jc = {"ckv": jnp.zeros((2, 16, m.kv_lora_rank)),
          "krope": jnp.zeros((2, 16, m.qk_rope_dim))}
    tc = {k: torch.zeros(v.shape) for k, v in jc.items()}
    want, jc = j_attn.mla_attention(jnp.asarray(x[:, :11]), jp, jcfg,
                                    positions=jnp.asarray(pos[:11]),
                                    cache=jc, pos=0, **kw)
    got, tc2 = attention.mla_attention(
        torch.from_numpy(x[:, :11]), tp, tcfg,
        positions=torch.from_numpy(pos[:11]), cache=tc, pos=0, **kw)
    assert tc2 is tc                   # written in place
    np.testing.assert_allclose(t2np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for name in ("ckv", "krope"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-6, rtol=1e-6)
    want, jc = j_attn.mla_attention(jnp.asarray(x[:, 11:]), jp, jcfg,
                                    positions=jnp.asarray(pos[11:]),
                                    cache=jc, pos=jnp.int32(11), **kw)
    got, _ = attention.mla_attention(
        torch.from_numpy(x[:, 11:]), tp, tcfg,
        positions=torch.from_numpy(pos[11:]), cache=tc, pos=11, **kw)
    np.testing.assert_allclose(t2np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tc["ckv"].numpy(), np.asarray(jc["ckv"]),
                               atol=1e-6, rtol=1e-6)


def test_mla_absorbed_equals_non_absorbed_in_the_port():
    _, tcfg, _, tp = mla_case(seed=1)
    x = torch.from_numpy(rnd(5, 2, 9, tcfg.d_model, scale=0.5))
    pos = torch.arange(9)
    outs = []
    for absorbed in (False, True):
        m = tcfg.mla
        c = {"ckv": torch.zeros(2, 12, m.kv_lora_rank),
             "krope": torch.zeros(2, 12, m.qk_rope_dim)}
        a, _ = attention.mla_attention(x[:, :8], tp, tcfg,
                                       positions=pos[:8], cache=c, pos=0,
                                       absorbed=absorbed)
        b, _ = attention.mla_attention(x[:, 8:], tp, tcfg,
                                       positions=pos[8:], cache=c, pos=8,
                                       absorbed=absorbed)
        outs.append(torch.cat([a, b], 1))
    torch.testing.assert_close(outs[0], outs[1], atol=1e-5, rtol=1e-5)


def test_flash_refusals_stay():
    """MLA under flash raises in the port (the reference's flash branch
    fails on MLA's shapes where v is narrower than q); flash with a cache
    raises as before."""
    from repro.configs.base import MLACfg
    narrow = MLACfg(kv_lora_rank=32, qk_rope_dim=16, qk_nope_dim=16,
                    v_head_dim=16)
    jcfg, tcfg, jp, tp = mla_case(attn_impl="flash", mla=narrow)
    x = rnd(6, 1, 16, jcfg.d_model)
    pos = np.arange(16)
    with pytest.raises(Exception):
        j_attn.mla_attention(jnp.asarray(x), jp, jcfg,
                             positions=jnp.asarray(pos))
    for absorbed in (False, True):
        for cfg in (tcfg, smoke_config("deepseek-v2-lite-16b",
                                       attn_impl="flash")):
            p = tp if cfg is tcfg else to_torch(j_attn.init_mla(
                RNG, j_smoke("deepseek-v2-lite-16b"), jnp.float32))
            with pytest.raises(ValueError, match="flash"):
                attention.mla_attention(torch.from_numpy(x).to(cfg.jdtype),
                                        p, cfg, positions=torch.from_numpy(
                                            pos), absorbed=absorbed)
    _, tcfg, _, tp = pair("deepseek-v2-lite-16b", dtype="float32",
                          attn_impl="flash")
    with pytest.raises(ValueError, match="flash"):
        transformer.prefill(tcfg, tp, torch.from_numpy(tokens(1, 1, 8)),
                            max_seq=16)


# ---------------------------------------------------- deepseek and grok --

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_smoke_forward_prefill_decode_match_reference(arch, dtype, tol):
    """Dropless MoE.  float32: forward, aux loss, prefill and decode
    logits against the reference's.  bf16: grok's as well; deepseek's
    block by block (``torch_lm_pairs.BF16_BLOCKWISE``), and whole with its
    routing pinned in the next test.  In both, decode continues the
    prefill as the full forward does."""
    jcfg, tcfg, jp, tp = pair(arch, dtype=dtype, adjust=decode_cfg)
    toks = tokens(7, 2, 24)
    got, _, aux = transformer.forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == tcfg.jdtype
    tl, tc = transformer.prefill(tcfg, tp, torch.from_numpy(toks[:, :23]),
                                 max_seq=24)
    td, _ = transformer.decode_step(tcfg, tp, tc,
                                    torch.from_numpy(toks[:, 23:]), 23)
    full = got[:, -1] @ transformer.lm_head(tcfg, tp).T
    assert rel_err(t2np(td), t2np(full)) < tol
    if dtype == "bfloat16" and arch in BF16_BLOCKWISE:
        assert max(blockwise_rel(jcfg, tcfg, jp, tp, toks)) < tol
        return
    want, _, jaux = j_tf.forward(jcfg, jp, jnp.asarray(toks))
    assert rel_err(t2np(got), want) < tol
    assert abs(float(aux) - float(jaux)) <= tol * abs(float(jaux))
    jl, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :23]), max_seq=24)
    assert rel_err(t2np(tl), jl) < tol
    jd, _ = j_tf.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 23:]),
                             jnp.int32(23))
    assert rel_err(t2np(td), jd) < tol


def test_deepseek_bf16_matches_reference_with_routing_pinned():
    """bf16, dropless: the whole forward, prefill and decode logits
    against the reference's at 3e-2, every MoE call of the reference
    taking the port's top-k choices (``PinnedRouting``).  Unpinned the
    forward is 0.2 apart; the flips counted here are what moves it."""
    jcfg, tcfg, jp, tp = pair("deepseek-v2-lite-16b", dtype="bfloat16",
                              adjust=decode_cfg)
    toks = tokens(7, 2, 24)
    pin = PinnedRouting(jcfg, jp)
    with pin.port():
        got, _, _ = transformer.forward(tcfg, tp, torch.from_numpy(toks))
        tl, tc = transformer.prefill(tcfg, tp, torch.from_numpy(toks[:, :23]),
                                     max_seq=24)
        td, _ = transformer.decode_step(tcfg, tp, tc,
                                        torch.from_numpy(toks[:, 23:]), 23)
    with pin.reference():
        want, _, _ = j_tf.forward(pin.cfg, pin.params, jnp.asarray(toks))
        jl, jc = j_tf.prefill(pin.cfg, pin.params, jnp.asarray(toks[:, :23]),
                              max_seq=24)
        jd, _ = j_tf.decode_step(pin.cfg, pin.params, jc,
                                 jnp.asarray(toks[:, 23:]), jnp.int32(23))
    n_moe = tcfg.n_layers - tcfg.dense_first_n
    assert len(pin.flips) == 3 * n_moe
    rels = [rel_err(t2np(a), b) for a, b in ((got, want), (tl, jl), (td, jd))]
    print(f"deepseek bf16 pinned: forward/prefill/decode rel {rels}, "
          f"top-k flips per MoE call {pin.flips}")
    assert max(rels) < 3e-2, (rels, pin.flips)


def test_deepseek_absorbed_decode_matches_reference():
    jcfg, tcfg, jp, tp = pair("deepseek-v2-lite-16b", dtype="float32",
                              mla_absorbed=True, adjust=decode_cfg)
    toks = tokens(8, 2, 16)
    jl, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :15]), max_seq=16)
    tl, tc = transformer.prefill(tcfg, tp, torch.from_numpy(toks[:, :15]),
                                 max_seq=16)
    assert rel_err(t2np(tl), jl) < 1e-4
    jd, _ = j_tf.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 15:]),
                             jnp.int32(15))
    td, _ = transformer.decode_step(tcfg, tp, tc,
                                    torch.from_numpy(toks[:, 15:]), 15)
    assert rel_err(t2np(td), jd) < 1e-4


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_smoke_loss_matches_reference(arch):
    jcfg, tcfg, jp, tp = pair(arch, dtype="float32")
    batch = {"tokens": tokens(9, 2, 32), "labels": tokens(10, 2, 32)}
    want = float(j_tf.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, batch)))
    got = float(transformer.loss_fn(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(got - want) < 1e-4 * max(1.0, abs(want)), (got, want)
