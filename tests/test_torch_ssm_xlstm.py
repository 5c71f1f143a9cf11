"""The port's mamba, mLSTM and sLSTM mixers against the JAX package's,
then the reference's own recurrence and MoE cases (``tests/test_moe_ssm.py``
and the O(1)-state case of ``tests/test_models_smoke.py``) inside the port.

Same seeded numpy inputs and the reference's params through both; float32
layers at 1e-5, whole forward relative 1e-4 (float32); bf16 forward block
by block at 3e-2 (``torch_lm_pairs.BF16_BLOCKWISE``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import smoke_config as j_smoke
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models import xlstm as j_xlstm
from repro_torch.configs import smoke_config
from repro_torch.models import layers, ssm, transformer, xlstm
from torch_lm_pairs import (RNG, PinnedRouting, blockwise_rel, decode_cfg,
                            dropless, pair, rel_err, rnd, t2np, to_torch,
                            tokens)

TOL = dict(atol=1e-5, rtol=1e-5)


def close(got, want, **tol):
    np.testing.assert_allclose(t2np(got), np.asarray(want, np.float32),
                               **(tol or TOL))


def cfgs(arch, **kw):
    return (j_smoke(arch, dtype="float32", **kw),
            smoke_config(arch, dtype="float32", **kw))


# ---------------------------------------------------------------- mamba --

@pytest.mark.parametrize("s,chunk", [(24, 16), (21, 16), (32, 8), (5, 16)])
def test_mamba_mixer_matches_reference(s, chunk):
    """The chunk shrinks to a divisor of S (24 -> 12, 21 -> 7); prefill
    into a cache, then a decode step; the conv window and float32 ssm
    state are written back."""
    jcfg, tcfg = cfgs("jamba-v0.1-52b")
    jcfg, tcfg = (dataclasses.replace(c, mamba=dataclasses.replace(
        c.mamba, chunk=chunk)) for c in (jcfg, tcfg))
    jp = j_ssm.init_mamba(RNG, jcfg, jnp.float32)
    tp = to_torch(jp)
    x = rnd(s, 2, s + 1, jcfg.d_model, scale=0.5)
    want, _ = j_ssm.mamba_mixer(jnp.asarray(x[:, :s]), jp, jcfg)
    got, none = ssm.mamba_mixer(torch.from_numpy(x[:, :s]), tp, tcfg)
    assert none is None
    close(got, want)
    m = jcfg.mamba
    di = m.d_inner(jcfg.d_model)
    jc = {"conv": jnp.zeros((2, m.d_conv - 1, di)),
          "ssm": jnp.zeros((2, di, m.d_state))}
    tc = {k: torch.zeros(v.shape) for k, v in jc.items()}
    for sl in (slice(0, s), slice(s, s + 1)):
        want, jc = j_ssm.mamba_mixer(jnp.asarray(x[:, sl]), jp, jcfg,
                                     cache=jc)
        got, tc2 = ssm.mamba_mixer(torch.from_numpy(x[:, sl]), tp, tcfg,
                                   cache=tc)
        assert tc2 is tc
        close(got, want)
        close(tc["conv"], jc["conv"])
        close(tc["ssm"], jc["ssm"])
        assert tc["ssm"].dtype == torch.float32


def test_mamba_pieces_match_reference():
    w = rnd(1, 4, 6)
    x = rnd(2, 2, 5, 6)
    state = rnd(3, 2, 3, 6)
    for st in (None, state):
        jy, js = j_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st))
        ty, ts = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                  None if st is None else
                                  torch.from_numpy(st))
        close(ty, jy)
        close(ts, js)
    a = np.exp(-np.abs(rnd(4, 2, 13, 3, 4)))
    bu = rnd(5, 2, 13, 3, 4)
    h0 = rnd(6, 2, 3, 4)
    jh, jl = j_ssm._ssm_chunk(*map(jnp.asarray, (a, bu, h0)))
    th, tl = ssm._ssm_chunk(*map(torch.from_numpy, (a, bu, h0)))
    close(th, jh)
    close(tl, jl)


# ---------------------------------------------------------------- xLSTM --

def mlstm_cache(b, cfg, m0=-10.0):
    di = int(cfg.d_model * cfg.xlstm.mlstm_proj_factor)
    h = cfg.n_heads
    hd = di // h
    return {"c": np.zeros((b, h, hd, hd), np.float32),
            "n": np.zeros((b, h, hd), np.float32),
            "m": np.full((b, h), m0, np.float32)}


@pytest.mark.parametrize("s,chunk", [(24, 16), (16, 16), (11, 4)])
def test_mlstm_parallel_prefill_state_and_decode_match_reference(s, chunk):
    jcfg, tcfg = cfgs("xlstm-125m")
    jcfg, tcfg = (dataclasses.replace(c, xlstm=dataclasses.replace(
        c.xlstm, chunk=chunk)) for c in (jcfg, tcfg))
    jp = j_xlstm.init_mlstm(RNG, jcfg, jnp.float32)
    tp = to_torch(jp)
    x = rnd(s, 2, s + 1, jcfg.d_model, scale=0.5)
    want, _ = j_xlstm.mlstm_mixer(jnp.asarray(x[:, :s]), jp, jcfg)
    got, _ = xlstm.mlstm_mixer(torch.from_numpy(x[:, :s]), tp, tcfg)
    close(got, want)
    c0 = mlstm_cache(2, jcfg)
    jc = {k: jnp.asarray(v) for k, v in c0.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in c0.items()}
    for sl in (slice(0, s), slice(s, s + 1)):
        want, jc = j_xlstm.mlstm_mixer(jnp.asarray(x[:, sl]), jp, jcfg,
                                       cache=jc)
        got, tc2 = xlstm.mlstm_mixer(torch.from_numpy(x[:, sl]), tp, tcfg,
                                     cache=tc)
        assert tc2 is tc
        close(got, want)
        for name in ("c", "n", "m"):
            close(tc[name], jc[name], atol=1e-5, rtol=1e-4)


def test_slstm_matches_reference():
    jcfg, tcfg = cfgs("xlstm-125m")
    jp = j_xlstm.init_slstm(RNG, jcfg, jnp.float32)
    tp = to_torch(jp)
    x = rnd(7, 2, 10, jcfg.d_model, scale=0.5)
    want, _ = j_xlstm.slstm_mixer(jnp.asarray(x[:, :9]), jp, jcfg)
    got, _ = xlstm.slstm_mixer(torch.from_numpy(x[:, :9]), tp, tcfg)
    close(got, want)
    d = jcfg.d_model
    c0 = {"c": np.zeros((2, d), np.float32),
          "n": np.full((2, d), 1e-6, np.float32),
          "h": np.zeros((2, d), np.float32),
          "m": np.full((2, d), -10.0, np.float32)}
    jc = {k: jnp.asarray(v) for k, v in c0.items()}
    tc = {k: torch.from_numpy(v.copy()) for k, v in c0.items()}
    for sl in (slice(0, 9), slice(9, 10)):
        want, jc = j_xlstm.slstm_mixer(jnp.asarray(x[:, sl]), jp, jcfg,
                                       cache=jc)
        got, _ = xlstm.slstm_mixer(torch.from_numpy(x[:, sl]), tp, tcfg,
                                   cache=tc)
        close(got, want)
        for name in c0:
            close(tc[name], jc[name])


# ------------------------------------------------------- jamba and xlstm --

@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_smoke_forward_prefill_decode_match_reference(arch):
    """float32: forward, aux loss and loss, prefill and decode logits and
    the recurrent caches against the reference's (dropless MoE)."""
    jcfg, tcfg, jp, tp = pair(arch, dtype="float32", adjust=decode_cfg)
    toks = tokens(11, 2, 20)
    want, _, jaux = j_tf.forward(jcfg, jp, jnp.asarray(toks))
    got, _, aux = transformer.forward(tcfg, tp, torch.from_numpy(toks))
    assert rel_err(t2np(got), want) < 1e-4
    assert abs(float(aux) - float(jaux)) <= 1e-4 * abs(float(jaux))
    jl, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :19]), max_seq=20)
    tl, tc = transformer.prefill(tcfg, tp, torch.from_numpy(toks[:, :19]),
                                 max_seq=20)
    assert rel_err(t2np(tl), jl) < 1e-4
    jd, jc = j_tf.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 19:]),
                              jnp.int32(19))
    td, tc = transformer.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(toks[:, 19:]), 19)
    assert rel_err(t2np(td), jd) < 1e-4
    period = jcfg.layer_period
    for j, c in enumerate(tc["layers"]):
        ref = jax.tree.map(lambda a: a[j // period], jc["stack"][j % period])
        for name, t in c.items():
            assert rel_err(t2np(t), ref[name]) < 1e-4, (j, name)
    full = got[:, -1] @ transformer.lm_head(tcfg, tp).T
    assert rel_err(t2np(td), t2np(full)) < 1e-4


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_smoke_bf16_blocks_match_reference(arch):
    jcfg, tcfg, jp, tp = pair(arch, dtype="bfloat16")
    errs = blockwise_rel(jcfg, tcfg, jp, tp, tokens(12, 2, 24))
    assert len(errs) == tcfg.n_layers
    assert max(errs) < 3e-2, errs


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_bf16_forward_within_the_references_own_spread(arch):
    """bf16 whole forward.  The reference's scanned and unrolled layouts
    (the same arithmetic, fused differently) disagree by ``spread``; the
    port lies within twice that (or 3e-2) of the unrolled reference with
    its MoE routing pinned to the port's (``PinnedRouting``)."""
    jcfg, tcfg, jp, tp = pair(arch, dtype="bfloat16", adjust=dropless)
    toks = tokens(7, 2, 24)
    pin = PinnedRouting(jcfg, jp)
    scanned, _, _ = j_tf.forward(jcfg, jp, jnp.asarray(toks))
    flat, _, _ = j_tf.forward(pin.cfg, pin.params, jnp.asarray(toks))
    spread = rel_err(scanned, flat)
    with pin.port():
        got, _, _ = transformer.forward(tcfg, tp, torch.from_numpy(toks))
    with pin.reference():
        want, _, _ = j_tf.forward(pin.cfg, pin.params, jnp.asarray(toks))
    rel = rel_err(t2np(got), want)
    print(f"{arch} bf16: port vs reference {rel}, the reference's own "
          f"spread {spread}, top-k flips per MoE call {pin.flips}")
    assert got.dtype == torch.bfloat16
    assert rel < max(3e-2, 2 * spread), (rel, spread, pin.flips)


# ------------------------------- the reference's own cases, in the port --

def _moe_cfg(**kw):
    cfg = smoke_config("grok-1-314b", dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_moe_matches_dense_loop_reference():
    """Dropless capacity: the output equals the explicit per-token loop."""
    cfg = _moe_cfg(capacity_factor=8.0, n_shared=0)
    m = cfg.moe
    p = layers.init_moe(_gen(), cfg, torch.float32)
    x = torch.randn((6, 11, cfg.d_model), generator=_gen(1))
    out, aux = layers.moe_ffn(x, p, cfg)
    xf = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xf @ p["router"], -1)
    gw, gi = layers.moe_route(probs, m.top_k)
    gw = gw / gw.sum(-1, keepdim=True)
    act = F.silu if cfg.act == "swiglu" else (
        lambda h: F.gelu(h, approximate="tanh"))
    want = torch.zeros_like(xf)
    for t in range(xf.shape[0]):
        for j in range(m.top_k):
            e = int(gi[t, j])
            h = act(xf[t] @ p["we1"][e]) * (xf[t] @ p["we3"][e])
            want[t] += gw[t, j] * (h @ p["we2"][e])
    torch.testing.assert_close(out.reshape(-1, cfg.d_model), want,
                               atol=2e-3, rtol=2e-3)
    assert float(aux) > 0.0


def test_moe_capacity_drops_tokens():
    cfg = _moe_cfg(capacity_factor=0.25, n_shared=0)
    p = layers.init_moe(_gen(), cfg, torch.float32)
    out, _ = layers.moe_ffn(torch.randn((2, 64, cfg.d_model),
                                        generator=_gen(1)), p, cfg)
    norms = out.reshape(-1, cfg.d_model).norm(dim=1)
    assert (norms < 1e-6).any()


def test_moe_aux_loss_balanced_is_minimal():
    """Uniform routing gives aux == weight (the Switch lower bound): the
    port's own aux on a router that ties every expert."""
    cfg = _moe_cfg(top_k=1)
    p = layers.init_moe(_gen(), cfg, torch.float32)
    p["router"] = torch.zeros_like(p["router"])
    x = torch.randn((1, 4 * cfg.moe.n_experts, cfg.d_model),
                    generator=_gen(1))
    # ties go to expert 0 with top_k 1: frac is one-hot, so aux = weight
    _, aux = layers.moe_ffn(x, p, cfg)
    m = cfg.moe
    assert abs(float(aux) - m.aux_loss_weight) < 1e-7
    probs = torch.full((2, 32, m.n_experts), 1.0 / m.n_experts)
    frac = torch.full((m.n_experts,), 1.0 / m.n_experts)
    assert abs(float(m.n_experts * (frac * probs.mean((0, 1))).sum())
               - 1.0) < 1e-5


def test_mamba_chunked_scan_equals_naive_recurrence():
    cfg = smoke_config("jamba-v0.1-52b", dtype="float32")
    p = ssm.init_mamba(_gen(), cfg, torch.float32)
    x = torch.randn((2, 24, cfg.d_model), generator=_gen(2)) * 0.3
    y_chunk, _ = ssm.mamba_mixer(x, p, cfg)
    cache = transformer._cache_for_kind(cfg, {"mixer": "mamba"}, 2, 1, "cpu")
    ys = [ssm.mamba_mixer(x[:, t:t + 1], p, cfg, cache=cache)[0]
          for t in range(24)]
    torch.testing.assert_close(y_chunk, torch.cat(ys, 1), atol=2e-3,
                               rtol=2e-3)


def test_mamba_chunk_size_invariance():
    cfg = smoke_config("jamba-v0.1-52b", dtype="float32")
    p = ssm.init_mamba(_gen(), cfg, torch.float32)
    x = torch.randn((1, 32, cfg.d_model), generator=_gen(3))
    y1, _ = ssm.mamba_mixer(x, p, cfg)
    cfg2 = dataclasses.replace(cfg, mamba=dataclasses.replace(cfg.mamba,
                                                              chunk=32))
    y2, _ = ssm.mamba_mixer(x, p, cfg2)
    torch.testing.assert_close(y1, y2, atol=1e-4, rtol=1e-4)


def test_mlstm_parallel_equals_recurrent_decode():
    cfg = smoke_config("xlstm-125m", dtype="float32")
    p = xlstm.init_mlstm(_gen(), cfg, torch.float32)
    x = torch.randn((2, 16, cfg.d_model), generator=_gen(4)) * 0.5
    y_par, _ = xlstm.mlstm_mixer(x, p, cfg)
    cache = {k: torch.from_numpy(v)
             for k, v in mlstm_cache(2, cfg, m0=-1e9).items()}
    ys = [xlstm.mlstm_mixer(x[:, t:t + 1], p, cfg, cache=cache)[0]
          for t in range(16)]
    torch.testing.assert_close(y_par, torch.cat(ys, 1), atol=3e-3,
                               rtol=3e-3)


def test_mlstm_prefill_state_continues_decode():
    cfg = smoke_config("xlstm-125m", dtype="float32")
    p = xlstm.init_mlstm(_gen(), cfg, torch.float32)
    x = torch.randn((1, 12, cfg.d_model), generator=_gen(5)) * 0.5
    cache = {k: torch.from_numpy(v)
             for k, v in mlstm_cache(1, cfg, m0=-1e9).items()}
    xlstm.mlstm_mixer(x[:, :11], p, cfg, cache=cache)
    y_dec, _ = xlstm.mlstm_mixer(x[:, 11:12], p, cfg, cache=cache)
    y_full, _ = xlstm.mlstm_mixer(x, p, cfg)
    torch.testing.assert_close(y_dec[:, 0], y_full[:, -1], atol=3e-3,
                               rtol=3e-3)


def test_slstm_decode_equals_scan():
    cfg = smoke_config("xlstm-125m", dtype="float32")
    p = xlstm.init_slstm(_gen(), cfg, torch.float32)
    x = torch.randn((2, 10, cfg.d_model), generator=_gen(6)) * 0.5
    y_scan, _ = xlstm.slstm_mixer(x, p, cfg)
    cache = transformer._cache_for_kind(cfg, {"mixer": "slstm"}, 2, 1, "cpu")
    ys = [xlstm.slstm_mixer(x[:, t:t + 1], p, cfg, cache=cache)[0]
          for t in range(10)]
    torch.testing.assert_close(torch.cat(ys, 1), y_scan, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_long_context_archs_have_o1_state(arch):
    """xLSTM's decode state does not grow with the history; jamba's grows
    only in its attention layers' k/v."""
    cfg = smoke_config(arch)
    small = transformer.init_caches(cfg, batch=1, max_seq=8, device="cpu")
    big = transformer.init_caches(cfg, batch=1, max_seq=8192, device="cpu")

    def size(c, kinds=None):
        return sum(t.numel() for i, lc in enumerate(c["layers"])
                   for t in lc.values()
                   if kinds is None or transformer.layer_kinds(cfg)[i][
                       "mixer"] in kinds)

    assert size(small, {"mamba", "mlstm", "slstm"}) == \
        size(big, {"mamba", "mlstm", "slstm"})
    if arch == "xlstm-125m":
        assert size(small) == size(big)
    else:
        assert size(small) < size(big)
