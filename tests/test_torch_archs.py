"""All ten LM archs of the reference's registry in the port.

Configs field-equal to the reference's; the forward, loss, prefill and
decode of the archs no other LM test file holds against the reference's
(float32 relative 1e-4; bf16 3e-2); decode against
the full forward inside the port; ``ServeEngine`` tokens equal to the
reference engine's; the encoder-decoder refusal; ``prune_ffn`` masks equal
to the reference's, one threshold per reference leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import registry as j_registry
from repro.configs import smoke_config as j_smoke
from repro.launch.serve import prune_ffn as j_prune
from repro.models import model_zoo as j_zoo
from repro.models import transformer as j_tf
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import ARCHS, SHAPES, registry, smoke_config
from repro_torch.launch import serve
from repro_torch.models import encdec, model_zoo, transformer
from repro_torch.serving.engine import Request, ServeEngine
from torch_lm_pairs import (decode_cfg, pair, rel_err, rnd, t2np, to_np,
                            tokens, unrolled)

ALL = sorted(J_ARCHS)


def as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_registry_matches_reference():
    assert sorted(ARCHS) == ALL and len(ALL) == 10
    for name in ALL:
        assert as_dict(ARCHS[name]) == as_dict(J_ARCHS[name]), name
        assert ARCHS[name].total_params() == J_ARCHS[name].total_params()
        assert ARCHS[name].layer_period == J_ARCHS[name].layer_period
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert registry.SUBQUADRATIC == j_registry.SUBQUADRATIC
    for arch in ALL:
        for shape in SHAPES:
            assert registry.cell_supported(arch, shape) == \
                j_registry.cell_supported(arch, shape), (arch, shape)
        assert registry.get_shape("decode_32k") == SHAPES["decode_32k"]
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_arch("gpt-5")


@pytest.mark.parametrize("arch", ALL)
def test_smoke_config_matches_reference(arch):
    assert as_dict(smoke_config(arch)) == as_dict(j_smoke(arch))
    kw = dict(n_layers=4, dtype="float32", attn_chunk=8)
    if arch == "deepseek-v2-lite-16b":
        kw["n_layers"] = 3
    assert as_dict(smoke_config(arch, **kw)) == as_dict(j_smoke(arch, **kw))


# the archs whose float32 forward and loss, or bf16 forward, no other file
# holds: deepseek and grok are in test_torch_moe_mla.py, whisper in
# test_torch_encdec.py, llama3.2-1b in test_torch_lm.py, jamba and xlstm's
# forward and bf16 blocks in test_torch_ssm_xlstm.py
NEW_DENSE = ["chameleon-34b", "chatglm3-6b", "llama3-8b",
             "mistral-large-123b"]


@pytest.mark.parametrize("arch", NEW_DENSE + ["jamba-v0.1-52b",
                                              "xlstm-125m"])
def test_smoke_forward_and_loss_match_reference(arch):
    """float32 forward and loss at 1e-4."""
    jcfg, tcfg, jp, tp = pair(arch, dtype="float32")
    toks = tokens(20, 2, 16)
    want, _, _ = j_tf.forward(jcfg, jp, jnp.asarray(toks))
    got, _, _ = transformer.forward(tcfg, tp, torch.from_numpy(toks))
    assert rel_err(t2np(got), want) < 1e-4
    batch = {"tokens": toks, "labels": tokens(22, 2, 16)}
    jl = float(j_tf.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, batch)))
    tl = float(model_zoo.build(tcfg, device="cpu").loss_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(tl - jl) < 1e-4 * max(1.0, abs(jl)), (tl, jl)


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_smoke_bf16_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = pair(arch, dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = tokens(23, 2, 16)
    want, _, _ = j_tf.forward(jcfg, jp, jnp.asarray(toks))
    got, _, _ = transformer.forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert rel_err(t2np(got), want) < 3e-2


@pytest.mark.parametrize("arch", NEW_DENSE)
def test_smoke_prefill_and_decode_match_reference(arch):
    """float32 prefill and decode-step logits and k/v caches of the dense
    archs new to the port (the others: ``test_torch_lm.py``,
    ``test_torch_moe_mla.py``, ``test_torch_ssm_xlstm.py``,
    ``test_torch_encdec.py``)."""
    jcfg, tcfg, jp, tp = pair(arch, dtype="float32")
    toks = tokens(27, 2, 12)
    jl, jc = j_tf.prefill(jcfg, jp, jnp.asarray(toks[:, :11]), max_seq=12)
    tl, tc = transformer.prefill(tcfg, tp, torch.from_numpy(toks[:, :11]),
                                 max_seq=12)
    assert rel_err(t2np(tl), jl) < 1e-4
    jd, jc = j_tf.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 11:]),
                              jnp.int32(11))
    td, tc = transformer.decode_step(tcfg, tp, tc,
                                     torch.from_numpy(toks[:, 11:]), 11)
    assert rel_err(t2np(td), jd) < 1e-4
    for j, c in enumerate(tc["layers"]):
        for name in ("k", "v"):
            assert rel_err(t2np(c[name]), jc["stack"][0][name][j]) < 1e-4


@pytest.mark.parametrize("arch", ALL)
def test_decode_matches_full_forward_in_the_port(arch):
    """The reference test's check (``tests/test_models_smoke.py:45``) on
    the port's own params, with its dropless MoE and float32 xLSTM."""
    cfg = decode_cfg(smoke_config(arch))
    bundle = model_zoo.build(cfg, device="cpu")
    params = bundle.init_params(0)
    gen = torch.Generator().manual_seed(1)
    with torch.inference_mode():
        if cfg.encdec is not None:
            frames = torch.randn((2, 32, cfg.d_model), generator=gen,
                                 dtype=cfg.jdtype)
            toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
            enc = encdec.encode(cfg, params, frames)
            x, _ = encdec.decoder_forward(cfg, params, toks, enc)
            want = x[:, -1] @ params["embed"].T
            _, c = bundle.prefill(params, {"frames": frames,
                                           "tokens": toks[:, :7]}, max_seq=8)
            got, _ = bundle.decode_step(params, c, toks[:, 7:], 7)
        else:
            toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
            x, _, _ = transformer.forward(cfg, params, toks)
            want = x[:, -1] @ transformer.lm_head(cfg, params).T
            _, c = bundle.prefill(params, {"tokens": toks[:, :31]},
                                  max_seq=32)
            got, _ = bundle.decode_step(params, c, toks[:, 31:], 31)
    assert rel_err(t2np(got), t2np(want)) < 3e-2, arch


def _prompts(seed, n, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=(lens[i % len(lens)],)).astype(
        np.int32) for i in range(n)]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_serve_engine_tokens_equal_the_reference_engine(arch):
    """float32 params, the default (dropping) MoE capacity: 3 requests on
    2 slots, ragged prompts left-padded, greedy."""
    jcfg, tcfg, jp, tp = pair(arch, dtype="float32")
    ps = _prompts(25, 3, (6, 9))
    kw = dict(slots=2, max_seq=14)
    jr = JServeEngine(j_zoo.build(jcfg), jp, **kw).generate(
        [JRequest(p, max_new_tokens=4, request_id=i)
         for i, p in enumerate(ps)])
    tr = ServeEngine(model_zoo.build(tcfg, device="cpu"), tp, **kw).generate(
        [Request(p, max_new_tokens=4, request_id=i)
         for i, p in enumerate(ps)])
    for a, b in zip(jr, tr):
        assert len(b.tokens) == 4
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_serve_engine_refuses_an_encoder_decoder_bundle(capsys):
    """The reference's engine fails on whisper in its prefill (no frames in
    the batch); the port's refuses the bundle outright, and its CLI decodes
    whisper through the bundle instead."""
    jcfg, tcfg, jp, tp = pair("whisper-large-v3", dtype="float32")
    req = [JRequest(np.arange(4, dtype=np.int32), max_new_tokens=2)]
    with pytest.raises(KeyError, match="frames"):
        JServeEngine(j_zoo.build(jcfg), jp, slots=1, max_seq=8).generate(req)
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(model_zoo.build(tcfg, device="cpu"), tp)
    serve.main(["--arch", "whisper-large-v3", "--device", "cpu",
                "--requests", "2", "--prompt-len", "4", "--new-tokens", "3"])
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


def _ref_leaf(jpp, group, cfg):
    """The reference's pruned leaf a port group stands for."""
    key, j, path = group[0]
    if key == "dense_first":
        node = jpp["dense_first"][j]
    elif key == "layers":
        node = jpp["stack"][j % cfg.layer_period]
    else:
        node = jpp["enc_stack" if key == "enc_layers" else "dec_stack"]
    for k in path:
        node = node[k]
    return np.asarray(node, np.float32)


@pytest.mark.parametrize("arch,n_groups", [
    # period 8: 8 dense or MoE FFNs, 3 or 3 leaves each
    ("jamba-v0.1-52b", 24),
    # dense-first w1/w2/w3, routed we1/we2/we3 and shared w1/w2/w3
    ("deepseek-v2-lite-16b", 9),
    # sLSTM's w1/w2 at period position 1 only
    ("xlstm-125m", 2),
    ("whisper-large-v3", 4),
    ("llama3.2-1b", 3),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prune_ffn_masks_equal_the_reference(arch, n_groups, dtype):
    jcfg, tcfg, jp, tp = pair(arch, dtype=dtype)
    groups = serve.leaf_groups(tp, tcfg.layer_period)
    assert len(groups) == n_groups
    for density in (0.1, 0.37):
        jpp = j_prune(jp, density, np.random.default_rng(0))
        work = jax.tree.map(torch.clone, tp)
        tpp = serve.prune_ffn(work, density, period=tcfg.layer_period)
        assert tpp is work
        for group in groups:
            want = _ref_leaf(jpp, group, jcfg)
            for key, j, path in group:
                ref = (want if key == "dense_first" else
                       want[j // jcfg.layer_period] if key == "layers"
                       else want[j])
                got = serve._get(tpp[key][j], path)
                np.testing.assert_array_equal(got.float().numpy(), ref)
        # only the FFN leaves change
        assert torch.equal(tpp["embed"], tp["embed"])


@pytest.mark.parametrize("seed,shape,density", [
    (0, (3, 64, 48), 0.1), (1, (5, 17), 0.37), (2, (2, 256, 33), 0.9),
    (3, (4, 7), 0.01)])
def test_bf16_histogram_threshold_equals_kthvalue(seed, shape, density):
    """The histogram of magnitude bit patterns picks np.partition's value,
    the value torch.kthvalue picks, on bf16 weights with repeats and
    signed zeros."""
    x = rnd(seed, *shape)
    x[..., :3] = 0.0
    x[..., 3] = -0.0
    ws = [torch.from_numpy(x).bfloat16(),
          torch.from_numpy(rnd(seed + 9, 11, 5)).bfloat16()]
    hist = serve.magnitude_threshold(ws, density)
    kth = serve.magnitude_threshold([w.float() for w in ws], density)
    flat = np.concatenate([w.float().numpy().ravel() for w in ws])
    k = max(int(flat.size * density), 1)
    ref = np.partition(np.abs(flat), flat.size - k)[flat.size - k]
    assert float(hist) == float(kth) == float(ref)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m",
                                  "deepseek-v2-lite-16b"])
def test_stack_and_layers_layouts_carry_over_alike(arch):
    """The reference's scanned params (``stack`` of period 8, 4 or 1,
    ``dense_first``, nested ``shared``) and the same params unrolled
    (``layers``, as ``scan_layers=False`` lays them out) give the port
    equal params, and the unrolled reference's forward equals the
    port's."""
    jcfg, tcfg, jp, tp = pair(arch, dtype="float32")
    flat = unrolled(jcfg, jp)
    tu = model_zoo.params_from_reference(to_np(flat), tcfg, device="cpu")
    a, b = jax.tree.leaves(tp), jax.tree.leaves(tu)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    toks = tokens(26, 2, 12)
    want, _, _ = j_tf.forward(dataclasses.replace(jcfg, scan_layers=False),
                              flat, jnp.asarray(toks))
    got, _, _ = transformer.forward(tcfg, tu, torch.from_numpy(toks))
    assert rel_err(t2np(got), want) < 1e-4
