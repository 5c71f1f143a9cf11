"""The port's encoder-decoder (whisper) against the JAX package's.

The reference's params in both of its layouts (``enc_stack``/``dec_stack``
scanned, ``enc_layers``/``dec_layers`` unrolled) carried over with
``model_zoo.params_from_reference``; the same seeded stub frames and
tokens through both.  Whole forward relative 1e-4 (float32), 3e-2 (bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import encdec as j_ed
from repro.models import model_zoo as j_zoo
from repro_torch.configs import smoke_config
from repro_torch.models import encdec, model_zoo
from torch_lm_pairs import rel_err, rnd, t2np, to_np, tokens

ARCH = "whisper-large-v3"


def setup(dtype="float32", scan=True, **kw):
    jcfg = j_smoke(ARCH, dtype=dtype, scan_layers=scan, **kw)
    tcfg = smoke_config(ARCH, dtype=dtype, **kw)
    jp = j_zoo.build(jcfg).init_params(jax.random.PRNGKey(0))
    tp = model_zoo.params_from_reference(to_np(jp), tcfg, device="cpu")
    frames = rnd(1, 2, 32, jcfg.d_model)
    return jcfg, tcfg, jp, tp, frames


@pytest.mark.parametrize("d", [128, 1280, 2, 7])
def test_sinusoid_matches_reference(d):
    """Within 1e-5 up to position 64.  Beyond, an angle a = pos * freq
    amplifies the one-ulp (2^-23 relative) differences of the two
    libraries' float32 exp and sin by a: at whisper's 3000 frames the
    bound is 3000 * 2^-23 * 2 = 7.2e-4 (measured: 2.4e-4 at d = 1280)."""
    for hi, atol in ((64, 1e-5), (3000, 3000 * 2.0 ** -23 * 2)):
        pos = np.arange(0, hi, 7 if hi > 64 else 1)
        np.testing.assert_allclose(
            t2np(encdec.sinusoid(torch.from_numpy(pos), d)),
            np.asarray(j_ed.sinusoid(jnp.asarray(pos), d)), atol=atol,
            rtol=0)
    assert encdec.ENC_DECODE_LEN == j_ed.ENC_DECODE_LEN


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_encode_decoder_prefill_decode_match_reference(scan, dtype, tol):
    jcfg, tcfg, jp, tp, frames = setup(dtype, scan)
    assert len(tp["enc_layers"]) == 2 and len(tp["dec_layers"]) == 2
    dt = tcfg.jdtype
    fj, ft = jnp.asarray(frames, jcfg.jdtype), torch.from_numpy(frames).to(dt)
    je = j_ed.encode(jcfg, jp, fj)
    te = encdec.encode(tcfg, tp, ft)
    assert te.dtype == dt and rel_err(t2np(te), je) < tol
    toks = tokens(2, 2, 9)
    jx, _ = j_ed.decoder_forward(jcfg, jp, jnp.asarray(toks), je)
    tx, none = encdec.decoder_forward(tcfg, tp, torch.from_numpy(toks), te)
    assert none is None and rel_err(t2np(tx), jx) < tol
    jl, jc = j_ed.prefill(jcfg, jp, fj, jnp.asarray(toks[:, :8]), max_seq=9)
    tl, tc = encdec.prefill(tcfg, tp, ft, torch.from_numpy(toks[:, :8]),
                            max_seq=9)
    assert rel_err(t2np(tl), jl) < tol
    for i, c in enumerate(tc["dec"]):
        ref = (jax.tree.map(lambda a: a[i], jc["dec"]) if scan
               else jc["dec"][i])
        assert set(c) == {"k", "v", "xk", "xv"}
        for name in ("xk", "xv", "k"):
            assert rel_err(t2np(c[name]), ref[name]) < tol, (i, name)
    jd, _ = j_ed.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, 8:]),
                             jnp.int32(8))
    td, _ = encdec.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, 8:]), 8)
    assert rel_err(t2np(td), jd) < tol
    # decode continues the prefill as decoder_forward does
    want = tx[:, -1] @ tp["embed"].T
    assert rel_err(t2np(td), t2np(want)) < tol


def test_both_layouts_carry_over_alike():
    *_, tp_scan, _ = setup(scan=True)
    *_, tp_unrolled, _ = setup(scan=False)
    a, b = jax.tree.leaves(tp_scan), jax.tree.leaves(tp_unrolled)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # layer norms keep the reference's float32; weights take the dtype
    _, tcfg, _, tp, _ = setup(dtype="bfloat16")
    assert tp["enc_final"]["scale"].dtype == torch.float32
    assert tp["dec_layers"][0]["lnx"]["bias"].dtype == torch.float32
    assert tp["dec_layers"][0]["cross"]["wk"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["chunked", "einsum"])
def test_loss_fn_matches_reference(impl):
    jcfg, tcfg, jp, tp, frames = setup(attn_impl=impl, attn_chunk=8)
    batch = {"frames": frames, "tokens": tokens(3, 2, 8),
             "labels": tokens(4, 2, 8)}
    want = float(j_ed.loss_fn(jcfg, jp, jax.tree.map(jnp.asarray, batch)))
    got = float(encdec.loss_fn(
        tcfg, tp, {k: torch.from_numpy(v) for k, v in batch.items()}))
    assert abs(got - want) < 1e-4 * max(1.0, abs(want)), (got, want)
    bundle = model_zoo.build(tcfg, device="cpu")
    assert float(bundle.loss_fn(tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})) == got


def test_bundle_prefill_decode_and_caches():
    _, tcfg, _, tp, frames = setup()
    bundle = model_zoo.build(tcfg, device="cpu")
    caches = bundle.init_caches(2, 16)
    assert caches["dec"][0]["xk"].shape == (2, encdec.ENC_DECODE_LEN,
                                            tcfg.n_kv_heads, tcfg.head_dim_)
    assert bundle.init_caches(1, 4, enc_len=32)["dec"][1]["xv"].shape[1] == 32
    toks = torch.from_numpy(tokens(5, 2, 5))
    logits, caches = bundle.prefill(
        tp, {"frames": torch.from_numpy(frames), "tokens": toks[:, :4]},
        max_seq=5)
    step, _ = bundle.decode_step(tp, caches, toks[:, 4:], 4)
    enc = encdec.encode(tcfg, tp, torch.from_numpy(frames))
    full, _ = encdec.decoder_forward(tcfg, tp, toks, enc)
    assert logits.shape == (2, tcfg.padded_vocab)
    assert rel_err(t2np(step), t2np(full[:, -1] @ tp["embed"].T)) < 1e-5


def test_params_from_reference_refuses_a_wrong_layout():
    jcfg, tcfg, jp, _, _ = setup()
    bad = dataclasses.replace(tcfg, n_layers=3)
    with pytest.raises(ValueError, match="layers"):
        model_zoo.params_from_reference(to_np(jp), bad, device="cpu")
