"""The port's LM serving path against the JAX package's.

Reference params carried over with ``model_zoo.params_from_reference``;
the smoke config of llama3.2-1b at 2 layers.  Greedy and temperature
tokens equal the reference engine's in float32 (the sampler is the same
numpy Gumbel-max under ``rng_seed``), ``prune_ffn`` gives the reference's
masks exactly, and dynasparse serving equals dense serving inside the port
(the reference's own invariant, ``tests/test_serving_and_data.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.launch.serve import prune_ffn as j_prune
from repro.models import model_zoo as j_zoo
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.launch import serve
from repro_torch.models import model_zoo
from repro_torch.serving.engine import Request, ServeEngine


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def setup(dtype="float32", prune=None):
    jcfg = j_smoke("llama3.2-1b", n_layers=2, dtype=dtype)
    tcfg = smoke_config("llama3.2-1b", n_layers=2, dtype=dtype)
    jb = j_zoo.build(jcfg)
    jp = jb.init_params(jax.random.PRNGKey(0))
    if prune is not None:
        jp = j_prune(jp, prune, np.random.default_rng(0))
    tb = model_zoo.build(tcfg, device="cpu")
    tp = model_zoo.params_from_reference(to_np(jp), tcfg, device="cpu")
    return jb, jp, tb, tp


def prompts(seed, n, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=(lens[i % len(lens)],)).astype(
        np.int32) for i in range(n)]


def run_both(jb, jp, tb, tp, ps, new, **kw):
    jr = JServeEngine(jb, jp, **kw).generate(
        [JRequest(p, max_new_tokens=new, request_id=i)
         for i, p in enumerate(ps)])
    tr = ServeEngine(tb, tp, **kw).generate(
        [Request(p, max_new_tokens=new, request_id=i)
         for i, p in enumerate(ps)])
    return jr, tr


@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 7)])
def test_tokens_equal_the_reference_engine(temperature, seed):
    """Waves larger than the slots (5 requests, 2 slots), ragged prompts
    left-padded with 0; greedy and Gumbel-max sampling."""
    jb, jp, tb, tp = setup()
    ps, new = prompts(1, 5, (4, 6, 5)), 4
    jr, tr = run_both(jb, jp, tb, tp, ps, new, slots=2, max_seq=16,
                      temperature=temperature, rng_seed=seed)
    assert [r.request_id for r in tr] == list(range(5))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(b.tokens) == new and b.tokens.dtype == np.int32


def test_generation_stops_at_max_seq():
    jb, jp, tb, tp = setup()
    ps = prompts(2, 3, (8,))
    jr, tr = run_both(jb, jp, tb, tp, ps, 12, slots=4, max_seq=12)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(b.tokens) == 5


def test_prune_ffn_masks_equal_the_reference():
    """One threshold per stacked leaf: the port pools its per-layer
    weights to match the reference's (n_periods, d, f) leaves."""
    jcfg = j_smoke("llama3.2-1b", n_layers=3)
    jp = j_zoo.build(jcfg).init_params(jax.random.PRNGKey(1))
    tcfg = smoke_config("llama3.2-1b", n_layers=3)
    tp = model_zoo.params_from_reference(to_np(jp), tcfg, device="cpu")
    for density in (0.1, 0.37):
        jpp = j_prune(jp, density, np.random.default_rng(0))
        tpp = serve.prune_ffn(jax.tree.map(torch.clone, tp), density,
                              period=tcfg.layer_period)
        for i, lp in enumerate(tpp["layers"]):
            for name in ("w1", "w2", "w3"):
                want = np.asarray(jpp["stack"][0]["ffn"][name][i],
                                  np.float32)
                got = lp["ffn"][name].float().numpy()
                np.testing.assert_array_equal(got != 0, want != 0)
                np.testing.assert_array_equal(got, want)
            assert torch.equal(lp["mix"]["wq"], tp["layers"][i]["mix"]["wq"])
        # the pruned weights are zeroed in the given tensors
        assert all(torch.count_nonzero(lp["ffn"]["w1"]) < lp["ffn"]["w1"]
                   .numel() for lp in tpp["layers"])


def test_dynasparse_serving_equals_dense_in_the_port():
    jb, jp, tb, tp = setup(dtype="bfloat16", prune=0.1)
    tcfg = dataclasses.replace(tb.cfg, dynasparse_ffn=True)
    tb_ds = model_zoo.build(tcfg, device="cpu")
    ps, new = prompts(2, 2, (8,)), 4
    reqs = [Request(p, max_new_tokens=new, request_id=i)
            for i, p in enumerate(ps)]
    dense = ServeEngine(tb, tp, slots=2, max_seq=16).generate(reqs)
    ds = ServeEngine(tb_ds, tp, slots=2, max_seq=16).generate(reqs)
    jr = JServeEngine(jb, jp, slots=2, max_seq=16).generate(
        [JRequest(p, max_new_tokens=new, request_id=i)
         for i, p in enumerate(ps)])
    for a, b, c in zip(dense, ds, jr):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert len(a.tokens) == len(c.tokens) == new


def test_serving_entry_points_need_cuda_unless_cpu_is_asked_for(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "4",
                "--new-tokens", "2", "--dynasparse", "--prune", "0.1"])
    assert "served 2 requests, 4 tokens" in capsys.readouterr().out
