"""The port's engines against the JAX package's, end to end on the CPU.

Both sides get the same numpy graph and weights (the reference bundle's,
carried over with ``tensors_from_reference``).  Codes and formats must be
exactly equal, outputs within 2e-4 (``tests/test_unified_executor.py:90``),
and inside the port the fused executor must equal the per-kernel engine
bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import perf_model as j_pm
from repro.core import runtime as j_rt
from repro.models import gnn as j_gnn
from repro_torch.core import perf_model as t_pm
from repro_torch.core import runtime as t_rt
from repro_torch.models import gnn as t_gnn

TOL = dict(atol=2e-4, rtol=2e-4)
CHEAP_J = dataclasses.replace(j_pm.TPUCostModel(), eff_transform=1.0,
                              transform_overhead_s=0.0)
CHEAP_T = dataclasses.replace(t_pm.TPUCostModel(), eff_transform=1.0,
                              transform_overhead_s=0.0)


def bundles(model, ds, scale, seed=2):
    jb = j_gnn.build_dense(model, ds, scale=scale, seed=seed)
    tb = t_gnn.build_dense(model, ds, scale=scale, seed=seed, device="cpu")
    carried = t_gnn.tensors_from_reference(
        {k: np.asarray(v) for k, v in jb.tensors.items()}, "cpu")
    assert carried.keys() == tb.tensors.keys()
    for name, t in carried.items():
        assert torch.equal(t, tb.tensors[name]), name
    tb.tensors = carried
    return jb, tb


def assert_same_plans(j_eng, t_eng):
    assert j_eng.planned_codes.keys() == t_eng.planned_codes.keys()
    for name, codes in j_eng.planned_codes.items():
        np.testing.assert_array_equal(t_eng.planned_codes[name], codes,
                                      err_msg=name)
        assert int(t_eng.planned_formats[name]) == int(
            j_eng.planned_formats[name]), name


@pytest.mark.parametrize("model,ds,scale", [
    ("gcn", "CO", 0.05), ("sage", "CO", 0.05), ("gin", "CO", 0.05),
    ("sgc", "CO", 0.05), ("sage", "CI", 0.1)])
@pytest.mark.parametrize("strategy", ["dynamic", "s1", "s2", "gemm"])
def test_engines_match_reference(model, ds, scale, strategy):
    jb, tb = bundles(model, ds, scale)
    j_eng = j_rt.DynasparseEngine(strategy=strategy, keep_codes=True)
    t_eng = t_rt.DynasparseEngine(strategy=strategy, keep_codes=True)
    j_out, j_rep = jb.run(j_eng)
    t_out, t_rep = tb.run(t_eng)
    assert_same_plans(j_eng, t_eng)
    np.testing.assert_array_equal(t_rep.histogram, j_rep.histogram)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    for name, d in j_eng.profiled_densities.items():
        np.testing.assert_array_equal(
            t_eng.profiled_densities[name].numpy(), np.asarray(d))

    fused = t_rt.FusedModelExecutor(strategy=strategy, keep_codes=True)
    env, f_rep = fused.run(tb.compiled, tb.tensors)
    last = tb.compiled.graph.kernels[-1].out
    assert torch.equal(env[last], t_out)
    for name, codes in t_eng.planned_codes.items():
        np.testing.assert_array_equal(fused.planned_codes[name], codes)
    np.testing.assert_array_equal(f_rep.histogram, t_rep.histogram)
    assert f_rep.total_cycles == pytest.approx(t_rep.total_cycles)


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_csr_format_path_matches_reference(model):
    """Under the TPU model with a free transform and ``csr_rmax`` equal to
    the graph's largest row, both aggregates run row-CSR in both packages;
    one row less and the runtime fit check keeps the block path."""
    jb, tb = bundles(model, "CO", 0.05)
    widest = int((np.asarray(jb.tensors["A"]) != 0).sum(axis=1).max())
    for rmax, want_csr in ((widest, True), (widest - 1, False)):
        j_eng = j_rt.DynasparseEngine(model=CHEAP_J, keep_codes=True,
                                      csr_rmax=rmax)
        t_eng = t_rt.DynasparseEngine(model=CHEAP_T, keep_codes=True,
                                      csr_rmax=rmax)
        j_out, _ = jb.run(j_eng)
        t_out, _ = tb.run(t_eng)
        assert_same_plans(j_eng, t_eng)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
        aggs = [k.out for k in tb.compiled.graph.kernels
                if k.name.endswith(".agg")]
        assert all(t_eng.planned_formats[n] == int(want_csr) for n in aggs)
        fused = t_rt.FusedModelExecutor(model=CHEAP_T, keep_codes=True,
                                        csr_rmax=rmax)
        env, _ = fused.run(tb.compiled, tb.tensors)
        last = tb.compiled.graph.kernels[-1].out
        assert torch.equal(env[last], t_out)
        for name, f in t_eng.planned_formats.items():
            assert int(fused.planned_formats[name]) == f


def test_fused_executor_caches_its_walk_and_input_profiles():
    _, tb = bundles("gcn", "CO", 0.05)
    fused = t_rt.FusedModelExecutor()
    out1, _ = fused.run(tb.compiled, tb.tensors)
    out2, rep = fused.run(tb.compiled, tb.tensors)
    assert fused.trace_count == 1
    assert (fused.cache_hits, fused.cache_misses) == (1, 1)
    last = tb.compiled.graph.kernels[-1].out
    assert torch.equal(out1[last], out2[last])
    assert rep.fused_wall_seconds is not None and rep.kernels
    quiet = t_rt.FusedModelExecutor(collect_report=False,
                                    keep_intermediates=True)
    env, rep = quiet.run(tb.compiled, tb.tensors)
    assert rep.kernels == [] and set(tb.tensors) < set(env)
    assert torch.equal(env[last], out1[last])


def test_per_kernel_engine_caches_executors():
    _, tb = bundles("sage", "CO", 0.05)
    eng = t_rt.DynasparseEngine()
    tb.run(eng)
    misses = eng.cache_misses
    tb.run(eng)
    assert eng.cache_misses == misses and eng.cache_hits >= misses


def test_attention_kernels_are_not_ported_yet():
    tb = t_gnn.build_dense("sgc", "CO", scale=0.05, device="cpu")
    spec = t_gnn.make_model_spec("gat", tb.graph.spec.f_in, 8, 7)
    from repro_torch.core import compiler
    meta = compiler.GraphMeta("CO", tb.graph.spec.n_vertices,
                              tb.graph.spec.n_edges, tb.graph.spec.f_in)
    cm = compiler.compile_model(spec, meta, n_cc=7, align=16,
                                on_chip_bytes=256 * 1024)
    tensors = dict(tb.tensors)
    tensors.update(t_gnn.tensors_from_reference(
        t_gnn.init_weights(cm), "cpu"))
    for engine in (t_rt.DynasparseEngine(), t_rt.FusedModelExecutor()):
        with pytest.raises(NotImplementedError, match="ATTENTION"):
            engine.run(cm, tensors)
