"""The port's batched GNN serving against the JAX package's, on the CPU.

Both sides get the same numpy requests (``random_requests`` draws the
same arrays from a seed) and the same weights (the reference engine's,
carried over as numpy).  ``run_batch``'s codes and formats must equal the
reference's exactly and its outputs agree within 3e-4, the float32
tolerance of ``tests/test_kernels.py``; inside the port ``serve`` must
equal ``run_naive`` bit for bit, as ``tests/test_graph_serving.py`` holds
the reference.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.kernels as K
from repro.core import perf_model as j_pm
from repro.core import profiler as j_prof
from repro.serving import config as j_cfg
from repro.serving import graph_engine as j_ge
from repro_torch.core import perf_model as t_pm
from repro_torch.core import profiler as t_prof
from repro_torch.core import runtime as t_rt
from repro_torch.core.perf_model import Format
from repro_torch.launch import serve_gnn
from repro_torch.models.gnn import GNN_MODELS
from repro_torch.serving import config as t_cfg
from repro_torch.serving import graph_engine as t_ge

F_IN, HIDDEN, CLASSES = 32, 8, 6
TOL = dict(atol=3e-4, rtol=3e-4)
CHEAP_J = dataclasses.replace(j_pm.TPUCostModel(), eff_transform=1.0,
                              transform_overhead_s=0.0)
CHEAP_T = dataclasses.replace(t_pm.TPUCostModel(), eff_transform=1.0,
                              transform_overhead_s=0.0)


def _engines(model, j_kw=None, t_kw=None, **kw):
    """A reference engine and the port's on the CPU with its weights."""
    kw.setdefault("slots", 3)
    kw.setdefault("min_bucket", 32)
    common = dict(f_in=F_IN, hidden=HIDDEN, n_classes=CLASSES, **kw)
    je = j_ge.GraphServeEngine(model, **common, **(j_kw or {}))
    te = t_ge.GraphServeEngine(
        model, device="cpu", **common, **(t_kw or {}),
        weights={k: np.asarray(v) for k, v in je.weights.items()})
    return je, te


def _engine(model, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("min_bucket", 32)
    return t_ge.GraphServeEngine(model, f_in=F_IN, hidden=HIDDEN,
                                 n_classes=CLASSES, device="cpu", **kw)


def _reqs(n=5, seed=1, sizes=(24, 60)):
    return t_ge.random_requests(n, f_in=F_IN, sizes=sizes, seed=seed)


def test_random_requests_match_the_reference():
    kw = dict(f_in=F_IN, sizes=(24, 60, 150), seed=5, avg_degree=3,
              feat_density=0.0085)
    for j, t in zip(j_ge.random_requests(6, **kw),
                    t_ge.random_requests(6, **kw)):
        assert j.request_id == t.request_id
        np.testing.assert_array_equal(t.adjacency, j.adjacency)
        np.testing.assert_array_equal(t.features, j.features)


@pytest.mark.parametrize("shape,block", [
    ((3, 50, 70), (16, 32)), ((1, 64, 48), (16, 16)),
    ((4, 33, 1), (32, 1)), ((2, 100, 130), (64, 16))])
def test_batched_block_counts_match_the_reference(shape, block):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * (rng.random(shape) < 0.1)).astype(
        np.float32)
    x[0] = 0.0                                        # a dummy slot
    K.reset_launch_counts()
    got = t_prof.batched_block_counts(torch.from_numpy(x), block)
    assert got.dtype == torch.int32
    assert K.launch_counts()["tile_nnz_batched"] == 0  # the plain version
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_prof.batched_block_counts(x, block)))
    for b in range(shape[0]):
        assert torch.equal(got[b], t_prof.block_counts(
            torch.from_numpy(x[b]), block))


@pytest.mark.parametrize("model,cheap", [(m, False) for m in GNN_MODELS]
                         + [("gcn", True)])
def test_run_batch_matches_the_reference(model, cheap):
    """The same stacked wave through both executors: codes and formats
    exactly equal, every stacked output within 3e-4.  ``cheap`` is the
    format-aware case: a TPU cost model with a free transform sends the
    aggregates down the row-CSR route."""
    if cheap:
        je, te = _engines(model, j_kw=dict(cost_model=CHEAP_J),
                          t_kw=dict(cost_model=CHEAP_T), keep_codes=True)
    else:
        je, te = _engines(model, keep_codes=True)
    reqs = _reqs(2, seed=3, sizes=(40,))
    bucket = te.bucket_for(max(r.n_vertices for r in reqs))
    j_cm, t_cm = je._compile(bucket), te._compile(bucket)
    batched = {name: np.stack([je._padded(r, bucket)[name] for r in reqs]
                              + [np.zeros(je._input_shape(name, bucket),
                                          np.float32)])
               for name in je._input_names[bucket]}
    j_outs, _ = je.executor.run_batch(j_cm, je.weights, batched)
    t_outs, rep = te.executor.run_batch(
        t_cm, te.weights,
        {k: torch.from_numpy(v) for k, v in batched.items()})
    assert rep.wave_slots == 3
    assert j_outs.keys() == t_outs.keys()
    for name, out in j_outs.items():
        assert t_outs[name].shape == out.shape
        np.testing.assert_allclose(t_outs[name].numpy(), np.asarray(out),
                                   **TOL)
    j_ex, t_ex = je.executor, te.executor
    assert j_ex.planned_codes.keys() == t_ex.planned_codes.keys()
    for name, codes in j_ex.planned_codes.items():
        np.testing.assert_array_equal(t_ex.planned_codes[name], codes,
                                      err_msg=name)
        np.testing.assert_array_equal(t_ex.planned_formats[name],
                                      j_ex.planned_formats[name])
    for name, d in j_ex.profiled_densities.items():
        np.testing.assert_array_equal(t_ex.profiled_densities[name].numpy(),
                                      np.asarray(d))
    if cheap:
        assert any((f[:2] == Format.CSR).all()
                   for f in t_ex.planned_formats.values())


@pytest.mark.parametrize("model", GNN_MODELS)
def test_serve_matches_the_reference_and_naive(model):
    """Same buckets, waves and request order as the reference, logits
    within 3e-4 of it, and bitwise the port's naive per-request loop."""
    je, te = _engines(model)
    reqs = _reqs()
    j_res = je.serve(j_ge.random_requests(5, f_in=F_IN, sizes=(24, 60),
                                          seed=1))
    t_res = te.serve(reqs)
    assert ([(r.request_id, r.bucket, r.wave) for r in t_res]
            == [(r.request_id, r.bucket, r.wave) for r in j_res])
    assert te.buckets == je.buckets
    for t, j in zip(t_res, j_res):
        assert t.logits.shape == (t.logits.shape[0], CLASSES)
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), **TOL)
    naive = te.run_naive(reqs)
    for s, n in zip(t_res, naive):
        np.testing.assert_array_equal(s.logits, n.logits,
                                      err_msg=f"{model} {s.request_id}")


def test_one_walk_plan_per_shape_bucket():
    eng = _engine("gcn")
    eng.serve(_reqs(7))
    assert len(eng.buckets) == 2
    assert eng.executor.trace_count == len(eng.buckets)
    assert eng.waves > len(eng.buckets)
    hits0 = eng.executor.cache_hits
    eng.serve(_reqs(6, seed=9))
    assert eng.executor.trace_count == 2 and eng.executor.cache_hits > hits0
    eng.serve(t_ge.random_requests(1, f_in=F_IN, sizes=(150,), seed=3))
    assert len(eng.buckets) == 3 and eng.executor.trace_count == 3


def test_request_order_invariance():
    reqs = _reqs(6, seed=4)
    by_id = {r.request_id: r.logits for r in _engine("gcn").serve(reqs)}
    for perm_seed in (0, 1):
        perm = np.random.default_rng(perm_seed).permutation(len(reqs))
        for r in _engine("gcn").serve([reqs[i] for i in perm]):
            np.testing.assert_array_equal(r.logits, by_id[r.request_id])
    for r in _engine("gcn").serve([reqs[2]]):
        np.testing.assert_array_equal(r.logits, by_id[r.request_id])


def test_results_in_request_order_and_sliced():
    eng = _engine("sage", slots=2)
    reqs = [t_ge.GraphRequest(np.eye(n, dtype=np.float32),
                              np.ones((n, F_IN), np.float32),
                              request_id=100 + i)
            for i, n in enumerate((20, 40, 17))]
    res = eng.serve(reqs)
    assert [r.request_id for r in res] == [100, 101, 102]
    assert [r.logits.shape[0] for r in res] == [20, 40, 17]
    assert res[0].bucket == 32 and res[1].bucket == 64


def test_shared_weight_profiles_cached_across_waves():
    eng = _engine("gcn")
    eng.serve(_reqs(6, seed=2, sizes=(24,)))
    n_entries = len(eng.executor._input_profiles)
    assert n_entries > 0
    cached = {k: v[1].counts for k, v in eng.executor._input_profiles.items()}
    eng.serve(_reqs(6, seed=3, sizes=(24,)))
    assert len(eng.executor._input_profiles) == n_entries
    for k, v in eng.executor._input_profiles.items():
        assert v[1].counts is cached[k]


def _bad(case):
    adj, feats = np.eye(8, dtype=np.float32), np.ones((8, F_IN), np.float32)
    if case == "width":
        return t_ge.GraphRequest(adj, np.ones((8, F_IN + 1), np.float32))
    if case == "adjacency":
        return t_ge.GraphRequest(np.eye(30, dtype=np.float32), feats)
    if case == "nan adjacency":
        adj[2, 3] = np.nan
    elif case == "inf adjacency":
        adj[0, 1] = np.inf
    elif case == "nan features":
        feats[1, 1] = np.nan
    elif case == "inf features":
        feats[0, 0] = -np.inf
    elif case == "complex features":
        feats = feats.astype(np.complex64)
    elif case == "object adjacency":
        adj = adj.astype(object)
    return t_ge.GraphRequest(adj, feats)


@pytest.mark.parametrize("case,match", [
    ("width", "feature width"), ("adjacency", "adjacency"),
    ("nan adjacency", "adjacency.*non-finite"),
    ("inf adjacency", "adjacency.*non-finite"),
    ("nan features", "features.*non-finite"),
    ("inf features", "features.*non-finite"),
    ("complex features", "features dtype"),
    ("object adjacency", "adjacency dtype")])
def test_malformed_requests_rejected(case, match):
    eng = _engine("gcn")
    with pytest.raises(ValueError, match=match):
        eng.serve([_bad(case)])
    with pytest.raises(ValueError, match=match):
        eng.run_naive([_bad(case)])
    assert eng.waves == 0


def test_integer_and_bool_inputs_admitted():
    eng = _engine("gcn")
    adj, feats = np.eye(8, dtype=np.float32), np.ones((8, F_IN), np.float32)
    res = eng.serve([t_ge.GraphRequest(adj.astype(bool), feats),
                     t_ge.GraphRequest(adj.astype(np.int32), feats)])
    assert len(res) == 2 and res[0].logits.shape == (8, CLASSES)


def test_wave_report_plumbing():
    eng = _engine("gcn", slots=3)
    reqs = _reqs(2, sizes=(24,))
    out = eng.dispatch_wave(32, reqs)
    assert [r.request_id for r in out] == [r.request_id for r in reqs]
    rep = eng.last_wave_report
    assert rep.wave_slots == 3 and rep.wave_real == 2
    assert rep.gather_seconds > 0.0 and rep.copy_seconds >= 0.0
    assert eng.bucket_walls[32] == [rep.fused_wall_seconds]
    assert eng.wave_loads == [(2, 3)] and eng.served == 2
    with pytest.raises(ValueError, match="wave of"):
        eng.dispatch_wave(32, [])
    with pytest.raises(ValueError, match="wave of"):
        eng.dispatch_wave(32, _reqs(4, sizes=(24,)))


def test_run_batch_report_modes():
    """Lean by default; per-request per-kernel rows under collect_report;
    stacked codes under keep_codes, slot 0's equal to a per-request run."""
    reqs = _reqs(3, sizes=(24,))
    lean = _engine("gcn")
    lean.serve(reqs)
    assert lean.wave_walls[0] > 0.0 and lean.last_wave_report.kernels == []
    full = _engine("gcn", collect_report=True, keep_codes=True)
    full.serve(reqs)
    for codes in full.executor.planned_codes.values():
        assert codes.shape[0] == full.slots
    bucket = full.buckets[0]
    cm = full._compiled[bucket]
    batched = {name: torch.from_numpy(np.stack(
        [full._padded(r, bucket)[name] for r in reqs]))
        for name in full._input_names[bucket]}
    _, rep = full.executor.run_batch(cm, full.weights, batched)
    assert len(rep.kernels) == len(reqs) * len(cm.graph.kernels)
    assert rep.kernels[0].name.endswith("[0]")
    assert rep.kernels[-1].name.endswith(f"[{len(reqs) - 1}]")
    # each slot's rows are its own request's plan: the per-request
    # engine's histogram, and slot 0's codes
    per = t_rt.DynasparseEngine(n_cc=full.n_cc, keep_codes=True)
    for b in range(len(reqs)):
        tensors = dict(full.weights)
        tensors.update({k: v[b] for k, v in batched.items()})
        _, per_rep = per.run(cm, tensors)
        rows = [r for r in rep.kernels if r.name.endswith(f"[{b}]")]
        np.testing.assert_array_equal(
            np.sum([r.histogram for r in rows], axis=0), per_rep.histogram)
        if b == 0:
            for out, codes in per.planned_codes.items():
                np.testing.assert_array_equal(
                    codes, full.executor.planned_codes[out][0])


@pytest.mark.parametrize("model,kw", [(m, {}) for m in GNN_MODELS]
                         + [("gcn", dict(cost_model=CHEAP_T)),
                            ("sage", dict(strategy="s1"))])
def test_each_slot_plans_as_its_request_alone(model, kw):
    """Every real slot's codes and executed formats are exactly those of a
    per-request ``DynasparseEngine`` on the same padded tensors."""
    eng = _engine(model, keep_codes=True, **kw)
    reqs = _reqs(2, seed=8, sizes=(24,))
    eng.serve(reqs)
    per = t_rt.DynasparseEngine(
        strategy=eng.strategy, model=eng.executor.model, n_cc=eng.n_cc,
        keep_codes=True, format_aware=eng.format_aware,
        csr_rmax=eng.csr_rmax)
    bucket = eng.buckets[0]
    for b, req in enumerate(reqs):
        tensors = dict(eng.weights)
        tensors.update({k: torch.from_numpy(v)
                        for k, v in eng._padded(req, bucket).items()})
        per.run(eng._compiled[bucket], tensors)
        assert per.planned_codes.keys() == eng.executor.planned_codes.keys()
        for out, codes in per.planned_codes.items():
            np.testing.assert_array_equal(
                eng.executor.planned_codes[out][b], codes, err_msg=out)
            assert eng.executor.planned_formats[out][b] == \
                per.planned_formats[out]


def test_two_waves_in_flight_equal_dispatched_waves():
    eng = _engine("sage")
    reqs = _reqs(4, seed=6, sizes=(24,))
    first = eng.begin_wave(32, reqs[:3])
    second = eng.begin_wave(32, reqs[3:])
    assert (first.index, second.index) == (0, 1)
    got = eng.finish_wave(first) + eng.finish_wave(second)
    want = eng.dispatch_wave(32, reqs[:3]) + eng.dispatch_wave(32, reqs[3:])
    assert [r.wave for r in got] == [0, 0, 0, 1]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.logits, w.logits)


def test_run_batch_rejects_malformed_waves():
    eng = _engine("gcn")
    cm = eng._compile(32)
    batched = {name: torch.zeros((3,) + eng._input_shape(name, 32))
               for name in eng._input_names[32]}
    with pytest.raises(KeyError, match="missing"):
        eng.executor.run_batch(cm, eng.weights, {})
    with pytest.raises(ValueError, match="slot count"):
        eng.executor.run_batch(cm, eng.weights, dict(
            batched, H0=batched["H0"][:2]))


# -- EngineConfig / merge_config --------------------------------------------

def test_merge_config_rules():
    """The reference's merge rule (``tests/test_serve_config.py``): kwargs
    build a config, override a default-valued field, pass as an equal
    duplicate, raise as a conflicting one or as an unknown field."""
    EC, merge, unset = t_cfg.EngineConfig, t_cfg.merge_config, t_cfg.UNSET
    cfg = merge(EC, None, dict(f_in=16, slots=unset, hidden=32))
    assert (cfg.f_in, cfg.hidden, cfg.slots) == (16, 32, 4)
    base = EC(f_in=16, slots=8)
    assert merge(EC, base, dict(hidden=64)).hidden == 64
    assert merge(EC, base, dict(slots=8)).slots == 8
    with pytest.raises(ValueError, match="slots"):
        merge(EC, base, dict(slots=4))
    with pytest.raises(TypeError, match="nonsense"):
        merge(EC, None, dict(f_in=16, nonsense=1))
    with pytest.raises(ValueError, match="f_in"):
        EC(f_in=0).validate()
    with pytest.raises(ValueError, match="slots"):
        EC(f_in=8, slots=0).validate()


def test_engine_config_keeps_the_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(j_cfg.EngineConfig)}
    port = {f.name: f.default for f in dataclasses.fields(t_cfg.EngineConfig)}
    assert port.pop("device") is None
    # donate is an XLA buffer-donation hint: a torch walk has nothing to
    # alias, and it never changed results
    assert ref.pop("donate") is True
    assert port == ref and port["mesh"] is None


def test_engine_from_config_round_trips():
    eng = _engine("gcn", strategy="s1", n_cc=3)
    clone = t_ge.GraphServeEngine.from_config(eng.config)
    assert clone.config == eng.config
    assert (clone.slots, clone.f_in, clone.device) == (eng.slots, eng.f_in,
                                                       eng.device)
    for name, w in eng.weights.items():
        assert torch.equal(clone.weights[name], w)
    cfg = dataclasses.replace(eng.config, slots=8)
    with pytest.raises(ValueError, match="slots"):
        t_ge.GraphServeEngine(config=cfg, slots=4)


def test_serving_needs_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_ge.GraphServeEngine("gcn", f_in=F_IN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_gnn.main(["--smoke"])
    with pytest.raises(ValueError, match="3-D"):
        t_prof.batched_block_counts(torch.zeros(4, 4), (2, 2))


def test_serve_gnn_cli_smoke_on_the_cpu(capsys):
    assert serve_gnn.main(["--device", "cpu", "--smoke", "--model",
                           "sage"]) == 0
    out = capsys.readouterr().out
    assert "bitwise==naive: True" in out and "traces=" in out
