"""``repro_torch.trace``: the spans and counters inside the executor and
the walk.

On the CPU: the spans of ``FusedModelExecutor.run`` (and of a wave and of
``DynasparseEngine``) nest in walk order under their parent and are plain
CPU ops, not user annotations; none is opened without a profiler; the
outputs are bitwise the same with and without one; ``runs``,
``host_syncs`` and ``profile_bytes`` count what the walk does; the
bitmask pass's repeat rule (``dispatch.count_bitmask_pass``); the launch
counts keep their keys.  The ``card`` test checks the CUDA route's
``bitmask_bytes`` and that no device event of a profiler window carries a
``repro_torch.`` name.

Imports neither jax nor the JAX package, so it runs on the GPU machine:
``PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py``.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.kernels as K
from repro_torch import trace
from repro_torch.core import perf_model, runtime
from repro_torch.core.ir import KernelType
from repro_torch.kernels import dispatch
from repro_torch.models import gnn

# the TPU model with a free transform plans row-CSR, so `.format` runs
CHEAP_TPU = dataclasses.replace(perf_model.TPUCostModel(),
                                eff_transform=1.0, transform_overhead_s=0.0)
REQUEST_INPUTS = ("A", "A_mean", "H0")


def bundle(model, device="cpu"):
    return gnn.build_dense(model, "CO", scale=0.05, seed=2, device=device)


def spans_of(prof):
    """The ``repro_torch.`` events of a profiler session, in start order."""
    return sorted((e for e in prof.events()
                   if e.name.startswith(trace.PREFIX)),
                  key=lambda e: e.time_range.start)


def recorded(fn, device="cpu"):
    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
    return out, prof


def kernel_names(b, fmt=False):
    """The spans of each kernel of ``b``'s walk, in order; with ``fmt``
    the Aggregates convert to ELL (only they plan a format)."""
    out = []
    for k in b.compiled.graph.topo_order():
        s = trace.kernel_spans(k.name)
        conv = fmt and k.kernel_type == KernelType.AGGREGATE
        out += [s.kernel, s.plan] + ([s.format] if conv else []) + [
            s.block_path, s.epilogue, s.writeback]
    return out


@pytest.mark.parametrize("model,cost", [("gcn", None), ("sage", None),
                                        ("sage", "tpu")])
def test_run_spans_nest_in_walk_order(model, cost):
    b = bundle(model)
    ex = runtime.FusedModelExecutor(
        collect_report=False, model=CHEAP_TPU if cost else None)
    ex.run(b.compiled, b.tensors)
    _, prof = recorded(lambda: ex.run(b.compiled, b.tensors))
    got = spans_of(prof)
    want = ([trace.RUN, trace.RUN_SIGNATURE, trace.RUN_INPUT_PROFILES]
            + kernel_names(b, fmt=cost is not None)
            + [trace.RUN_SYNC, trace.RUN_REPORT])
    assert [e.name for e in got] == want
    by_name = {e.name: e for e in got}
    for e in got:
        assert not e.is_user_annotation, e.name
        if e.name == trace.RUN:
            continue
        parent = e.name.rsplit(".", 1)[0]
        if parent not in by_name:        # a kernel span: under the run
            parent = trace.RUN
        assert e.cpu_parent is not None and e.cpu_parent.name == parent, \
            e.name


def test_engine_and_wave_spans():
    b = bundle("gcn")
    eng = runtime.DynasparseEngine()
    _, prof = recorded(lambda: eng.run(b.compiled, b.tensors))
    assert [e.name for e in spans_of(prof)] == [
        n for n in kernel_names(b) if not n.endswith(".plan")]

    ex = runtime.FusedModelExecutor(collect_report=False)
    shared = {k: v for k, v in b.tensors.items() if k not in REQUEST_INPUTS}
    batched = {k: torch.stack([v, v]) for k, v in b.tensors.items()
               if k in REQUEST_INPUTS}
    _, prof = recorded(lambda: ex.run_batch(b.compiled, shared, batched))
    got = spans_of(prof)
    assert [e.name for e in got] == ([trace.WAVE_LAUNCH]
                                     + kernel_names(b) * 2
                                     + [trace.WAVE_FINISH])
    walk = {trace.kernel_spans(k.name).kernel
            for k in b.compiled.graph.kernels}
    assert all(e.cpu_parent.name == trace.WAVE_LAUNCH
               for e in got if e.name in walk)


def test_no_span_without_a_profiler(monkeypatch):
    opened = []
    monkeypatch.setattr(trace, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    b = bundle("sage")
    runtime.FusedModelExecutor().run(b.compiled, b.tensors)
    runtime.DynasparseEngine().run(b.compiled, b.tensors)
    assert opened == []
    assert trace.span(trace.RUN) is trace.span(None)


@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_outputs_bitwise_with_and_without_a_profiler(model):
    b = bundle(model)
    ex = runtime.FusedModelExecutor(keep_intermediates=True,
                                    collect_report=False)
    plain, _ = ex.run(b.compiled, b.tensors)
    (traced, _), _ = recorded(lambda: ex.run(b.compiled, b.tensors))
    assert plain.keys() == traced.keys()
    for name in plain:
        assert torch.equal(plain[name], traced[name]), name


@pytest.mark.parametrize("collect_report", [False, True])
@pytest.mark.parametrize("model", ["gcn", "sage"])
def test_runs_syncs_and_profile_bytes(model, collect_report):
    b = bundle(model)
    ex = runtime.FusedModelExecutor(collect_report=collect_report,
                                    keep_intermediates=True)
    kernels = b.compiled.graph.topo_order()
    plan_inputs = ex._needed_inputs(ex._resolved_flows(b.compiled))
    K.reset_launch_counts()
    env, _ = ex.run(b.compiled, b.tensors)
    writebacks = sum(env[k.out].numel() * 4 for k in kernels)
    inputs = sum(b.tensors[name].numel() * 4 for name, _ in plan_inputs)
    ex.run(b.compiled, b.tensors)           # the inputs' profiles cached
    fresh = dict(b.tensors, H0=b.tensors["H0"].clone())
    ex.run(b.compiled, fresh)               # H0 profiled again
    h0 = sum(b.tensors["H0"].numel() * 4 for name, _ in plan_inputs
             if name == "H0")
    c = trace.counters()
    assert c["runs"] == 3
    assert c["host_syncs"] == 3 * (1 + (3 * len(kernels)
                                        if collect_report else 0))
    assert c["profile_bytes"] == inputs + h0 + 3 * writebacks
    assert c["run_host_ns"] > 0
    assert "bitmask_bytes" not in c          # no walk on the CPU
    K.reset_launch_counts()
    assert "runs" not in trace.counters()


def test_wave_counts_one_run_per_slot():
    b = bundle("gcn")
    ex = runtime.FusedModelExecutor(collect_report=False, keep_codes=True)
    shared = {k: v for k, v in b.tensors.items() if k not in REQUEST_INPUTS}
    batched = {k: torch.stack([v, v, v]) for k, v in b.tensors.items()
               if k in REQUEST_INPUTS}
    K.reset_launch_counts()
    ex.run_batch(b.compiled, shared, batched)
    c = trace.counters()
    assert c["runs"] == 3
    # no event on the CPU; keep_codes brings codes and formats to the host
    assert c["host_syncs"] == 2 * len(b.compiled.graph.kernels)


def test_bitmask_repeat_rule():
    K.reset_launch_counts()
    x = torch.ones(8, 12)
    nb = x.numel() * 4

    def counted():
        c = trace.counters()
        return c.get("bitmask_bytes", 0), c.get("bitmask_repeat_bytes", 0)

    dispatch.count_bitmask_pass(x, 16, 100)
    assert counted() == (nb, 0)                  # first pass: new
    dispatch.count_bitmask_pass(x, 16, 50)
    assert counted() == (2 * nb, nb)             # same object: repeat
    dispatch.count_bitmask_pass(x, 32, 50)
    assert counted() == (3 * nb, nb)             # another k-block edge: new
    dispatch.count_bitmask_pass(x, 32, 50)
    assert counted() == (4 * nb, 2 * nb)
    x.mul_(2.0)
    dispatch.count_bitmask_pass(x, 16, 50)
    assert counted() == (5 * nb, 2 * nb)         # written in place: new
    assert trace.counters()["walk_scratch_bytes"] == 100
    K.reset_launch_counts()                      # the memory survives
    dispatch.count_bitmask_pass(x, 16, 10)
    assert counted() == (nb, nb)
    assert dispatch.count_bitmask_pass(x.clone(), 16, 10) is None
    assert counted() == (2 * nb, nb)             # a fresh tensor: new
    y = torch.ones(8, 12)
    dispatch.count_bitmask_pass(y, 16, 10)
    del y                                        # its memory is dropped
    dispatch.count_bitmask_pass(torch.ones(8, 12), 16, 10)
    assert counted() == (4 * nb, nb)             # a reused address: new
    with torch.inference_mode():
        z = torch.ones(8, 12)
    dispatch.count_bitmask_pass(z, 16, 10)
    dispatch.count_bitmask_pass(z, 16, 10)
    assert counted() == (6 * nb, nb)             # no version kept: new


def test_launch_counts_keep_their_keys():
    K.reset_launch_counts()
    counts = K.launch_counts()
    assert set(counts) == set(K.KERNEL_MODULES) | {"tile_nnz_batched"}
    assert all(v == 0 for v in counts.values())
    dispatch.launches += 2
    trace.count("runs")
    c = trace.counters()
    assert K.launch_counts()["dispatch"] == c["launch.dispatch"] == 2
    assert {k for k in c if k.startswith("launch.")} == {
        f"launch.{k}" for k in counts}
    K.reset_launch_counts()
    assert K.launch_counts() == counts and "runs" not in trace.counters()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
def test_card_bitmask_bytes_and_no_span_on_the_device(cuda):
    b = bundle("sage", device=cuda)
    ex = runtime.FusedModelExecutor(collect_report=False,
                                    keep_intermediates=True)
    plain, _ = ex.run(b.compiled, b.tensors)
    K.reset_launch_counts()
    (traced, _), prof = recorded(lambda: ex.run(b.compiled, b.tensors),
                                 device=cuda)
    for name in plain:
        assert torch.equal(plain[name], traced[name]), name
    c = trace.counters()
    kernels = b.compiled.graph.topo_order()
    lhs = [traced[runtime._agg_lhs_name(k) if k.lhs == "A" else k.lhs]
           for k in kernels]
    # each float32 walk passes once over its whole lhs but where a held
    # format serves it: A_mean and the features are the objects of the run
    # before, so this run builds their formats (repeated passes) and the
    # second Aggregate reuses A_mean's; the rest are fresh
    reused = c["bitmask_reused_bytes"]
    assert c["launch.dispatch"] == len(kernels)
    assert c["walk_format_builds"] == 2 and c["walk_format_hits"] == 1
    assert reused == b.tensors["A_mean"].numel() * 4
    assert c["bitmask_bytes"] + reused == sum(x.numel() * 4 for x in lhs)
    assert c["bitmask_repeat_bytes"] + reused == sum(
        x.numel() * 4 for x in lhs
        if x is b.tensors["A_mean"] or x is b.tensors["H0"])
    assert c["walk_scratch_bytes"] > 0
    assert c["runs"] == 1 and c["host_syncs"] == 1
    names = [e.name for e in spans_of(prof)]
    assert names[0] == trace.RUN and trace.RUN_SYNC in names
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name.startswith(trace.PREFIX)]
    assert on_device == []
