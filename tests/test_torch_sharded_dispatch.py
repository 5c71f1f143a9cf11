"""The port's multi-device wave dispatch against the JAX package's sharded
path, on the CPU.

The reference shards a wave over a ``cores`` mesh of host devices, which
needs ``XLA_FLAGS=--xla_force_host_platform_device_count=8`` before jax
starts; so its side runs ONCE per module, in a subprocess (the ``ref``
fixture), and writes every result the module compares to a pickle.
Under the installed jax its ``abstract_cores_mesh`` builds an
``AbstractMesh`` with an older signature, so the subprocess replaces that
one function on itself, with the same mesh (``_SHIM``); no other process
sees the change.

The port's side runs on EMULATED lanes (``cores_mesh(n, device="cpu")``):
the same walks, placements and group plans as distinct devices, one lane
after another.  Held:

* each of the five models on meshes of 1, 2, 4 and 8 lanes and on random
  ``partition_mesh`` groups is bitwise the port's unsharded ``run_naive``;
  its codes and formats equal the reference's 8-device run exactly, its
  logits within 3e-4 (``tests/test_kernels.py``'s float32 tolerance);
* slot layouts, equal-size groups sharing one walk plan, the resize
  scheduler's group plans, ``last_auto_lanes``, dispatch logs ``(lane,
  group_size, ...)`` and trace counts equal the reference's exactly, with
  the walls scripted and the clocks fake (``tests/torch_scripted_stream
  .py``);
* then the reference's mesh and resize cases (``tests/test_sharded_
  dispatch.py``, ``tests/test_continuous_serving.py``) inside the port.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import profiler as t_prof
from repro_torch.core import runtime as t_rt
from repro_torch.distributed import sharding
from repro_torch.models.gnn import GNN_MODELS
from repro_torch.serving.graph_engine import GraphServeEngine, random_requests
from repro_torch.serving.scheduler import ContinuousGraphServer
from torch_scripted_stream import (N_STREAM, POLICIES, SERVER_KW,
                                   STREAM_SEED, STREAM_SIZES, FakeClock,
                                   script_walls, stream, stream_clock)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
F_IN, HIDDEN, CLASSES = 16, 8, 5
TOL = dict(atol=3e-4, rtol=3e-4)
# the model zoo's requests: one full 8-slot wave of bucket 32
ZOO = dict(n=8, seed=7, sizes=(20, 28))
# equal-size groups first, then a mixed partition (trace sharing)
PARTITIONS = ([4, 4], [4, 2, 1, 1])
# the resize runs: (name, server kwargs)
RESIZE_RUNS = {
    "poll3": dict(max_wait=0.0),
    "stream": dict(SERVER_KW, **POLICIES["never"]),
    "stream-auto": dict(SERVER_KW, **POLICIES["predicted-miss"],
                        autoscale=True),
}
MESH = 8

_SHIM = """
from jax.sharding import AbstractMesh
from repro.distributed import sharding
sharding.abstract_cores_mesh = lambda n: AbstractMesh((int(n),), ("cores",))
"""

_REFERENCE = """
import pickle, sys
import numpy as np
from repro.serving.graph_engine import GraphServeEngine, random_requests
from repro.serving.scheduler import ContinuousGraphServer
from torch_scripted_stream import (N_STREAM, STREAM_SEED, STREAM_SIZES,
                                   FakeClock, script_walls, stream,
                                   stream_clock)
import test_torch_sharded_dispatch as T

mesh = sharding.cores_mesh(T.MESH)
out = {"zoo": {}, "resize": {}}


def record_waves(eng, waves):
    begin = eng.begin_wave

    def begin_wave(bucket, wave, submesh=None):
        h = begin(bucket, wave, submesh=submesh)
        waves.append({"bucket": bucket, "slot_of": [int(s) for s in h.slot_of],
                      "lanes": h.pending.lanes})
        return h

    finish = eng.finish_wave

    def finish_wave(h):
        res = finish(h)
        ex = eng.executor
        waves[-1].update(
            wave_lanes=eng.last_wave_report.wave_lanes,
            codes={k: np.asarray(v) for k, v in ex.planned_codes.items()},
            formats={k: np.asarray(v)
                     for k, v in ex.planned_formats.items()})
        return res

    eng.begin_wave, eng.finish_wave = begin_wave, finish_wave


reqs = random_requests(T.ZOO["n"], f_in=T.F_IN, sizes=T.ZOO["sizes"],
                       seed=T.ZOO["seed"])
for model in T.GNN_MODELS:
    eng = GraphServeEngine(model, f_in=T.F_IN, hidden=T.HIDDEN,
                           n_classes=T.CLASSES, slots=8, min_bucket=32,
                           mesh=mesh, keep_codes=True)
    waves = []
    record_waves(eng, waves)
    served = eng.serve(reqs)
    rec = {"weights": {k: np.asarray(v) for k, v in eng.weights.items()},
           "logits": {r.request_id: np.asarray(r.logits) for r in served},
           "waves": list(waves), "traces": eng.executor.trace_count}
    if model == "gcn":
        # disjoint groups: equal sizes share one plan, a mixed partition
        # adds the sizes not seen yet
        full = [r for r in reqs if eng.bucket_for(r.n_vertices) == 32][:8]
        groups = []
        for sizes in T.PARTITIONS:
            for sub in sharding.partition_mesh(mesh, sizes):
                res = eng.finish_wave(eng.begin_wave(32, full, submesh=sub))
                groups.append({"size": int(sub.devices.size),
                               "traces": eng.executor.trace_count,
                               "misses": eng.executor.cache_misses,
                               "logits": [np.asarray(r.logits)
                                          for r in res]})
        rec["groups"] = groups
        rec["group_waves"] = waves[len(rec["waves"]):]
        rec["group_walls"] = {k: len(v) for k, v in eng.group_walls.items()}
    out["zoo"][model] = rec

for name, kw in T.RESIZE_RUNS.items():
    eng = GraphServeEngine("gcn", f_in=T.F_IN, hidden=T.HIDDEN,
                           n_classes=T.CLASSES, slots=8, min_bucket=32,
                           mesh=mesh)
    clk = stream_clock() if name != "poll3" else FakeClock()
    script_walls(eng, clk)
    waves = []
    record_waves(eng, waves)
    srv = ContinuousGraphServer(eng, clock=clk, resize=True, **kw)
    plans = []
    dispatch = srv._dispatch_groups

    def dispatch_groups(ready, dispatch=dispatch, srv=srv, plans=plans):
        res = dispatch(ready)
        plans.append((list(srv.last_group_sizes), srv.last_auto_lanes))
        return res

    srv._dispatch_groups = dispatch_groups
    if name == "poll3":
        done = T.poll3(srv, clk, T.resize_requests())
        tickets = []
    else:
        tickets, done = stream(srv, clk, random_requests(
            N_STREAM, f_in=T.F_IN, sizes=STREAM_SIZES, seed=STREAM_SEED),
            np.random.default_rng(3))
    out["resize"][name] = {
        "weights": {k: np.asarray(v) for k, v in eng.weights.items()},
        "log": T.log(srv), "plans": plans, "clock": clk.t,
        "slots": [w["slot_of"] for w in waves],
        "traces": eng.executor.trace_count,
        "tickets": [T.ticket(t) for t in tickets],
        "done": [(r.request_id, np.asarray(r.logits)) for r in done]}

with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


def resize_requests():
    return random_requests(14, f_in=F_IN, sizes=(20, 52, 100), seed=9)


def poll3(srv, clk, reqs):
    """Submit, polling after every third request, then drain (the
    reference's mid-stream resize case)."""
    done = []
    for i, r in enumerate(reqs):
        srv.submit(r)
        clk.advance(0.001)
        if i % 3 == 2:
            done += srv.poll()
    return done + srv.drain()


def log(srv):
    return [(w.bucket, w.n_real, w.reason, w.cut_at, w.wall, w.lane,
             w.group_size, w.classes) for w in srv.dispatch_log]


def ticket(t):
    return (int(t), t.verdict, t.predicted_miss, t.bucket, t.priority,
            t.tenant, t.deadline, t.predicted_wall)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's 8-device sharded runs, in one subprocess."""
    path = tmp_path_factory.mktemp("sharded") / "ref.pkl"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"), HERE]))
    code = textwrap.dedent(_SHIM) + textwrap.dedent(_REFERENCE)
    res = subprocess.run([sys.executable, "-c", code, str(path)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _mesh(n):
    return sharding.cores_mesh(n, device="cpu")


def _engine(mesh=None, slots=4, model="gcn", **kw):
    kw.setdefault("min_bucket", 32)
    return GraphServeEngine(model, f_in=F_IN, hidden=HIDDEN,
                            n_classes=CLASSES, slots=slots, mesh=mesh,
                            device="cpu", **kw)


def _reqs(n=6, seed=2, sizes=(20, 52)):
    return random_requests(n, f_in=F_IN, sizes=sizes, seed=seed)


def _naive(eng, reqs):
    return {r.request_id: r.logits for r in eng.run_naive(reqs)}


def _assert_naive(results, naive, what=""):
    assert sorted(r.request_id for r in results) == sorted(naive)
    for r in results:
        np.testing.assert_array_equal(
            r.logits, naive[r.request_id],
            err_msg=f"{what}: request {r.request_id} != run_naive")


def _random_partition(rng, n=8):
    """Random exact-cover power-of-two group sizes summing to ``n``."""
    sizes, left = [], n
    while left:
        s = int(rng.choice([s for s in (1, 2, 4, 8) if s <= left]))
        sizes.append(s)
        left -= s
    rng.shuffle(sizes)
    return sizes


def _record_waves(eng, waves):
    """Record each wave's slot layout and its planned codes and formats."""
    begin, finish = eng.begin_wave, eng.finish_wave

    def begin_wave(bucket, wave, submesh=None):
        h = begin(bucket, wave, submesh=submesh)
        waves.append({"bucket": bucket, "slot_of": list(h.slot_of),
                      "lanes": h.pending.lanes})
        return h

    def finish_wave(h):
        res = finish(h)
        ex = eng.executor
        waves[-1].update(wave_lanes=eng.last_wave_report.wave_lanes,
                         codes=dict(ex.planned_codes),
                         formats=dict(ex.planned_formats))
        return res

    eng.begin_wave, eng.finish_wave = begin_wave, finish_wave


# -- against the reference's 8-device run -----------------------------------

@pytest.mark.parametrize("model", GNN_MODELS)
def test_model_zoo_matches_the_reference_sharded_run(ref, model):
    """The zoo on an emulated 8-lane mesh: slot layouts, codes, formats
    and plan counts equal the reference's 8-device run; logits within 3e-4
    of it and bitwise the port's unsharded run_naive; then meshes of 1, 2
    and 4 lanes and random device groups, each bitwise run_naive."""
    want = ref["zoo"][model]
    reqs = _reqs(ZOO["n"], ZOO["seed"], ZOO["sizes"])
    eng = _engine(_mesh(MESH), slots=8, model=model, keep_codes=True,
                  weights=want["weights"])
    waves = []
    _record_waves(eng, waves)
    served = eng.serve(reqs)
    naive = _naive(_engine(slots=8, model=model, weights=want["weights"]),
                   reqs)
    _assert_naive(served, naive, f"{model} on 8 lanes")
    for r in served:
        np.testing.assert_allclose(r.logits, want["logits"][r.request_id],
                                   **TOL)
    assert eng.executor.trace_count == want["traces"] == len(eng.buckets)
    assert len(waves) == len(want["waves"])
    for got, exp in zip(waves, want["waves"]):
        assert (got["bucket"], got["slot_of"], got["lanes"],
                got["wave_lanes"]) == (exp["bucket"], exp["slot_of"], MESH,
                                       MESH)
        assert got["codes"].keys() == exp["codes"].keys()
        for name, codes in exp["codes"].items():
            np.testing.assert_array_equal(got["codes"][name], codes,
                                          err_msg=name)
            np.testing.assert_array_equal(got["formats"][name],
                                          exp["formats"][name])
    # other lane counts and random disjoint groups: placement is load
    # balance, never numerics
    for n in (1, 2, 4):
        other = _engine(_mesh(n), slots=8, model=model,
                        weights=want["weights"])
        _assert_naive(other.serve(reqs), naive, f"{model} on {n} lanes")
        assert other.last_wave_report.wave_lanes == n
    rng = np.random.default_rng(11)
    order = [r for r in reqs if eng.bucket_for(r.n_vertices) == 32][:8]
    for round_ in range(2):
        rng.shuffle(order)
        for sub in sharding.partition_mesh(eng.mesh, _random_partition(rng)):
            res = eng.finish_wave(eng.begin_wave(32, order, submesh=sub))
            _assert_naive(res, {r.request_id: naive[r.request_id]
                                for r in order},
                          f"{model} round {round_} group {sub.size}")


def test_equal_size_groups_share_one_plan_as_the_reference(ref):
    """Disjoint same-size groups share ONE walk plan; a mixed partition
    adds just the sizes not seen yet -- the reference's trace and miss
    counts, slot layouts and group walls, exactly."""
    want = ref["zoo"]["gcn"]
    reqs = _reqs(ZOO["n"], ZOO["seed"], ZOO["sizes"])
    eng = _engine(_mesh(MESH), slots=8, weights=want["weights"],
                  keep_codes=True)
    waves = []
    _record_waves(eng, waves)
    eng.serve(reqs)
    full = [r for r in reqs if eng.bucket_for(r.n_vertices) == 32][:8]
    got = []
    for sizes in PARTITIONS:
        for sub in sharding.partition_mesh(eng.mesh, sizes):
            res = eng.finish_wave(eng.begin_wave(32, full, submesh=sub))
            got.append((sub.size, eng.executor.trace_count,
                        eng.executor.cache_misses, res))
    exp = want["groups"]
    assert [g[:3] for g in got] == [(e["size"], e["traces"], e["misses"])
                                    for e in exp]
    assert [w["slot_of"] for w in waves] == [
        w["slot_of"] for w in want["waves"] + want["group_waves"]]
    for (_, _, _, res), e in zip(got, exp):
        for r, logits in zip(res, e["logits"]):
            np.testing.assert_allclose(r.logits, logits, **TOL)
    assert {k: len(v) for k, v in eng.group_walls.items()} == \
        want["group_walls"]


def test_slot_layouts_of_every_group_size_match_the_reference(ref):
    """The submesh waves of the reference's gcn run: each wave's slot
    layout at its group size."""
    want = ref["zoo"]["gcn"]["group_waves"]
    reqs = _reqs(ZOO["n"], ZOO["seed"], ZOO["sizes"])
    eng = _engine(slots=8)
    full = [r for r in reqs if eng.bucket_for(r.n_vertices) == 32][:8]
    sizes = [s for p in PARTITIONS for s in p]
    assert len(want) == len(sizes)
    for size, w in zip(sizes, want):
        assert w["lanes"] == size
        assert eng._slot_layout(full, size) == w["slot_of"]


@pytest.mark.parametrize("name", sorted(RESIZE_RUNS))
def test_resize_scheduler_matches_the_reference(ref, name):
    """One stream through both resize servers on 8 lanes, walls scripted
    and clocks fake: every tick's group plan and autoscaled lane count,
    the dispatch log (lane, group size, wall, cut reason and time), each
    wave's slot layout, tickets and trace counts equal; logits within 3e-4
    of the reference's and bitwise the port's run_naive."""
    want = ref["resize"][name]
    eng = _engine(_mesh(MESH), slots=8, weights=want["weights"])
    clk = stream_clock() if name != "poll3" else FakeClock()
    script_walls(eng, clk)
    waves = []
    _record_waves(eng, waves)
    srv = ContinuousGraphServer(eng, clock=clk, resize=True,
                                **RESIZE_RUNS[name])
    assert srv.n_lanes == (RESIZE_RUNS[name].get("n_lanes") or MESH)
    plans = []
    dispatch = srv._dispatch_groups

    def dispatch_groups(ready):
        res = dispatch(ready)
        plans.append((list(srv.last_group_sizes), srv.last_auto_lanes))
        return res

    srv._dispatch_groups = dispatch_groups
    if name == "poll3":
        reqs = resize_requests()
        done = poll3(srv, clk, reqs)
        tickets = []
    else:
        reqs = random_requests(N_STREAM, f_in=F_IN, sizes=STREAM_SIZES,
                               seed=STREAM_SEED)
        tickets, done = stream(srv, clk, reqs, np.random.default_rng(3))
    assert plans == want["plans"]
    assert log(srv) == want["log"]
    assert clk.t == want["clock"]
    assert [w["slot_of"] for w in waves] == want["slots"]
    assert eng.executor.trace_count == want["traces"]
    assert [ticket(t) for t in tickets] == want["tickets"]
    assert [r.request_id for r in done] == [i for i, _ in want["done"]]
    for r, (_, logits) in zip(done, want["done"]):
        np.testing.assert_allclose(r.logits, logits, **TOL)
    _assert_naive(done, _naive(eng, [r for r in reqs if r.request_id in {
        d.request_id for d in done}]), name)
    sizes = {w.group_size for w in srv.dispatch_log}
    assert len(sizes) > 1, sizes
    if name == "poll3":
        assert len({tuple(p) for p, _ in plans}) > 1
    if name == "stream-auto":
        # ticks that cut no wave plan nothing and keep the last count
        assert {k for _, k in plans} - {None}


# -- the reference's mesh cases, inside the port -----------------------------

def test_one_device_mesh_bitwise_parity():
    plain, meshed = _engine(), _engine(mesh=_mesh(1))
    reqs = _reqs()
    for p, m in zip(plain.serve(reqs), meshed.serve(reqs)):
        assert p.request_id == m.request_id
        np.testing.assert_array_equal(p.logits, m.logits)
    assert meshed.last_wave_report.wave_lanes == 1
    assert meshed.group_walls.keys() == {1}


def test_slot_layout_is_cost_balanced_permutation():
    eng = _engine(slots=8)
    eng.lanes = 4                   # placement only; no mesh dispatch
    reqs = _reqs(7)
    layout = eng._slot_layout(reqs)
    assert len(set(layout)) == len(layout)
    per_lane = [sum(1 for s in layout if s // 2 == lane)
                for lane in range(4)]
    assert max(per_lane) <= 2
    assert eng._slot_layout(reqs) == layout


def test_slot_placement_never_changes_numerics():
    fifo, permuted = _engine(slots=4), _engine(slots=4)
    permuted.lanes = 2              # permute slots; mesh stays None
    reqs = _reqs(5)
    for a, b in zip(fifo.serve(reqs), permuted.serve(reqs)):
        np.testing.assert_array_equal(a.logits, b.logits)


def test_invalid_mesh_and_slots_rejected():
    """slots must divide over the mesh; run_batch rejects a mesh that is
    not 1-D over the cores axis; cores_mesh rejects impossible counts.
    The texts are the reference's."""
    with pytest.raises(ValueError, match="not divisible") as e:
        _engine(mesh=_mesh(2), slots=3)
    assert str(e.value) == "slots=3 not divisible by the 2-device cores mesh"
    bad = sharding.CoresMesh((torch.device("cpu"),),
                             axis_names=("notcores",))
    eng = _engine(mesh=bad, slots=4)
    with pytest.raises(ValueError, match="cores") as e:
        eng.serve(_reqs(1))
    assert str(e.value) == ("run_batch mesh must be 1-D over 'cores', got "
                            "('notcores',)")
    with pytest.raises(ValueError):
        sharding.cores_mesh(10 ** 6)
    eng = _engine(slots=4)
    with pytest.raises(ValueError, match="submesh group"):
        eng.begin_wave(32, _reqs(1, sizes=(20,)), submesh=_mesh(3))
    cm = eng._compile(32)
    batched = {name: torch.zeros((4,) + eng._input_shape(name, 32))
               for name in eng._input_names[32]}
    with pytest.raises(ValueError, match="4 slots not divisible by 3"):
        eng.executor.run_batch(cm, eng.weights, batched, mesh=_mesh(3))


def test_each_lane_profiles_its_own_slots(monkeypatch):
    """A D-lane wave makes D batched profiles per (request input,
    granularity), each over B/D slots, and its counts per slot equal the
    whole stack's exactly."""
    calls = []
    real = t_prof.batched_block_counts

    def counted(x, block):
        out = real(x, block)
        calls.append((int(x.shape[0]), (tuple(x.shape[1:]), tuple(block)),
                      out))
        return out

    monkeypatch.setattr(t_prof, "batched_block_counts", counted)
    eng = _engine(slots=8)
    reqs = _reqs(8, sizes=(20,))
    cm = eng._compile(32)
    batched = {name: torch.zeros((8,) + eng._input_shape(name, 32))
               for name in eng._input_names[32]}
    for i, r in enumerate(reqs):
        eng._fill_slot(r, {n: v[i].numpy() for n, v in batched.items()})
    flows = t_rt.FusedModelExecutor._resolved_flows(cm)
    needed = [(n, b) for n, b in t_rt.FusedModelExecutor._needed_inputs(
        flows) if n in batched]
    whole = {(n, b): real(batched[n], b) for n, b in needed}
    for lanes in (1, 2, 4, 8):
        calls.clear()
        eng.executor.run_batch(cm, eng.weights, batched, mesh=_mesh(lanes))
        assert len(calls) == lanes * len(needed)
        assert {c[0] for c in calls} == {8 // lanes}
        for (n, b) in needed:
            mine = [c[2] for c in calls
                    if c[1] == (tuple(batched[n].shape[1:]), tuple(b))]
            assert torch.equal(torch.cat(mine), whole[(n, b)])


def test_shared_weights_copied_once_per_device():
    """A lane on another device gets one copy of each weight, reused while
    the weight tensor is the same object."""
    ex = t_rt.FusedModelExecutor()
    shared = {"W": torch.ones(4, 4), "V": torch.zeros(2)}
    assert ex._shared_on(shared, torch.device("cpu")) is shared
    assert ex._shared_on(shared, None) is shared
    meta = torch.device("meta")
    a = ex._shared_on(shared, meta)
    b = ex._shared_on(shared, meta)
    assert all(a[k] is b[k] and a[k].device == meta for k in shared)
    shared["W"] = torch.ones(4, 4)
    c = ex._shared_on(shared, meta)
    assert c["W"] is not a["W"] and c["V"] is a["V"]


def test_eight_lane_mesh_bitwise_parity_and_one_plan_per_bucket():
    mesh = _mesh(8)
    meshed, plain = _engine(mesh=mesh, slots=8), _engine(slots=8)
    reqs = _reqs(11)
    naive = _naive(meshed, reqs)
    sharded = meshed.serve(reqs)
    _assert_naive(sharded, naive, "8 lanes")
    unsharded = {r.request_id: r.logits for r in plain.serve(reqs)}
    for r in sharded:
        np.testing.assert_array_equal(r.logits, unsharded[r.request_id])
    assert meshed.last_wave_report.wave_lanes == 8
    traces = meshed.executor.trace_count
    assert traces == len(meshed.buckets)
    meshed.serve(reqs)
    meshed.serve(list(reversed(reqs)))
    assert meshed.executor.trace_count == traces


def test_multilane_continuous_parity_and_lanes():
    eng = _engine(mesh=_mesh(8), slots=8)
    srv = ContinuousGraphServer(eng, max_wait=0.0)
    assert srv.n_lanes == 8 and srv.pipeline_depth == 2
    reqs = _reqs(9)
    done = []
    for r in reqs:
        srv.submit(r)
        done += srv.poll()
    done += srv.drain()
    assert srv.dispatched == srv.submitted == len(reqs)
    _assert_naive(done, _naive(eng, reqs), "multi-lane")
    assert all(0 <= w.lane < srv.n_lanes and w.group_size == 8
               for w in srv.dispatch_log)


# -- the reference's resize cases, inside the port --------------------------

def _server(eng, clk, **kw):
    kw.setdefault("cold_start_wall", 0.01)
    kw.setdefault("max_wait", 100.0)
    kw.setdefault("batch_patience", float("inf"))
    return ContinuousGraphServer(eng, clock=clk, **kw)


def test_resize_requires_mesh():
    with pytest.raises(ValueError, match="mesh") as e:
        ContinuousGraphServer(_engine(), resize=True)
    assert str(e.value) == ("resize=True needs an engine with a cores mesh "
                            "to partition")


def test_resize_one_device_mesh_matches_unsharded():
    """The one full-mesh group on ONE device: the same waves, cut reasons,
    wait bound and logits as the plain single-lane server (walls
    scripted, so both see the same ones)."""
    clk_a, clk_b = FakeClock(), FakeClock()
    eng_a, eng_b = _engine(slots=3), _engine(slots=3, mesh=_mesh(1))
    script_walls(eng_a, clk_a)
    script_walls(eng_b, clk_b)
    plain = _server(eng_a, clk_a, max_wait=1.0)
    resized = _server(eng_b, clk_b, max_wait=1.0, resize=True)
    assert resized.n_lanes == 1 and resized.pipeline_depth == 1
    reqs = _reqs(7, seed=12)
    done_a, done_b = [], []
    for r in reqs:
        plain.submit(r)
        resized.submit(r)
        clk_a.advance(0.4), clk_b.advance(0.4)
        done_a += plain.poll()
        done_b += resized.poll()
    done_a += plain.drain()
    done_b += resized.drain()
    assert [(w.bucket, w.n_real, w.reason) for w in plain.dispatch_log] == \
           [(w.bucket, w.n_real, w.reason) for w in resized.dispatch_log]
    assert all(w.group_size == 1 for w in resized.dispatch_log)
    for a, b in zip(done_a, done_b):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(a.logits, b.logits)
    for srv in (plain, resized):
        srv._ewma_for(32).value = 0.02
        srv._ewma_for(64).value = 0.07
        srv._queues.setdefault(32, []).append(object())
    assert resized.wait_bound(64) == pytest.approx(plain.wait_bound(64))


def test_resize_wide_group_for_large_wave():
    """Five waves of very different estimated walls in one tick: the
    heavy bucket gets the 4-device group, each light wave one device."""
    clk = FakeClock()
    eng = GraphServeEngine("gcn", f_in=F_IN, hidden=4, n_classes=CLASSES,
                           slots=8, min_bucket=8, mesh=_mesh(8))
    srv = _server(eng, clk, max_wait=1.0, resize=True)
    for n in (6, 12, 24, 48, 96):
        srv.submit(random_requests(1, f_in=F_IN, sizes=(n,), seed=n)[0])
    for b in (8, 16, 32, 64):
        srv._ewma_for(b).value = 0.01
    srv._ewma_for(128).value = 10.0
    clk.advance(2.0)
    done = srv.poll()
    assert len(done) == 5 and srv.pending == 0
    assert srv.last_group_sizes == [4, 1, 1, 1, 1]
    width = {w.bucket: w.group_size for w in srv.dispatch_log}
    assert width[128] == 4
    assert all(width[b] == 1 for b in (8, 16, 32, 64))
    assert len({w.lane for w in srv.dispatch_log}) == 5


def test_resize_single_lane_full_mesh_matches_shared_mesh():
    """``n_lanes=1`` under resize always plans the one full-mesh group:
    the shared-mesh single-lane server's decisions and logits (walls
    scripted, so both see the same ones)."""
    clk_a, clk_b = FakeClock(), FakeClock()
    mesh = _mesh(8)
    eng_a, eng_b = _engine(slots=8, mesh=mesh), _engine(slots=8, mesh=mesh)
    script_walls(eng_a, clk_a)
    script_walls(eng_b, clk_b)
    shared = _server(eng_a, clk_a, max_wait=1.0, n_lanes=1)
    resized = _server(eng_b, clk_b, max_wait=1.0, n_lanes=1, resize=True)
    reqs = _reqs(11, seed=13)
    done_a, done_b = [], []
    for r in reqs:
        shared.submit(r)
        resized.submit(r)
        clk_a.advance(0.3), clk_b.advance(0.3)
        done_a += shared.poll()
        done_b += resized.poll()
    done_a += shared.drain()
    done_b += resized.drain()
    assert [(w.bucket, w.n_real, w.reason) for w in shared.dispatch_log] == \
           [(w.bucket, w.n_real, w.reason) for w in resized.dispatch_log]
    assert all(w.group_size == 8 for w in resized.dispatch_log)
    assert resized.last_group_sizes == [8]
    assert clk_a.t == clk_b.t
    for a, b in zip(done_a, done_b):
        assert a.request_id == b.request_id
        np.testing.assert_array_equal(a.logits, b.logits)


def test_resize_starvation_freedom():
    clk = FakeClock()
    eng = _engine(slots=8, mesh=_mesh(8))
    srv = _server(eng, clk, max_wait=1.0, resize=True)
    reqs = _reqs(10, seed=14, sizes=(24, 60, 100))
    done = []
    for i, r in enumerate(reqs):
        srv.submit(r, deadline=clk.t + 1e6 if i % 2 else None)
        done += srv.poll()
    for _ in range(10):
        clk.advance(0.6)
        done += srv.poll()
        if srv.pending == 0:
            break
    assert srv.pending == 0 and srv.dispatched == len(reqs)
    assert all(w.group_size >= 1 for w in srv.dispatch_log)
    _assert_naive(done, _naive(eng, reqs), "starvation")


@pytest.mark.parametrize("lanes", [1, 8])
def test_resize_warmup_covers_group_placements(lanes):
    """Resize warmup runs every reachable group placement twice, buckets
    served before included, so the group-wall minimum is a steady-state
    wall and traffic builds no plan."""
    clk = FakeClock()
    eng = _engine(slots=2 if lanes == 1 else 8, mesh=_mesh(lanes))
    eng.dispatch_wave(32, _reqs(1, seed=3, sizes=(24,)))   # pre-served
    srv = _server(eng, clk, resize=True)
    srv.warmup((24, 60))
    assert eng.buckets == [32, 64]
    if lanes == 1:
        # 1 pre-serve + 2 fresh-bucket waves + 2 per bucket per placement
        assert {k: len(v) for k, v in eng.group_walls.items()} == {1: 7}
    else:
        # full-mesh: pre-serve + 2 fresh; then 8/s groups of each size s,
        # 2 waves per bucket each
        assert {k: len(v) for k, v in eng.group_walls.items()} == {
            1: 32, 2: 16, 4: 8, 8: 3 + 4}
    traces0 = eng.executor.trace_count
    for r in _reqs(4, seed=4, sizes=(24, 60)):
        srv.submit(r, deadline=clk.t + 1e9)
    srv.drain()
    assert eng.executor.trace_count == traces0


def test_resize_midstream_parity():
    """Groups replanned between waves as the queue's bucket mix shifts;
    every result bitwise run_naive."""
    eng = _engine(mesh=_mesh(8), slots=8)
    srv = ContinuousGraphServer(eng, max_wait=0.0, resize=True)
    rng = np.random.default_rng(5)
    reqs = _reqs(14, seed=9, sizes=(20, 52, 100))
    order = list(reqs)
    rng.shuffle(order)
    done, plans = [], []
    for i, r in enumerate(order):
        srv.submit(r)
        if i % 3 == 2:
            done += srv.poll()
            plans.append(tuple(srv.last_group_sizes))
    done += srv.drain()
    plans.append(tuple(srv.last_group_sizes))
    assert srv.dispatched == srv.submitted == len(reqs)
    assert len(set(plans)) > 1, plans
    _assert_naive(done, _naive(eng, reqs), "midstream")
    assert all(w.group_size in (1, 2, 4, 8) for w in srv.dispatch_log)
    # one plan per (bucket, group size) at most
    pairs = {(w.bucket, w.group_size) for w in srv.dispatch_log}
    assert eng.executor.trace_count <= len(pairs)


def test_resize_pipeline_depth_and_group_estimate():
    eng = _engine(mesh=_mesh(4), slots=4)
    srv = ContinuousGraphServer(eng, resize=True, cold_start_wall=0.03)
    assert srv.pipeline_depth == srv.n_lanes == 4
    assert srv.group_estimate(2) == pytest.approx(0.03)
    eng.group_walls[2] = [0.5, 0.2]
    fresh = ContinuousGraphServer(eng, resize=True, n_lanes=2)
    assert fresh.group_estimate(2) == pytest.approx(0.2)
    assert fresh.pipeline_depth == 2
    srv2 = ContinuousGraphServer(eng, n_lanes=4)
    assert srv2.pipeline_depth == 2
