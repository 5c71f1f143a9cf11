"""The port's continuous scheduler against the JAX package's, on the CPU.

Two halves:

* parity with the reference -- ``request_cost``, the host ``select``,
  ``CostCalibration``, ``ServeConfig`` and ``cut_wave`` exactly; and one
  stream through both ``ContinuousGraphServer``s under one fake clock
  each, with the walls scripted: each engine's ``finish_wave`` is wrapped
  so that it overwrites the wave's measured launch-to-ready wall with the
  same scripted value and advances the clock by it (measured walls never
  agree between two programs; ``tests/torch_scripted_stream.py``, which
  ``chip_smoke.py`` shares).  The dispatch log, tickets, class counters
  and shed log must be equal, and the logits within 3e-4 (the float32
  tolerance of ``tests/test_kernels.py``);
* the reference's single-device scheduler cases
  (``tests/test_continuous_serving.py``, ``tests/test_overload.py``) run
  inside the port, where continuous results must equal ``run_naive`` bit
  for bit.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import perf_model as j_pm
from repro.serving import config as j_cfg
from repro.serving import graph_engine as j_ge
from repro.serving import scheduler as j_sch
from repro_torch.core import perf_model as t_pm
from repro_torch.serving import config as t_cfg
from repro_torch.serving import graph_engine as t_ge
from repro_torch.serving.graph_engine import GraphRequest, random_requests
from repro_torch.serving.scheduler import (ClassStats, ContinuousGraphServer,
                                           Ticket)
from torch_scripted_stream import (N_STREAM, POLICIES, SERVER_KW,
                                   STREAM_SEED, STREAM_SIZES, FakeClock,
                                   script_walls, stream, stream_clock)

F_IN, HIDDEN, CLASSES = 32, 8, 6
TOL = dict(atol=3e-4, rtol=3e-4)


def _engine(**kw):
    kw.setdefault("slots", 3)
    kw.setdefault("min_bucket", 32)
    return t_ge.GraphServeEngine("gcn", f_in=F_IN, hidden=HIDDEN,
                                 n_classes=CLASSES, device="cpu", **kw)


def _reqs(n=5, seed=1, sizes=(24, 60)):
    return random_requests(n, f_in=F_IN, sizes=sizes, seed=seed)


def _server(eng, clk, **kw):
    kw.setdefault("cold_start_wall", 0.01)
    kw.setdefault("max_wait", 100.0)       # age cut off unless a test asks
    kw.setdefault("batch_patience", float("inf"))   # ditto
    return ContinuousGraphServer(eng, clock=clk, **kw)


def _assert_naive(eng, results, reqs):
    """Every request delivered once, each bitwise ``run_naive``'s."""
    by_id = {r.request_id: r for r in results}
    assert len(by_id) == len(results)
    assert sorted(by_id) == sorted(r.request_id for r in reqs)
    for want, req in zip(eng.run_naive(reqs), reqs):
        got = by_id[want.request_id]
        assert got.logits.shape == (req.n_vertices, CLASSES)
        np.testing.assert_array_equal(
            got.logits, want.logits,
            err_msg=f"request {want.request_id} differs from run_naive")


# -- parity with the reference ----------------------------------------------

COST_MODELS = {"fpga": (j_pm.FPGACostModel, t_pm.FPGACostModel),
               "tpu": (j_pm.TPUCostModel, t_pm.TPUCostModel)}


@pytest.mark.parametrize("model", sorted(COST_MODELS))
def test_host_select_matches_the_reference(model):
    j_cls, t_cls = COST_MODELS[model]
    jm, tm = j_cls(), t_cls()
    grid = [0.0, 1e-4, 0.003, 0.015, 0.0625, 0.2, 0.49, 0.5, 0.7, 1.0]
    grid += list(np.random.default_rng(0).random(40))
    for a in grid:
        for b in grid[::3]:
            assert tm.select(a, b) == jm.select(a, b), (a, b)


@pytest.mark.parametrize("model", sorted(COST_MODELS))
def test_request_cost_matches_the_reference(model):
    """The same float, exactly, on requests of every primitive: the
    Aggregate's densities decide SPMM/SpDMM/GEMM, an all-zero feature
    matrix SKIP; and the memo is keyed by (cost model, f_in)."""
    j_cls, t_cls = COST_MODELS[model]
    je = j_ge.GraphServeEngine("gcn", f_in=F_IN, hidden=HIDDEN,
                               n_classes=CLASSES, cost_model=j_cls())
    te = t_ge.GraphServeEngine("gcn", f_in=F_IN, hidden=HIDDEN,
                               n_classes=CLASSES, cost_model=t_cls(),
                               device="cpu")
    kw = dict(f_in=F_IN, sizes=(24, 60, 150), seed=5)
    cases = [dict(), dict(avg_degree=3, feat_density=0.0085),
             dict(avg_degree=40, feat_density=1.0)]
    prims = set()
    for case in cases:
        for j_r, t_r in zip(j_ge.random_requests(8, **kw, **case),
                            random_requests(8, **kw, **case)):
            want = je.request_cost(j_r)
            got = te.request_cost(t_r)
            assert type(got) is float and got == want
            assert te.request_cost(t_r) == got          # the memo
            d_a = np.count_nonzero(t_r.adjacency) / t_r.adjacency.size
            d_f = np.count_nonzero(t_r.features) / t_r.features.size
            prims.add(te.executor.model.select(d_a, d_f))
    zero = GraphRequest(np.eye(5, dtype=np.float32),
                        np.zeros((5, F_IN), np.float32))
    assert te.request_cost(zero) == je.request_cost(
        j_ge.GraphRequest(zero.adjacency, zero.features)) == 0.0
    assert len(prims) >= 2
    # another engine with another model re-costs a memoized request
    other = t_ge.GraphServeEngine("gcn", f_in=F_IN, device="cpu",
                                  cost_model=t_pm.FPGACostModel(p_sys=8))
    req = random_requests(1, **kw)[0]
    first = te.request_cost(req)
    assert other.request_cost(req) != first
    assert te.request_cost(req) == first


def test_cost_calibration_matches_the_reference():
    jc, tc = j_pm.CostCalibration(alpha=0.3), t_pm.CostCalibration(alpha=0.3)
    assert tc == t_pm.CostCalibration(alpha=0.3)
    rng = np.random.default_rng(4)
    for _ in range(20):
        cost, wall = float(rng.uniform(-1.0, 100.0)), float(rng.uniform(
            -0.01, 0.2))
        jc.observe(cost, wall)
        tc.observe(cost, wall)
        assert tc.seconds_per_unit == jc.seconds_per_unit
        assert tc.seconds(cost, 0.5) == jc.seconds(cost, 0.5)


def test_serve_config_keeps_the_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(j_cfg.ServeConfig)}
    port = {f.name: f.default for f in dataclasses.fields(t_cfg.ServeConfig)}
    assert port == ref
    assert port["minibatch"] is None
    assert port["resize"] is False and port["autoscale"] is False


@pytest.mark.parametrize("bad", [
    dict(ewma_alpha=0.0), dict(ewma_alpha=1.5), dict(cold_start_wall=-1.0),
    dict(slack_margin=float("nan")), dict(batch_patience=-0.1),
    dict(max_wait=-1.0), dict(n_lanes=0), dict(shed="sometimes"),
    dict(shed="capacity"), dict(shed="capacity", max_pending=0),
    dict(admit_margin=0.5), dict(pressure_threshold=0.0),
    dict(priority_weight=0.0), dict(autoscale=True)])
def test_serve_config_validate_errors_match_the_reference(bad):
    with pytest.raises(ValueError) as want:
        j_cfg.ServeConfig(**bad).validate()
    with pytest.raises(ValueError) as got:
        t_cfg.ServeConfig(**bad).validate()
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        ContinuousGraphServer(_engine(), **bad)


def test_serve_config_merge_and_round_trip():
    eng = _engine()
    cfg = t_cfg.ServeConfig(max_wait=1.0, shed="predicted-miss")
    srv = ContinuousGraphServer(eng, config=cfg, n_lanes=2, max_wait=1.0)
    assert (srv.max_wait, srv.shed, srv.n_lanes) == (1.0, "predicted-miss",
                                                     2)
    clone = ContinuousGraphServer.from_config(eng, srv.config)
    assert clone.config == srv.config and clone.n_lanes == 2
    with pytest.raises(ValueError, match="max_wait"):
        ContinuousGraphServer(eng, config=cfg, max_wait=2.0)
    with pytest.raises(TypeError):
        ContinuousGraphServer(eng, config=t_cfg.EngineConfig(f_in=F_IN))


@pytest.mark.parametrize("n", range(8))
@pytest.mark.parametrize("force", [False, True])
def test_cut_wave_matches_the_reference(n, force):
    je = j_ge.GraphServeEngine("gcn", f_in=F_IN, slots=3)
    te = _engine(slots=3)
    entries = list(range(n))
    assert te.cut_wave(entries, force=force) == je.cut_wave(entries,
                                                            force=force)


@pytest.mark.parametrize("n_lanes", [1, 2])
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_scripted_stream_matches_the_reference(n_lanes, policy):
    """One stream through both servers, walls scripted, one fake clock
    each (jittered from equal seeds, so every clock read must line up):
    equal dispatch logs, tickets, class counters and shed logs; logits
    within 3e-4 of the reference's and bitwise the port's run_naive."""
    common = dict(f_in=F_IN, hidden=HIDDEN, n_classes=CLASSES, slots=3,
                  min_bucket=32)
    je = j_ge.GraphServeEngine("gcn", **common)
    te = t_ge.GraphServeEngine(
        "gcn", device="cpu", **common,
        weights={k: np.asarray(v) for k, v in je.weights.items()})
    kw = dict(**SERVER_KW, n_lanes=n_lanes, **POLICIES[policy])
    j_clk, t_clk = stream_clock(), stream_clock()
    script_walls(je, j_clk)
    script_walls(te, t_clk)
    j_srv = j_sch.ContinuousGraphServer(je, clock=j_clk, **kw)
    t_srv = ContinuousGraphServer(te, clock=t_clk, **kw)
    j_srv.warmup((20,))
    t_srv.warmup((20,))
    j_t, j_done = stream(j_srv, j_clk, j_ge.random_requests(
        N_STREAM, f_in=F_IN, sizes=STREAM_SIZES, seed=STREAM_SEED),
        np.random.default_rng(3))
    reqs = random_requests(N_STREAM, f_in=F_IN, sizes=STREAM_SIZES,
                           seed=STREAM_SEED)
    t_t, t_done = stream(t_srv, t_clk, reqs, np.random.default_rng(3))
    assert t_clk.t == j_clk.t

    def log(srv):
        return [(w.bucket, w.n_real, w.reason, w.cut_at, w.wall, w.lane,
                 w.classes) for w in srv.dispatch_log]

    assert log(t_srv) == log(j_srv)
    assert len(set(w.reason for w in t_srv.dispatch_log)) >= 2
    for t, j in zip(t_t, j_t):
        assert (int(t), t.verdict, t.predicted_miss, t.bucket, t.priority,
                t.tenant, t.deadline) == (int(j), j.verdict,
                                          j.predicted_miss, j.bucket,
                                          j.priority, j.tenant, j.deadline)
        assert abs(t.predicted_wall - j.predicted_wall) <= 1e-12
    assert len(t_t) == len(j_t) == N_STREAM
    assert {k: dataclasses.astuple(v) for k, v in t_srv.class_stats.items()
            } == {k: dataclasses.astuple(v)
                  for k, v in j_srv.class_stats.items()}
    assert [int(t) for t in t_srv.shed_log] == [int(t) for t in j_srv.shed_log]
    for name in ("submitted", "admitted", "dispatched", "shed_at_submit",
                 "shed_under_pressure"):
        assert getattr(t_srv, name) == getattr(j_srv, name), name
    assert abs(t_srv.peak_pressure - j_srv.peak_pressure) <= 1e-12
    assert [r.request_id for r in t_done] == [r.request_id for r in j_done]
    for t, j in zip(t_done, j_done):
        assert (t.bucket, t.deadline, t.completed_at, t.deadline_met) == (
            j.bucket, j.deadline, j.completed_at, j.deadline_met)
        np.testing.assert_allclose(t.logits, np.asarray(j.logits), **TOL)
    # conservation, and the port's own oracle
    assert len(t_done) + len(t_srv.shed_log) == t_srv.submitted
    shed = {int(t) for t in t_srv.shed_log}
    _assert_naive(te, t_done, [r for r, t in zip(reqs, t_t)
                               if int(t) not in shed])


# -- the reference's scheduler cases, inside the port -----------------------

def test_full_wave_dispatches_immediately():
    clk = FakeClock()
    eng = _engine(slots=2)
    srv = _server(eng, clk)
    reqs = _reqs(2, sizes=(24,))
    tickets = [srv.submit(r, deadline=clk.t + 1e9) for r in reqs]
    assert tickets == [0, 1] and srv.pending == 2
    out = srv.poll()
    assert srv.pending == 0
    assert [w.reason for w in srv.dispatch_log] == ["full"]
    assert srv.dispatch_log[0].n_real == 2
    _assert_naive(eng, out, reqs)


def test_short_wave_waits_until_deadline_pressure():
    clk = FakeClock()
    eng = _engine(slots=3)
    srv = _server(eng, clk)
    reqs = _reqs(2, sizes=(24,))
    for r in reqs:
        srv.submit(r, deadline=clk.t + 50.0)
    assert srv.poll() == []                    # slack huge: keep waiting
    assert srv.pending == 2
    clk.advance(50.0 - srv.estimate(32) / 2)
    out = srv.poll()
    assert len(out) == 2 and srv.pending == 0
    assert [w.reason for w in srv.dispatch_log] == ["deadline"]
    assert srv.dispatch_log[0].n_real == 2     # partial: 2 of 3 slots
    assert all(r.deadline_met for r in out)
    _assert_naive(eng, out, reqs)


def test_tight_deadline_behind_loose_one_still_cuts():
    """Deadline pressure comes from the TIGHTEST queued deadline, not the
    queue head."""
    clk = FakeClock()
    srv = _server(_engine(slots=3), clk)
    loose, tight = _reqs(2, sizes=(24,))
    srv.submit(loose, deadline=clk.t + 1e9)
    srv.submit(tight, deadline=clk.t + 1.0)
    assert srv.poll() == []
    clk.advance(1.0 - srv.estimate(32) / 2)
    out = srv.poll()
    assert len(out) == 2 and srv.pending == 0
    assert [w.reason for w in srv.dispatch_log] == ["deadline"]
    by_id = {r.request_id: r for r in out}
    assert by_id[tight.request_id].deadline_met


def test_deadlineless_requests_age_out():
    clk = FakeClock()
    srv = _server(_engine(slots=3), clk, max_wait=5.0)
    srv.submit(_reqs(1, sizes=(24,))[0])       # deadline=None
    assert srv.poll() == []
    clk.advance(4.9)
    assert srv.poll() == []
    clk.advance(0.2)
    out = srv.poll()
    assert len(out) == 1 and srv.pending == 0
    assert [w.reason for w in srv.dispatch_log] == ["age"]
    assert out[0].deadline is None and out[0].deadline_met is None


def test_batch_patience_cuts_idle_partial_waves():
    clk = FakeClock()
    srv = _server(_engine(slots=3), clk, batch_patience=2.0,
                  cold_start_wall=0.01)
    srv.submit(_reqs(1, sizes=(24,))[0], deadline=clk.t + 1e9)
    assert srv.poll() == []
    clk.advance(0.019)                     # < 2.0 * 0.01: keep batching
    assert srv.poll() == []
    clk.advance(0.002)                     # past patience -> cut
    out = srv.poll()
    assert len(out) == 1
    assert [w.reason for w in srv.dispatch_log] == ["age"]


def test_every_submission_eventually_dispatched():
    clk = FakeClock()
    eng = _engine(slots=3)
    srv = _server(eng, clk, max_wait=1.0)
    reqs = _reqs(8, seed=5)                    # two buckets, odd remainders
    done = []
    for i, r in enumerate(reqs):
        srv.submit(r, deadline=clk.t + 1e6 if i % 2 else None)
        done += srv.poll()
    for _ in range(10):
        clk.advance(0.6)
        done += srv.poll()
        if srv.pending == 0:
            break
    assert srv.pending == 0
    assert srv.dispatched == len(reqs)
    _assert_naive(eng, done, reqs)


def test_lpt_cross_bucket_ordering():
    """Waves cut in one tick dispatch longest estimate first, urgent cuts
    ahead."""
    clk = FakeClock()
    srv = _server(_engine(slots=2), clk)
    srv._ewma_for(32).value = 0.010
    srv._ewma_for(64).value = 0.030
    small = random_requests(2, f_in=F_IN, sizes=(24,), seed=2)
    big = random_requests(2, f_in=F_IN, sizes=(60,), seed=3)
    for r in small + big:                      # small submitted FIRST
        srv.submit(r, deadline=clk.t + 1e9)
    srv.poll()
    assert [w.bucket for w in srv.dispatch_log] == [64, 32]
    assert [w.reason for w in srv.dispatch_log] == ["full", "full"]
    srv2 = _server(_engine(slots=2), clk)
    srv2._ewma_for(32).value = 0.010
    srv2._ewma_for(64).value = 0.030
    srv2.submit(random_requests(1, f_in=F_IN, sizes=(24,), seed=4)[0],
                deadline=clk.t + 0.001)        # already inside slack
    for r in random_requests(2, f_in=F_IN, sizes=(60,), seed=5):
        srv2.submit(r, deadline=clk.t + 1e9)
    srv2.poll()
    assert [(w.bucket, w.reason) for w in srv2.dispatch_log] == [
        (32, "deadline"), (64, "full")]


def test_slot_level_streaming():
    clk = FakeClock()
    srv = _server(_engine(slots=2), clk)
    full = random_requests(2, f_in=F_IN, sizes=(24,), seed=6)
    short = random_requests(1, f_in=F_IN, sizes=(60,), seed=7)
    ids = [srv.submit(r, deadline=clk.t + 1e9) for r in full + short]
    out = srv.poll()
    assert sorted(r.request_id for r in out) == sorted(
        r.request_id for r in full)
    assert srv.pending == 1                    # the short wave still queued
    assert all(r.completed_at is not None for r in out)
    tail = srv.drain()
    assert [r.request_id for r in tail] == [short[0].request_id]
    assert srv.dispatch_log[-1].reason == "drain"
    assert len(ids) == len(out) + len(tail)


def test_drain_flushes_everything():
    clk = FakeClock()
    eng = _engine(slots=3)
    srv = _server(eng, clk)
    reqs = _reqs(7, seed=8)                    # partial waves in 2 buckets
    for r in reqs:
        srv.submit(r)
    out = srv.drain()
    assert srv.pending == 0 and srv.drain() == []
    for log in srv.dispatch_log:
        assert log.reason in ("full", "drain")
    _assert_naive(eng, out, reqs)


def test_ewma_estimator_cold_start_and_update():
    clk = FakeClock()
    eng = _engine()
    srv = _server(eng, clk, cold_start_wall=0.123, ewma_alpha=0.5)
    assert srv.estimate(32) == pytest.approx(0.123)
    # engine walls seed a FRESH server's estimate (min, per bucket)
    eng.bucket_walls[64] = [0.4, 0.01, 0.02]
    srv2 = _server(eng, clk, cold_start_wall=0.123)
    assert srv2.estimate(64) == pytest.approx(0.01)
    # a never-run bucket does not inherit a smaller bucket's wall
    eng.wave_walls = [0.001]
    srv3 = _server(eng, clk, cold_start_wall=0.123)
    assert srv3.estimate(128) == pytest.approx(0.123)
    srv._ewma_for(32).observe(0.2)
    assert srv.estimate(32) == pytest.approx(0.5 * 0.123 + 0.5 * 0.2)


def test_warmup_builds_bucket_plans_before_traffic():
    clk = FakeClock()
    eng = _engine(slots=2)
    srv = _server(eng, clk)
    srv.warmup((24, 60))
    assert eng.buckets == [32, 64]
    plans0 = eng.executor.trace_count
    assert plans0 == 2
    assert {b: len(w) for b, w in eng.bucket_walls.items()} == {32: 2, 64: 2}
    srv.warmup((24,))                          # warm buckets stay as they are
    assert len(eng.bucket_walls[32]) == 2
    reqs = _reqs(4, seed=9)
    for r in reqs:
        srv.submit(r, deadline=clk.t + 1e9)
    done = srv.poll() + srv.drain()
    assert eng.executor.trace_count == plans0     # no new walk plans
    _assert_naive(eng, done, reqs)


def test_submit_validates_at_the_edge():
    srv = _server(_engine(), FakeClock())
    bad = GraphRequest(np.full((4, 4), np.nan, np.float32),
                       np.ones((4, F_IN), np.float32))
    with pytest.raises(ValueError, match="non-finite"):
        srv.submit(bad)
    with pytest.raises(ValueError, match="feature width"):
        srv.submit(GraphRequest(np.eye(4, dtype=np.float32),
                                np.ones((4, F_IN + 1), np.float32)))
    assert srv.pending == 0 and srv.submitted == 0


@pytest.mark.parametrize("flush", ["poll", "drain"])
@pytest.mark.parametrize("n_lanes", [1, 2])
def test_undelivered_results_survive_mid_dispatch_failure(flush, n_lanes):
    """Results harvested before a failed dispatch are not lost: the next
    poll()/drain() delivers them exactly once, in order.  With two lanes
    the first wave is still in flight when the second begin_wave raises,
    and is harvested on the way out."""
    clk = FakeClock()
    eng = _engine(slots=2)
    srv = _server(eng, clk, n_lanes=n_lanes)
    reqs = _reqs(4, sizes=(24,))
    for r in reqs:
        srv.submit(r, deadline=clk.t + 1e9)     # two full waves queued
    real_begin = eng.begin_wave
    calls = {"n": 0}

    def flaky(bucket, wave):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected dispatch failure")
        return real_begin(bucket, wave)

    eng.begin_wave = flaky
    with pytest.raises(RuntimeError, match="injected"):
        srv.poll()
    eng.begin_wave = real_begin
    assert len(srv._undelivered) == 2
    out = srv.drain() if flush == "drain" else srv.poll()
    assert [r.request_id for r in out[:2]] == [reqs[0].request_id,
                                               reqs[1].request_id]
    assert srv._undelivered == []
    assert srv.poll() == [] and srv.drain() == []
    _assert_naive(eng, out, reqs[:2])


def test_two_lanes_keep_two_waves_in_flight():
    """n_lanes=2: up to two waves in flight (pipeline_depth), pulled by
    alternating lanes, results bitwise run_naive's; n_lanes=3 still keeps
    two."""
    for n_lanes, depth in ((2, 2), (3, 2)):
        clk = FakeClock()
        eng = _engine(slots=2)
        srv = _server(eng, clk, n_lanes=n_lanes)
        assert srv.pipeline_depth == depth
        begin, finish = eng.begin_wave, eng.finish_wave
        live, peak = [0], [0]

        def begin_wave(bucket, wave):
            live[0] += 1
            peak[0] = max(peak[0], live[0])
            return begin(bucket, wave)

        def finish_wave(inflight):
            live[0] -= 1
            return finish(inflight)

        eng.begin_wave, eng.finish_wave = begin_wave, finish_wave
        reqs = _reqs(8, seed=15, sizes=(24, 60))
        for r in reqs:
            srv.submit(r, deadline=clk.t + 1e9)
        done = srv.poll() + srv.drain()
        assert peak[0] == depth and live[0] == 0
        assert len({w.lane for w in srv.dispatch_log}) == min(
            n_lanes, len(srv.dispatch_log))
        assert all(srv.lane_estimate(w.lane) != 0.01
                   for w in srv.dispatch_log)
        _assert_naive(eng, done, reqs)


@pytest.mark.parametrize("seed", range(4))
def test_continuous_parity_fuzz(seed):
    """Random arrival order, deadlines (some None), clock jitter,
    interleaved submit/poll: results bitwise run_naive's, walk plans at
    most one per bucket."""
    rng = np.random.default_rng(200 + seed)
    clk = FakeClock(jitter_rng=rng, jitter=0.005)
    eng = _engine(slots=int(rng.integers(2, 5)))
    srv = ContinuousGraphServer(eng, clock=clk, cold_start_wall=0.01,
                                max_wait=float(rng.uniform(0.01, 0.5)))
    reqs = _reqs(int(rng.integers(5, 10)), seed=300 + seed,
                 sizes=(20, 40, 60))
    order = rng.permutation(len(reqs))
    done = []
    for i in order:
        deadline = (None if rng.random() < 0.3
                    else clk.t + float(rng.uniform(0.0, 2.0)))
        srv.submit(reqs[i], deadline=deadline)
        if rng.random() < 0.5:
            clk.advance(float(rng.uniform(0.0, 0.3)))
            done += srv.poll()
    done += srv.drain()
    assert srv.pending == 0
    _assert_naive(eng, done, reqs)
    assert eng.executor.trace_count <= len(eng.buckets)


# -- overload control --------------------------------------------------------

def test_ticket_is_int_compatible():
    t = Ticket(3, bucket=32, predicted_wall=0.02, verdict="admit-at-risk",
               predicted_miss=False, priority=2, tenant="gold")
    assert t == 3 and int(t) == 3 and t.seq == 3
    assert {t: "x"}[3] == "x" and f"{t}" == "3"
    assert t + 1 == 4
    assert t.admitted and t.verdict == "admit-at-risk"
    assert Ticket(9, verdict="shed").admitted is False
    assert repr(t).startswith("Ticket(3, bucket=32, verdict='admit-at-risk'")


def test_submit_tickets_are_sequential_ints():
    srv = _server(_engine(slots=2), FakeClock())
    tickets = [srv.submit(r) for r in _reqs(2, sizes=(24,))]
    assert tickets == [0, 1]
    assert all(isinstance(t, Ticket) for t in tickets)
    assert all(t.verdict == "admit" for t in tickets)   # no deadline


def test_admission_verdict_bands():
    clk = FakeClock()
    srv = _server(_engine(slots=4), clk)   # cold: bound == cold_start_wall
    r = _reqs(3, sizes=(24,))
    assert srv.admission_estimate(32) == pytest.approx(0.01)
    t = srv.submit(r[0], deadline=clk.t + 100.0)
    assert (t.verdict, t.predicted_miss) == ("admit", False)
    t = srv.submit(r[1], deadline=clk.t + 1.2 * t.predicted_wall)
    assert (t.verdict, t.predicted_miss) == ("admit-at-risk", False)
    t = srv.submit(r[2], deadline=clk.t + 1e-6)
    assert (t.verdict, t.predicted_miss) == ("admit-at-risk", True)
    assert srv.pending == 3 and srv.admitted == 3 and srv.shed_at_submit == 0


def test_predicted_miss_shedding_rejects_at_the_door():
    clk = FakeClock()
    eng = _engine(slots=4)
    srv = _server(eng, clk, shed="predicted-miss")
    keep, drop = _reqs(2, sizes=(24,))
    t_keep = srv.submit(keep, deadline=clk.t + 100.0)
    t_drop = srv.submit(drop, deadline=clk.t + 1e-6)
    assert t_keep.admitted and not t_drop.admitted
    assert t_drop.verdict == "shed" and t_drop.predicted_miss
    assert srv.pending == 1 and srv.shed_at_submit == 1
    assert srv.shed_log == [t_drop]
    out = srv.drain()
    assert [r.request_id for r in out] == [keep.request_id]
    _assert_naive(eng, out, [keep])
    assert srv.submit(_reqs(1, seed=9)[0]).verdict == "admit"


def test_capacity_shedding_bounds_the_queue():
    srv = _server(_engine(slots=4), FakeClock(), shed="capacity",
                  max_pending=2)
    verdicts = [srv.submit(r).verdict for r in _reqs(4, sizes=(24,))]
    assert verdicts == ["admit", "admit", "shed", "shed"]
    assert srv.pending == 2 and srv.shed_at_submit == 2


def test_class_counters_conserve_requests():
    clk = FakeClock()
    srv = _server(_engine(slots=2), clk, shed="predicted-miss")
    reqs = _reqs(5, sizes=(24,))
    srv.submit(reqs[0], priority=1, tenant="gold")
    srv.submit(reqs[1], priority=1, tenant="gold")
    srv.submit(reqs[2], deadline=clk.t + 1e-6, tenant="free")   # shed
    t3 = srv.submit(reqs[3], deadline=clk.t + 100.0, tenant="free")
    srv.poll()                              # gold full wave dispatches
    clk.advance(200.0)
    srv.submit(reqs[4], tenant="free")      # already past reqs[3] deadline
    srv.drain()
    gold = srv.class_stats[("gold", 1)]
    free = srv.class_stats[("free", 0)]
    assert (gold.admitted, gold.shed, gold.met, gold.missed) == (2, 0, 2, 0)
    # reqs[3] was admitted, but its deadline passed while queued: doomed
    # work is shed at cut time instead of delivered late
    assert free.admitted == 2 and free.shed == 2
    assert t3 in srv.shed_log
    assert (free.missed, free.met) == (0, 1)
    delivered = sum(s.delivered for s in srv.class_stats.values())
    assert delivered == srv.dispatched == 3
    assert delivered + len(srv.shed_log) == srv.submitted == 5
    assert ClassStats(met=2, missed=1).delivered == 3


def test_shed_never_delivers_late_instead_of_dropping():
    clk = FakeClock()
    srv = _server(_engine(slots=2), clk)    # default shed="never"
    req = _reqs(1, sizes=(24,))[0]
    srv.submit(req, deadline=clk.t + 1e-6)
    clk.advance(100.0)
    out = srv.drain()
    assert [r.request_id for r in out] == [req.request_id]
    assert out[0].deadline_met is False
    stats = srv.class_stats[("default", 0)]
    assert (stats.missed, stats.met) == (1, 0)
    assert srv.shed_log == []


def test_full_wave_composes_highest_class_first():
    srv = _server(_engine(slots=2), FakeClock())
    a, b, c = _reqs(3, sizes=(24,))
    srv.submit(a, priority=0)
    srv.submit(b, priority=0)
    srv.submit(c, priority=5)
    out = srv.poll()                        # one full wave of 2
    assert sorted(r.request_id for r in out) == sorted(
        [a.request_id, c.request_id])       # c jumps b, FIFO within class
    assert srv.dispatch_log[0].classes == {5: 1, 0: 1}
    assert srv.pending == 1


def test_aged_low_priority_entry_jumps_the_wave():
    clk = FakeClock()
    srv = _server(_engine(slots=2), clk, max_wait=1.0)
    old = _reqs(1, sizes=(24,))[0]
    srv.submit(old, priority=0)
    clk.advance(2.0)                        # past max_wait
    hi1, hi2 = _reqs(2, seed=5, sizes=(24,))
    srv.submit(hi1, priority=9)
    srv.submit(hi2, priority=9)
    out = srv.poll()
    assert srv.dispatch_log[0].classes == {0: 1, 9: 1}
    served = {r.request_id for r in out}
    assert old.request_id in served and hi1.request_id in served


def test_pressure_sheds_lowest_class_at_risk_first():
    clk = FakeClock()
    eng = _engine(slots=8)
    srv = _server(eng, clk, pressure_threshold=0.005)
    safe, risky_hi, risky_lo = _reqs(3, sizes=(24,))
    srv.submit(safe, deadline=clk.t + 100.0)
    t_hi = srv.submit(risky_hi, deadline=clk.t + 1e-6, priority=3)
    t_lo = srv.submit(risky_lo, deadline=clk.t + 1e-6, priority=0)
    assert srv.pending == 3
    assert srv.backlog_bound() > srv.pressure_threshold
    assert srv.pressure == srv.backlog_bound()
    srv.poll()
    assert srv.shed_log == [t_lo, t_hi]
    assert srv.shed_under_pressure == 2 and srv.pending == 1
    assert srv.class_stats[("default", 0)].shed == 1
    assert srv.class_stats[("default", 3)].shed == 1
    assert srv.peak_pressure > 0.005
    out = srv.drain()
    assert [r.request_id for r in out] == [safe.request_id]
    _assert_naive(eng, out, [safe])


def test_deadline_less_requests_never_pressure_shed():
    srv = _server(_engine(slots=8), FakeClock(), pressure_threshold=1e-9)
    for r in _reqs(3, sizes=(24,)):
        srv.submit(r)                       # best-effort: no deadlines
    srv.poll()
    assert srv.shed_under_pressure == 0 and srv.pending == 3


def test_cost_calibration_converges_and_floors():
    calib = t_pm.CostCalibration(alpha=0.5)
    assert calib.seconds(100.0, fallback=0.25) == 0.25   # cold: fallback
    calib.observe(100.0, 1.0)               # 0.01 s per unit
    assert calib.seconds(50.0) == pytest.approx(0.5)
    calib.observe(100.0, 3.0)               # EWMA folds toward 0.03
    assert calib.seconds(100.0) == pytest.approx(2.0)
    calib.observe(0.0, 1.0)                 # degenerate samples ignored
    calib.observe(10.0, 0.0)
    assert calib.seconds(100.0) == pytest.approx(2.0)


def test_calibration_feeds_admission_estimate():
    srv = _server(_engine(slots=2), FakeClock())
    for r in _reqs(2, sizes=(24,)):
        srv.submit(r)
    srv.poll()                              # one dispatched wave calibrates
    assert srv._calib.seconds_per_unit is not None
    cheap = srv.admission_estimate(32, cost=0.0)
    dear = srv.admission_estimate(32, cost=1e9)
    assert dear > cheap
    assert math.isclose(dear, srv._calib.seconds(1e9))


def test_fuzzed_priorities_keep_oracle_parity():
    rng = np.random.default_rng(11)
    clk = FakeClock(jitter_rng=rng, jitter=0.0005)
    eng = _engine(slots=3)
    srv = _server(eng, clk)
    reqs = _reqs(12, seed=3, sizes=(24, 60))
    out = []
    for r in reqs:
        dl = (None if rng.random() < 0.3
              else clk.t + float(rng.uniform(0.005, 5.0)))
        t = srv.submit(r, deadline=dl, priority=int(rng.integers(0, 4)),
                       tenant=str(rng.integers(0, 3)))
        assert t.admitted                   # shed="never" admits everything
        if rng.random() < 0.5:
            out += srv.poll()
        clk.advance(float(rng.uniform(0.0, 0.02)))
    out += srv.drain()
    _assert_naive(eng, out, reqs)
    assert sum(s.delivered for s in srv.class_stats.values()) == len(reqs)
