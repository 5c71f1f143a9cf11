"""GNN serving entry point: a stream of graph queries, one engine.

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn [--model gat] \\
      [--n 12] [--slots 4] [--f-in 64] [--device cpu] [--smoke]

Port of ``examples/serve_gnn.py``, in four acts:

1. batch: a :class:`~repro_torch.serving.graph_engine.GraphServeEngine`
   (one weight set, one compiled model and one walk plan per shape
   bucket) serves a mixed-size synthetic stream (sizes 56/100/150, seed
   0); it prints each request's bucket and wave, the trace and cache
   counters, the dummy-slot fill, the steady-state wall against the naive
   per-request loop, and the bitwise parity with it;
2. continuous: the same stream replayed through a
   :class:`~repro_torch.serving.scheduler.ContinuousGraphServer` with
   Poisson arrivals at twice the measured batch rate and a deadline of
   twice the batch wall, printing each wave's cut reason and the deadline
   hit-rate;
3. overload: arrivals at 8x that rate under ``shed="predicted-miss"``
   (every third request a priority-1 "gold" tenant), printing the
   per-class counters and the sheds;
4. giant graph: mini-batch queries over one power-law host graph through
   a :class:`~repro_torch.serving.minibatch.MiniBatchServeEngine`, one
   streaming edge delta at vertex 7 (the profile patched, the replanned
   cells and cache evictions counted) and the post-delta oracle.

Runs on the GPU unless ``--device cpu``; ``--smoke`` serves a small
stream and exits nonzero unless every act's results are bitwise those of
its oracle (``run_naive``, or the per-seed ``oracle_queries``).
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.data.sampling import powerlaw_host_graph
from repro_torch.models.gnn import GNN_MODELS
from repro_torch.serving.graph_engine import GraphServeEngine, random_requests
from repro_torch.serving.minibatch import FeatureStore, MiniBatchServeEngine
from repro_torch.serving.scheduler import ContinuousGraphServer


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="gcn", choices=GNN_MODELS)
    ap.add_argument("--n", type=int, default=12, help="requests")
    ap.add_argument("--slots", type=int, default=4, help="wave width")
    ap.add_argument("--f-in", type=int, default=64, help="feature width")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--smoke", action="store_true",
                    help="small stream; exit nonzero unless every act "
                         "(batch, continuous, overload, mini-batch) is "
                         "bitwise its oracle")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.slots = 6, 2
    parity = {}

    eng = GraphServeEngine(args.model, f_in=args.f_in, hidden=16,
                           n_classes=7, slots=args.slots, device=args.device)
    reqs = random_requests(args.n, f_in=args.f_in, sizes=(56, 100, 150),
                           seed=0)
    print(f"== serving {args.n} {args.model.upper()} queries "
          f"(slots={args.slots}) on {eng.device} ==")

    eng.serve(reqs)                       # warm: one walk plan per bucket
    _sync(eng.device)
    t0 = time.perf_counter()
    results = eng.serve(reqs)             # steady state: cache hits only
    wall = time.perf_counter() - t0

    for r, q in zip(results, reqs):
        print(f"  req {r.request_id:2d}: |V|={q.n_vertices:4d} -> "
              f"bucket {r.bucket:4d}, wave {r.wave:2d}, "
              f"logits {r.logits.shape}")
    slots_run = eng.waves * eng.slots
    print(f"buckets={eng.buckets} waves={eng.waves} "
          f"traces={eng.executor.trace_count} "
          f"program-cache hit/miss="
          f"{eng.executor.cache_hits}/{eng.executor.cache_misses} "
          f"dummy-slot fill={1 - eng.served / slots_run:.0%}")
    print(f"steady-state: {wall * 1e3:.1f}ms total, "
          f"{args.n / wall:.1f} req/s, "
          f"wave walls p50={np.median(eng.wave_walls) * 1e3:.2f}ms "
          f"on {eng.device}")

    eng.run_naive(reqs)                   # warm the per-kernel engine
    _sync(eng.device)
    t0 = time.perf_counter()
    naive = eng.run_naive(reqs)
    naive_wall = time.perf_counter() - t0
    ok = parity["batched"] = all(np.array_equal(a.logits, b.logits)
                                 for a, b in zip(results, naive))
    print(f"naive per-request loop: {naive_wall * 1e3:.1f}ms "
          f"({args.n / naive_wall:.1f} req/s) -> "
          f"batched speedup {naive_wall / wall:.2f}x, bitwise==naive: {ok}")
    naive_by_id = {r.request_id: r for r in naive}
    capacity = args.n / wall              # measured batch service rate
    budget = 2.0 * wall                   # per-request deadline budget
    rng = np.random.default_rng(1)

    # -- continuous replay: the same stream, arriving over time ------------
    print("== continuous serving (Poisson arrivals, deadlines) ==")
    srv = ContinuousGraphServer(eng)      # engine already warm
    arrivals = np.cumsum(rng.exponential(1.0 / (2.0 * capacity), args.n))
    done, _, t0 = _replay(srv, reqs, arrivals, budget)
    span = max(r.completed_at for r in done) - t0
    hits = sum(bool(r.deadline_met) for r in done)
    for w in srv.dispatch_log:
        print(f"  wave: bucket {w.bucket:4d}, {w.n_real} real slot(s), "
              f"cut by {w.reason:8s}, wall {w.wall * 1e3:.2f}ms")
    ok = parity["continuous"] = len(done) == args.n and all(
        np.array_equal(r.logits, naive_by_id[r.request_id].logits)
        for r in done)
    print(f"continuous: {span * 1e3:.1f}ms stream span "
          f"({args.n / span:.1f} req/s), deadline hit-rate "
          f"{hits}/{args.n}, bitwise==naive: {ok}")

    # -- overload replay: 4x the arrival rate, admission control on --------
    print("== overload (4x arrivals, shed=\"predicted-miss\") ==")
    srv = ContinuousGraphServer(eng, shed="predicted-miss",
                                pressure_threshold=budget)
    arrivals = np.cumsum(rng.exponential(1.0 / (8.0 * capacity), args.n))
    done, tickets, _ = _replay(srv, reqs, arrivals, budget, classes=True)
    hits = sum(bool(r.deadline_met) for r in done)
    ok = parity["overload"] = (
        len(done) + len(srv.shed_log) == args.n and all(
            np.array_equal(r.logits, naive_by_id[r.request_id].logits)
            for r in done))
    for (tenant, prio), s in sorted(srv.class_stats.items()):
        print(f"  class {tenant}/p{prio}: admitted {s.admitted}, "
              f"shed {s.shed}, met {s.met}, missed {s.missed}")
    shed = [t for t in tickets if not t.admitted]
    print(f"overload: {len(done)} delivered ({hits} on deadline), "
          f"{len(srv.shed_log)} shed ({len(shed)} at the door), "
          f"peak pressure {srv.peak_pressure * 1e3:.1f}ms, "
          f"bitwise==naive: {ok}")

    # -- giant graph: mini-batch serving + a streaming edge delta ----------
    print("== giant graph: mini-batch + streaming delta ==")
    n_giant = 1000 if args.smoke else 5000
    host = powerlaw_host_graph(n_giant, avg_degree=6, seed=0)
    store = FeatureStore(np.random.default_rng(2).standard_normal(
        (n_giant, args.f_in)).astype(np.float32))
    mb = MiniBatchServeEngine(eng, host, store, fanouts=(4, 3))
    queries = [[7, 3], [3, 11, 7]]
    got = mb.serve_queries(queries)
    want = mb.oracle_queries(queries)
    cold = all(np.array_equal(t.result(), w) for t, w in zip(got, want))
    # an edge delta at vertex 7: the block profile is patched in place,
    # only boundary-crossing cells replan, and exactly the dependent cache
    # entries are evicted
    absent = next(u for u in range(n_giant)
                  if u != 7 and u not in set(host.neighbors(7)))
    rep = mb.apply_delta([(7, absent)], [])
    print(f"  delta: +1 edge -> graph v{rep.graph_version}, "
          f"{rep.touched_cells}/{rep.total_cells} profile cells touched, "
          f"{rep.replan_cells} crossed a primitive boundary, "
          f"{rep.cache_invalidated} cache entries evicted")
    post = mb.serve_queries([[7]])[0].result()
    ok = parity["minibatch"] = bool(
        cold and np.array_equal(post, mb.oracle_queries([[7]])[0]))
    stats = mb.cache.stats
    print(f"  served a {mb.planner.graph.n_edges}-edge graph: cache "
          f"hits={stats.hits} misses={stats.misses} "
          f"invalidations={stats.invalidations}, post-delta bitwise==oracle:"
          f" {ok}")

    bad = sorted(k for k, v in parity.items() if not v)
    if args.smoke:
        if bad:
            print(f"smoke parity failed: {bad}")
            return 1
        print(f"smoke OK: {sorted(parity)} all bitwise")
    return 0


def _replay(srv, reqs, arrivals, budget, *, classes=False):
    """Submit each request once the host clock passes its arrival
    (deadline = arrival + ``budget``; with ``classes`` every third request
    is the priority-1 "gold" tenant), polling in between, then drain.
    Returns (results, tickets, start time)."""
    t0 = time.monotonic()
    done, tickets, i, n = [], [], 0, len(reqs)
    while i < n:
        now = time.monotonic()
        while i < n and t0 + arrivals[i] <= now:
            gold = classes and i % 3 == 0
            kw = (dict(priority=1 if gold else 0,
                       tenant="gold" if gold else "std") if classes else {})
            tickets.append(srv.submit(
                reqs[i], deadline=t0 + float(arrivals[i]) + budget, **kw))
            i += 1
        got = srv.poll()
        done += got
        if not got:
            time.sleep(1e-3)              # nothing cuttable: do not spin
    done += srv.drain()
    return done, tickets, t0


if __name__ == "__main__":
    raise SystemExit(main())
