"""Batched GNN serving entry point: a stream of graph queries, one engine.

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn [--model gat] \\
      [--n 12] [--slots 4] [--f-in 64] [--device cpu] [--smoke]

Port of the batch half of ``examples/serve_gnn.py``: builds a
:class:`~repro_torch.serving.graph_engine.GraphServeEngine` (one weight
set, one compiled model and one walk plan per shape bucket), serves a
mixed-size synthetic stream (sizes 56/100/150, seed 0) and prints the
admission picture: each request's bucket and wave, the trace and cache
counters, the dummy-slot fill, the steady-state wall against the naive
per-request loop, and the bitwise parity with it.  Runs on the GPU unless
``--device cpu``; ``--smoke`` serves a small stream and exits nonzero
unless parity holds.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.models.gnn import GNN_MODELS
from repro_torch.serving.graph_engine import GraphServeEngine, random_requests


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
                    help="small stream; exit nonzero unless serve == the "
                         "naive per-request loop bitwise")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.slots = 6, 2

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
    ok = all(np.array_equal(a.logits, b.logits)
             for a, b in zip(results, naive))
    print(f"naive per-request loop: {naive_wall * 1e3:.1f}ms "
          f"({args.n / naive_wall:.1f} req/s) -> "
          f"batched speedup {naive_wall / wall:.2f}x, bitwise==naive: {ok}")
    return 0 if ok or not args.smoke else 1


if __name__ == "__main__":
    raise SystemExit(main())
