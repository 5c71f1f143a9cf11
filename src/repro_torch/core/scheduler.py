"""Task scheduling (paper Section VI-C, Algorithm 8) + straggler mitigation.

The paper's Scheduler keeps all Computation Cores busy via an interrupt-driven
work queue: whenever a core idles it receives the next task.  Because tasks
have *data-dependent* cost (their partitions have different densities), a
static contiguous split is load-imbalanced; the dynamic queue is the fix.

Here the "cores" are TPU chips (or threads of the host-runtime engine).  We
provide:

* ``schedule_dynamic``  -- Algorithm 8 (greedy earliest-idle-core queue).
* ``schedule_static``   -- contiguous split baseline (what S1/S2-style
  accelerators do), for the load-balance comparison benchmarks.
* ``schedule_lpt``      -- Longest-Processing-Time bins: a beyond-paper
  improvement when all costs are known up front (the Analyzer predicts them),
  strictly dominating the on-line greedy queue.  Accepts an optional
  per-core ``capacity`` (max tasks per bin) for fixed-slot consumers.
* ``schedule_weighted`` -- class-weighted LPT: tasks ordered by
  ``weight * cost`` (weighted-fair dispatch for the overload-aware serving
  scheduler, DESIGN.md section 15); all-equal weights reproduce
  ``schedule_lpt`` exactly.
* ``assign_bins``       -- the bin-ASSIGNMENT view of ``schedule_lpt``: a
  per-task core index array, the request->device map the sharded serving
  path consumes (each mesh device is a Computation Core, each wave slot a
  task; DESIGN.md section 12).
* ``steal_rebalance``   -- work stealing pass: straggler mitigation for the
  host-runtime engine (cores whose bin exceeds the mean by `threshold` donate
  their cheapest tasks to the most idle core).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Schedule:
    assignment: List[List[int]]      # per-core task indices, execution order
    core_time: np.ndarray            # (n_cores,) predicted busy seconds
    makespan: float
    policy: str

    @property
    def utilization(self) -> float:
        total = float(self.core_time.sum())
        peak = float(self.core_time.max()) * len(self.core_time)
        return total / peak if peak else 1.0


def schedule_dynamic(costs: Sequence[float], n_cores: int) -> Schedule:
    """Algorithm 8: tasks issue in order; an idle core takes the next task."""
    heap: List[Tuple[float, int]] = [(0.0, c) for c in range(n_cores)]
    heapq.heapify(heap)
    assignment: List[List[int]] = [[] for _ in range(n_cores)]
    for t, cost in enumerate(costs):
        avail, core = heapq.heappop(heap)
        assignment[core].append(t)
        heapq.heappush(heap, (avail + float(cost), core))
    core_time = np.zeros(n_cores)
    for c, tasks in enumerate(assignment):
        core_time[c] = float(np.sum([costs[t] for t in tasks]))
    return Schedule(assignment, core_time, float(core_time.max(initial=0.0)),
                    "dynamic")


def schedule_static(costs: Sequence[float], n_cores: int) -> Schedule:
    """Contiguous equal-count split (ignores per-task cost)."""
    n = len(costs)
    bounds = np.linspace(0, n, n_cores + 1).astype(int)
    assignment = [list(range(bounds[c], bounds[c + 1])) for c in range(n_cores)]
    core_time = np.array([float(np.sum([costs[t] for t in a])) for a in assignment])
    return Schedule(assignment, core_time, float(core_time.max(initial=0.0)),
                    "static")


def schedule_lpt(costs: Sequence[float], n_cores: int,
                 capacity: Optional[int] = None) -> Schedule:
    """Longest-Processing-Time-first bin packing (4/3-approx of optimum).

    ``capacity`` caps the number of tasks per core: a full core drops out
    of the idle heap, so the pack stays feasible for fixed-slot consumers
    (a mesh device serving ``slots // n_devices`` wave slots).  Requires
    ``n_cores * capacity >= len(costs)`` when set.
    """
    if capacity is not None and n_cores * capacity < len(costs):
        raise ValueError(
            f"{len(costs)} tasks exceed {n_cores} cores x {capacity} slots")
    order = np.argsort(-np.asarray(costs, dtype=float), kind="stable")
    heap: List[Tuple[float, int]] = [(0.0, c) for c in range(n_cores)]
    heapq.heapify(heap)
    assignment: List[List[int]] = [[] for _ in range(n_cores)]
    for t in order:
        avail, core = heapq.heappop(heap)
        assignment[core].append(int(t))
        if capacity is None or len(assignment[core]) < capacity:
            heapq.heappush(heap, (avail + float(costs[t]), core))
    core_time = np.array([float(np.sum([costs[t] for t in a])) for a in assignment])
    return Schedule(assignment, core_time, float(core_time.max(initial=0.0)), "lpt")


def schedule_weighted(costs: Sequence[float], weights: Sequence[float],
                      n_cores: int,
                      capacity: Optional[int] = None) -> Schedule:
    """Class-weighted LPT: order tasks by descending ``weight * cost``.

    The weighted-fair extension of :func:`schedule_lpt` the overload-aware
    serving scheduler dispatches cut waves through (DESIGN.md section 15):
    a wave's class weight scales its predicted cost in the launch-order
    sort, so a high-priority wave launches ahead of an equal-cost
    best-effort one while a sufficiently long low-priority wave still
    launches early (weighted fairness, not strict priority).  With all
    weights equal the order -- and hence the whole schedule -- is exactly
    ``schedule_lpt``'s (both sorts are stable on the same key ordering),
    so admitting priorities never perturbs the existing single-class
    behavior.  ``core_time``/``makespan`` stay in UNWEIGHTED cost units:
    weights shape the order, not the predicted walls.
    """
    costs = np.asarray(costs, dtype=float)
    weights = np.asarray(weights, dtype=float)
    if weights.shape != costs.shape:
        raise ValueError(
            f"{len(weights)} weights for {len(costs)} tasks")
    if len(weights) and weights.min() <= 0.0:
        raise ValueError(f"non-positive class weight in {weights}")
    if capacity is not None and n_cores * capacity < len(costs):
        raise ValueError(
            f"{len(costs)} tasks exceed {n_cores} cores x {capacity} slots")
    order = np.argsort(-(weights * costs), kind="stable")
    heap: List[Tuple[float, int]] = [(0.0, c) for c in range(n_cores)]
    heapq.heapify(heap)
    assignment: List[List[int]] = [[] for _ in range(n_cores)]
    for t in order:
        avail, core = heapq.heappop(heap)
        assignment[core].append(int(t))
        if capacity is None or len(assignment[core]) < capacity:
            heapq.heappush(heap, (avail + float(costs[t]), core))
    core_time = np.array([float(np.sum([costs[t] for t in a]))
                          for a in assignment])
    return Schedule(assignment, core_time,
                    float(core_time.max(initial=0.0)), "wlpt")


def assign_bins(costs: Sequence[float], n_bins: int,
                capacity: Optional[int] = None) -> np.ndarray:
    """Cost-aware task->bin map: ``(len(costs),)`` int array of bin ids.

    The assignment view of :func:`schedule_lpt` -- the serving path's
    request->device binning (Algorithm 8's cost-aware task->Computation
    Core assignment with chips as cores): balanced makespan over the
    Analyzer-predicted per-request costs instead of a mere dispatch
    order, with ``capacity`` matching each device's fixed slot count.
    """
    sched = schedule_lpt(costs, n_bins, capacity)
    bins = np.zeros(len(costs), dtype=np.int64)
    for core, tasks in enumerate(sched.assignment):
        for t in tasks:
            bins[t] = core
    return bins


def steal_rebalance(schedule: Schedule, costs: Sequence[float],
                    threshold: float = 1.10) -> Schedule:
    """Straggler mitigation: move cheapest tasks off overloaded cores.

    Mirrors work stealing in the host-runtime engine: when a core's predicted
    bin exceeds `threshold * mean`, its cheapest tasks migrate to the most
    idle core until balanced.  Deterministic, so the schedule stays
    reproducible across restarts (important for fault-tolerant replay).
    """
    assignment = [list(a) for a in schedule.assignment]
    core_time = schedule.core_time.copy().astype(float)
    mean = core_time.mean() if len(core_time) else 0.0
    for _ in range(10 * max(1, len(costs))):
        hi = int(np.argmax(core_time))
        lo = int(np.argmin(core_time))
        if mean == 0 or core_time[hi] <= threshold * mean or not assignment[hi]:
            break
        t = min(assignment[hi], key=lambda x: costs[x])
        if core_time[lo] + costs[t] >= core_time[hi]:
            break
        assignment[hi].remove(t)
        assignment[lo].append(t)
        core_time[hi] -= costs[t]
        core_time[lo] += costs[t]
    return Schedule(assignment, core_time, float(core_time.max(initial=0.0)),
                    schedule.policy + "+steal")
