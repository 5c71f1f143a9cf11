"""Consolidated serving configuration: :class:`EngineConfig` and
:class:`ServeConfig`.

Port of ``repro.serving.config``.  Everything
:class:`~repro_torch.serving.graph_engine.GraphServeEngine` and
:class:`~repro_torch.serving.scheduler.ContinuousGraphServer` are built
from lives in two frozen dataclasses; both accept ``config=`` while every
keyword keeps working, under one merge rule (``merge_config``):

* kwargs explicitly passed at the call site override the matching config
  field -- *unless* the config also sets that field away from its default
  to a DIFFERENT value, which raises ``ValueError`` (a conflicting
  duplicate: two sources disagree and neither obviously wins);
* passing the same value both ways is a harmless duplicate;
* with no ``config=``, kwargs build the config.

The resolved config is kept on the object (``.config``), and
``from_config`` builds an equivalent one.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

_UNSET = object()        # sentinel: "kwarg not passed at the call site"


def merge_config(cls, config, kwargs: Dict[str, Any]):
    """Resolve a config dataclass from ``config=`` plus call-site kwargs.

    ``kwargs`` maps field name -> value-or-``UNSET`` (the constructor's
    sentinel defaults); only explicitly passed kwargs take part.  Rules:

    * no config: explicit kwargs over the dataclass defaults;
    * config + kwarg on a field the config left at its default: the kwarg
      overrides;
    * config + kwarg agreeing on a value: fine (duplicate, not conflict);
    * config + kwarg DISAGREEING on a field the config set away from its
      default: ``ValueError``.
    """
    if config is not None and not isinstance(config, cls):
        raise TypeError(
            f"config must be {cls.__name__}, got {type(config).__name__}")
    passed = {k: v for k, v in kwargs.items() if v is not _UNSET}
    unknown = set(passed) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise TypeError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    if config is None:
        return cls(**passed)
    defaults = {f.name: f.default for f in dataclasses.fields(cls)}
    merged = {}
    for name, value in passed.items():
        cfg_value = getattr(config, name)
        if not _same(cfg_value, defaults[name]) and not _same(cfg_value, value):
            raise ValueError(
                f"{cls.__name__}.{name} given both via config= "
                f"({cfg_value!r}) and as a kwarg ({value!r}); drop one "
                f"(equal duplicates are allowed)")
        merged[name] = value
    return dataclasses.replace(config, **merged) if merged else config


def _same(a, b) -> bool:
    if a is b:
        return True
    try:
        return bool(a == b)
    except Exception:               # arrays, tensors: identity was the test
        return False


UNSET = _UNSET                      # constructors import this as a default


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every knob :class:`GraphServeEngine` is built from.

    ``f_in`` is the one required field; everything else keeps the
    reference's default.  ``weights``/``cost_model`` hold live objects --
    equality on those falls back to identity.  The reference's ``donate``
    is left out: it is an XLA buffer-donation hint with no effect on
    results, and a torch walk has no program whose buffers it could alias.

    * ``f_in`` -- input feature width every admitted request must match.
    * ``model`` -- ``"gcn"`` | ``"sage"`` | ``"gin"`` | ``"sgc"`` |
      ``"gat"`` (``models.gnn.GNN_MODELS``).
    * ``hidden`` / ``n_classes`` -- widths of the served 2-layer model.
    * ``weights`` -- a dict of arrays keyed like ``init_spec_weights``'
      output (numpy, e.g. ``np.asarray`` of the reference engine's
      ``weights``); ``None`` draws fresh ones from ``weight_seed`` at
      ``weight_density``.
    * ``slots`` -- requests per wave (partial waves are padded with zero
      dummy slots, so each bucket builds one walk plan).
    * ``min_bucket`` -- floor of the power-of-two bucket ladder.
    * ``strategy`` / ``n_cc`` / ``align`` / ``on_chip_bytes`` -- planner
      strategy and partitioner geometry.
    * ``collect_report`` -- per-request per-kernel report rows (moves the
      code grids to the host).
    * ``keep_codes`` -- keep the planned codes and formats per kernel.
    * ``format_aware`` / ``csr_rmax`` -- the row-CSR route (active under a
      cost model with format costs).
    * ``cost_model`` -- ``None`` = ``FPGACostModel()``.
    * ``mesh`` -- a 1-D ``cores`` mesh (``distributed.sharding
      .cores_mesh``) for sharded waves; ``None`` = one device.
    * ``device`` -- where the weights live and waves run (``None`` = the
      GPU, through ``device.resolve``; ``"cpu"`` runs the plain versions).
    """

    f_in: int
    model: str = "gcn"
    hidden: int = 16
    n_classes: int = 7
    weights: Optional[Dict[str, Any]] = None
    weight_seed: int = 0
    weight_density: float = 1.0
    slots: int = 4
    min_bucket: int = 64
    strategy: str = "dynamic"
    n_cc: int = 7
    align: int = 16
    on_chip_bytes: int = 256 * 1024
    collect_report: bool = False
    keep_codes: bool = False
    mesh: Optional[Any] = None
    cost_model: Optional[Any] = None
    format_aware: bool = True
    csr_rmax: int = 64
    device: Optional[Any] = None

    def validate(self) -> "EngineConfig":
        if self.f_in < 1:
            raise ValueError(f"f_in {self.f_in} < 1")
        if self.slots < 1:
            raise ValueError(f"slots {self.slots} < 1")
        if self.hidden < 1 or self.n_classes < 1:
            raise ValueError(
                f"hidden {self.hidden} / n_classes {self.n_classes} < 1")
        return self

    def __eq__(self, other):
        if not isinstance(other, EngineConfig):
            return NotImplemented
        return all(_same(getattr(self, f.name), getattr(other, f.name))
                   for f in dataclasses.fields(self))

    __hash__ = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every knob :class:`ContinuousGraphServer` is built from.

    The wave-cutting policy:

    * ``clock`` -- the time source every deadline and arrival is measured
      on (monotonic seconds; tests inject a fake clock here).
    * ``ewma_alpha`` -- smoothing factor in (0, 1] of the per-bucket
      wave-wall estimates behind deadline slack (higher reacts faster).
    * ``cold_start_wall`` -- assumed wave wall (seconds) of a bucket with
      no measurement yet.
    * ``slack_margin`` -- a queued request forces a cut once its slack is
      below ``slack_margin`` x the bucket's wait bound (> 1 cuts earlier).
    * ``batch_patience`` -- how long a partial wave waits for more
      requests when nobody is urgent, as a multiple of the estimated wall.
    * ``max_wait`` -- hard age bound (seconds): a wave is force-cut once
      its oldest request has waited this long.
    * ``n_lanes`` -- dispatch lanes pulling cut waves (``None`` = one per
      device of the engine's mesh, 1 when unsharded).  Lanes of a shared
      mesh keep ``min(n_lanes, 2)`` waves in flight
      (``ContinuousGraphServer.pipeline_depth``), so a value above 2
      behaves as 2: it adds lane labels, each with its own wall EWMA, but
      no concurrency.  Measured on the H100, two waves in flight were
      within noise of one (``PERF.md``).
    * ``resize`` -- make the lanes DISJOINT device groups of the engine's
      mesh, replanned between waves from the queue (``scheduler
      .plan_groups``); requires an engine with a mesh.

    The overload control:

    * ``shed`` -- ``"never"`` admits everything; ``"predicted-miss"``
      rejects requests whose predicted completion already misses their
      deadline (and sheds queued ones that can no longer make it);
      ``"capacity"`` rejects once ``max_pending`` requests are queued.
    * ``admit_margin`` -- slack multiple under which an admitted request
      is ``"admit-at-risk"`` instead of ``"admit"`` (>= 1).
    * ``max_pending`` -- queue bound for ``shed="capacity"``.
    * ``pressure_threshold`` -- backlog bound (seconds) above which
      at-risk queued requests are shed lowest class first (``inf`` =
      never).
    * ``priority_weight`` -- a priority-``p`` wave's class weight is
      ``priority_weight ** p`` in the weighted-fair launch order.
    * ``autoscale`` -- resize mode only: re-pick the number of groups each
      tick (``scheduler.plan_lanes``) by the predicted finish over the
      per-size EWMA walls, instead of always spreading to ``n_lanes``.

    The giant-graph front door:

    * ``minibatch`` -- a ``serving.minibatch.MiniBatchPlanner`` enabling
      ``submit_query(seeds, deadline=)``: one sampled subgraph per seed
      vertex through the planner, hot seeds answered from its vertex
      cache, wave results routed back to the waiting queries, and
      ``apply_delta`` for streaming edge deltas.  ``None`` (default)
      keeps the whole-graph-only server.
    """

    clock: Callable[[], float] = time.monotonic
    ewma_alpha: float = 0.25
    cold_start_wall: float = 0.05
    slack_margin: float = 1.5
    batch_patience: float = 1.0
    max_wait: float = 0.25
    n_lanes: Optional[int] = None
    resize: bool = False
    shed: str = "never"
    admit_margin: float = 1.5
    max_pending: Optional[int] = None
    pressure_threshold: float = math.inf
    priority_weight: float = 2.0
    autoscale: bool = False
    minibatch: Optional[Any] = None

    def validate(self) -> "ServeConfig":
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha {self.ewma_alpha} not in (0, 1]")
        # a negative max_wait would force-cut every tick and a negative
        # slack_margin invert the deadline comparison
        for name in ("cold_start_wall", "slack_margin", "batch_patience",
                     "max_wait"):
            v = getattr(self, name)
            if not v >= 0.0:            # also catches NaN
                raise ValueError(f"{name} {v} must be >= 0")
        if self.n_lanes is not None and self.n_lanes < 1:
            raise ValueError(f"n_lanes {self.n_lanes} < 1")
        if self.shed not in ("never", "predicted-miss", "capacity"):
            raise ValueError(
                f"shed {self.shed!r} not in 'never' | 'predicted-miss' | "
                f"'capacity'")
        if self.shed == "capacity" and (self.max_pending is None
                                        or self.max_pending < 1):
            raise ValueError(
                f"shed='capacity' needs max_pending >= 1, got "
                f"{self.max_pending}")
        if not self.admit_margin >= 1.0:
            raise ValueError(f"admit_margin {self.admit_margin} must be >= 1")
        if not self.pressure_threshold > 0.0:
            raise ValueError(
                f"pressure_threshold {self.pressure_threshold} must be > 0")
        if not self.priority_weight > 0.0:
            raise ValueError(
                f"priority_weight {self.priority_weight} must be > 0")
        if self.autoscale and not self.resize:
            raise ValueError("autoscale=True requires resize=True "
                             "(it re-picks the plan_groups lane count)")
        return self

    def __eq__(self, other):
        if not isinstance(other, ServeConfig):
            return NotImplemented
        return all(_same(getattr(self, f.name), getattr(other, f.name))
                   for f in dataclasses.fields(self))

    __hash__ = None
