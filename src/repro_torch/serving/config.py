"""Consolidated serving configuration: :class:`EngineConfig`.

Port of the engine half of ``repro.serving.config``.  Everything
:class:`~repro_torch.serving.graph_engine.GraphServeEngine` is built from
lives in one frozen dataclass; the engine accepts ``config=`` while every
keyword keeps working, under one merge rule (``merge_config``):

* kwargs explicitly passed at the call site override the matching config
  field -- *unless* the config also sets that field away from its default
  to a DIFFERENT value, which raises ``ValueError`` (a conflicting
  duplicate: two sources disagree and neither obviously wins);
* passing the same value both ways is a harmless duplicate;
* with no ``config=``, kwargs build the config.

The resolved config is kept on the engine (``.config``), and
``GraphServeEngine.from_config(eng.config)`` builds an equivalent engine.
``ServeConfig`` (the continuous scheduler's knobs) comes with the
scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

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
    and ``mesh`` are left out: nothing in the port reads them (sharded
    waves are ``ROADMAP.md`` queue 1 item 7).

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
