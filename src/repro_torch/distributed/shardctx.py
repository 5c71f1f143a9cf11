"""Logical sharding context for model code.

Port of ``repro.distributed.shardctx``.  A launcher installs a mesh and a
map from LOGICAL axis names to mesh axes with :func:`use_mesh`; model
code reads :func:`axis_size` (the attention picks its GQA form by the
``model`` axis's size, as the reference's does) and calls :func:`shard`.

Logical axes:
  batch  -> ("pod", "data") on the multi-pod mesh / ("data",) single-pod
  model  -> ("model",)   tensor-parallel axis (heads / ffn / vocab / experts)
  seq    -> ("model",)   sequence parallelism for the residual stream
  data   -> ("data",)    FSDP axis for parameters
  expert -> ("model",)

One card has no partitioner, so :func:`shard` is the identity: the
reference's ``with_sharding_constraint`` places nothing here.  Outside
any context :func:`axis_size` is 1, as in the reference.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

_state = threading.local()


def _current():
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_mesh(mesh, logical_axes: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Install a mesh (anything with ``axis_names`` and a ``shape``
    mapping) and a logical-axis map for model code, in this thread."""
    if logical_axes is None:
        names = mesh.axis_names
        batch = tuple(a for a in ("pod", "data") if a in names)
        logical_axes = {
            "batch": batch or (names[0],),
            "model": ("model",) if "model" in names else (),
            "seq": ("model",) if "model" in names else (),
            "data": ("data",) if "data" in names else (),
            "expert": ("model",) if "model" in names else (),
        }
    prev = _current()
    _state.ctx = (mesh, logical_axes)
    try:
        yield
    finally:
        _state.ctx = prev


def axis_size(logical: str) -> int:
    """The product of the sizes of the mesh axes ``logical`` maps to (1
    outside a context)."""
    ctx = _current()
    if ctx is None:
        return 1
    mesh, la = ctx
    size = 1
    for ax in la.get(logical, ()):
        size *= mesh.shape[ax]
    return size


def shard(x, *logical: Optional[str]):
    """The reference's sharding constraint: the identity on one card."""
    return x
