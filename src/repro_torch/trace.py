"""Spans and counters inside the port, on the device trace's clock.

:func:`span` opens a ``torch._C._profiler._RecordFunctionFast`` while a
``torch.profiler`` session is recording, and does nothing otherwise: an
operator (or the benchmark) turns the spans on by running the profiler,
and they land on the same Kineto timeline as the kernels.  A
``_RecordFunctionFast`` is a plain CPU op, not a user annotation, so the
profiler does not also list it as a device event (``record_function``
would be, and would count twice in a trace's device busy time).

Span names (``repro_torch.`` then):

* ``run`` -- one ``FusedModelExecutor.run``; its children
  ``run.signature`` (the walk plan's lookup), ``run.input_profiles``
  (the graph inputs' block counts), one span per IR kernel, ``run.sync``
  (the closing host wait) and ``run.report`` (the bookkeeping);
* ``<kernel>`` -- one IR kernel of the walk (``run``'s, a wave's slot's,
  or ``DynasparseEngine``'s), with the children of :class:`KernelSpans`:
  ``.plan`` (the code grid and format), ``.format`` (the ELL
  conversion), ``.block_path`` (the one C call: bitmask, staging, walk),
  ``.epilogue`` and ``.writeback`` (the result's block counts);
* ``wave.launch`` and ``wave.finish`` -- ``launch_batch`` and
  ``finish_batch`` of a served wave.

:func:`count` adds to a counter and :func:`high` keeps a running
maximum, where the work happens; :func:`counters` reads them all, the
kernels' launch counts included (``launch.<kernel>``), and :func:`reset`
(called by ``kernels.reset_launch_counts``) zeroes them.  The counters:

* ``runs`` -- inferences: one per ``run``, one per slot of a wave;
* ``bitmask_bytes`` / ``bitmask_repeat_bytes`` -- bytes of the dense lhs
  that the ``dispatch`` walk's tile-bitmask pass reads, and the part
  over an operand that an earlier pass already read unchanged
  (``kernels.dispatch.count_bitmask_pass``);
* ``walk_scratch_bytes`` (high) -- the walk's largest scratch allocation;
* ``profile_bytes`` -- bytes of every operand ``tile_nnz`` counts;
* ``host_syncs`` -- the program's own host waits on the device;
* ``run_host_ns`` -- host time of ``run`` up to its closing wait.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."
RUN = PREFIX + "run"
RUN_SIGNATURE = RUN + ".signature"
RUN_INPUT_PROFILES = RUN + ".input_profiles"
RUN_SYNC = RUN + ".sync"
RUN_REPORT = RUN + ".report"
WAVE_LAUNCH = PREFIX + "wave.launch"
WAVE_FINISH = PREFIX + "wave.finish"

_NULL = contextlib.nullcontext()
_counts: Dict[str, int] = {}


class KernelSpans(NamedTuple):
    """The span names of one IR kernel and of its phases."""
    kernel: str
    plan: str
    format: str
    block_path: str
    epilogue: str
    writeback: str


@functools.lru_cache(maxsize=None)
def kernel_spans(kernel: str) -> KernelSpans:
    """``repro_torch.<kernel>`` and its phases, built once per kernel
    name."""
    base = PREFIX + kernel
    return KernelSpans(base, *(f"{base}.{p}"
                               for p in KernelSpans._fields[1:]))


def span(name: Optional[str]):
    """A span named ``name`` while a profiler records, else (or when
    ``name`` is None) a no-op context."""
    if name is not None and _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NULL


def spanned(name: str):
    """Decorate a function to run inside :func:`span` ``(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + n


def high(name: str, v: int) -> None:
    if v > _counts.get(name, 0):
        _counts[name] = v


def counters() -> Dict[str, int]:
    """Every counter since the last :func:`reset`, the kernels' launches
    under ``launch.<kernel>``."""
    from repro_torch import kernels
    out = dict(_counts)
    out.update((f"launch.{k}", v) for k, v in kernels.launch_counts().items())
    return out


def reset() -> None:
    _counts.clear()
