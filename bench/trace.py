"""The profiler window of a ``--trace 1`` run.

The guard is copied from ``chip_smoke.py`` ``profile_device``: on the H100
the profiler sometimes drops the first device events of a window, so each
window opens with ``SENTINELS`` short spin kernels, left out of the
counts; every inference launches a whole number of each kernel, so a
window whose counts are not multiples of the calls still lost events and
is taken again, up to ``WINDOWS`` times.  When none is whole the device
numbers are not measured.  Copied, not imported, so that a later change
to the program cannot move the yardstick.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Callable, List, Optional

import torch

SENTINELS = 32
SPAN = "bench."
WINDOWS = 4
TOP = 10


def _device_s(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    if us is None:
        us = getattr(e, "self_cuda_time_total", 0.0)
    return us / 1e6


def _is_device(e) -> bool:
    return getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA


def _is_op(name: str) -> bool:
    """A device operation: not a sentinel, and not the benchmark's own
    ``record_function`` span, which the profiler also lists on the
    device."""
    return "spin_kernel" not in name and not name.startswith(SPAN)


def idle_gaps(events) -> List[list]:
    """The gaps between device operations, summed by the innermost host
    operation that was running when each began (``host`` where none was
    recorded), the longest ``TOP``, in seconds."""
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if _is_device(e):
            if _is_op(e.name):
                dev.append((tr.start, tr.end))
        else:
            host.append((tr.start, tr.end, e.name))
    dev.sort()
    host.sort()
    starts = [h[0] for h in host]
    sums = defaultdict(float)
    end = None
    for s, e in dev:
        if end is not None and s > end:
            i = bisect.bisect_right(starts, end) - 1
            name = "host"
            while i >= 0:
                if host[i][1] >= end:
                    name = host[i][2]
                    break
                i -= 1
            sums[name] += (s - end) / 1e6
        end = e if end is None else max(end, e)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:TOP]]


def profile_window(fn: Callable[[], object], calls: int,
                   device: torch.device) -> Optional[dict]:
    """Profile ``fn`` (``calls`` inferences) after the sentinels.  Returns
    the window's length and device busy time in seconds, the device
    events as ``(name, count, seconds)``, the device-to-host copies, and
    the breakdown, or ``None`` off the card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    for window in range(1, WINDOWS + 1):
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with torch.no_grad(), profile(activities=acts) as prof:
            for _ in range(SENTINELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            with torch.profiler.record_function(SPAN + "inferences"):
                fn()
            torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t
        events = [e for e in prof.key_averages()
                  if _is_device(e) and _device_s(e) > 0 and _is_op(e.key)]
        complete = bool(events) and all(e.count % calls == 0
                                        for e in events)
        if complete:
            break
    if not complete:
        return {"complete": False, "windows": window, "calls": calls,
                "partial": [(e.key[:80], e.count) for e in events
                            if e.count % calls][:TOP]}
    busy = sum(_device_s(e) for e in events)
    top = sorted(events, key=_device_s, reverse=True)[:TOP]
    return {"complete": True, "windows": window, "calls": calls,
            "window_s": window_s, "busy_s": busy,
            "events": [(e.key, e.count, _device_s(e)) for e in events],
            "dtoh": sum(e.count for e in events
                        if "dtoh" in e.key.lower().replace(" ", "")),
            "breakdown": {
                "device_ops": [[e.key[:80], _device_s(e)] for e in top],
                "idle_gaps": idle_gaps(prof.events())}}
