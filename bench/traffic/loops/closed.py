"""Loop ``closed``: one client sends the next inference as soon as the last
one has answered.

Each inference is timed on the host clock from the call until after
``torch.cuda.synchronize()``; the window's wall takes in the traffic's
input changes between them.  A change is enqueued just before the call
and not waited for: what of it the device has not finished counts in the
inference's latency, as a user who updates and then infers sees it.  One
output of each step, drawn by ``rng`` (a reservoir of one over the step's
inferences), is kept for the check.
"""
import time
from typing import Dict, List

import torch

CLIENTS = (1,)


def window(cell, seconds: float, rng, first: int) -> dict:
    """Inferences back to back for ``seconds`` and at least one of each
    step, the ``first``-th of the run first.  Returns the latencies, the
    wall, the inferences of each step and one kept output of each."""
    if cell.traffic["clients"] not in CLIENTS:
        raise ValueError(f"closed loop: {cell.traffic['clients']} clients; "
                         f"one process drives {CLIENTS}")
    steps = cell.inputs.steps
    lat: List[float] = []
    seen = [0] * steps
    kept: Dict[int, torch.Tensor] = {}
    cell.sync()
    start = time.perf_counter()
    i = 0
    while True:
        s = cell.inputs.step(first + i)
        cell.inputs.show(s)
        t0 = time.perf_counter()
        out = cell.infer(s)
        cell.sync()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        seen[s] += 1
        if rng.random() * seen[s] < 1.0:
            kept[s] = out
        del out
        i += 1
        if t1 - start >= seconds and min(seen) > 0:
            break
    return {"latencies_s": lat, "window_s": t1 - start, "per_step": seen,
            "kept": kept}
