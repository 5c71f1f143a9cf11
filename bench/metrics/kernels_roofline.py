"""``kernels_roofline`` (%, device trace): the least time the card could
take for the work one inference needs (``reference/work.py``
``bound_seconds``, at the peak FLOP/s of the work's precision) over the
device busy time per inference, both over the profiler window's
inferences (one of each step of the traffic)."""
from bench.reference import work as needed


def read(ctx):
    tr, work, peak = ctx.get("trace"), ctx.get("work"), ctx.get("peaks")
    if not tr or not tr["complete"] or not work or not peak:
        return None
    bound = sum(needed.bound_seconds(w, peak) for w in work)
    return 100.0 * bound / len(work) / (tr["busy_s"] / tr["calls"])
