"""``mfu`` (%): the operations one inference needs (``reference/work.py``),
averaged over the window's inferences, over the mean latency of those
inferences (outside the profiler window) times the peak FLOP/s of the
work's precision (``work.rate``: float32 67e12, bfloat16 989e12 on the
H100).  Every step of a run is of one precision."""
from bench.reference import work as needed


def read(ctx):
    work, peak, lat = ctx.get("work"), ctx.get("peaks"), ctx["latencies_s"]
    if not work or not peak or not lat:
        return None
    rates = {needed.rate(w, peak) for w in work}
    if len(rates) != 1:
        raise ValueError(f"mfu: the steps' work is of several precisions "
                         f"{sorted({w['precision'] for w in work})}")
    seen = ctx["per_step"]
    flops = sum(w["flops"] * k for w, k in zip(work, seen)) / sum(seen)
    return 100.0 * flops / (sum(lat) / len(lat) * rates.pop())
