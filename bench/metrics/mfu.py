"""``mfu`` (%): the operations one inference needs (``reference/work.py``),
averaged over the window's inferences, over the mean latency of those
inferences (outside the profiler window) times the float32 peak."""


def read(ctx):
    work, peak, lat = ctx.get("work"), ctx.get("peaks"), ctx["latencies_s"]
    if not work or not peak or not lat:
        return None
    seen = ctx["per_step"]
    flops = sum(w["flops"] * k for w, k in zip(work, seen)) / sum(seen)
    return 100.0 * flops / (sum(lat) / len(lat) * peak["fp32_flops"])
