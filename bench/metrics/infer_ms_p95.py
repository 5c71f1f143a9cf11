"""``infer_ms_p95`` (ms, host clock): the 95th percentile of every
inference's latency in the window, each from the call until after
``torch.cuda.synchronize()`` (``statistics.quantiles``, inclusive)."""
import statistics


def read(ctx):
    lat = ctx["latencies_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
