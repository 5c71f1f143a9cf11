"""``host_ms_per_infer`` (ms, program span): the host time of
``FusedModelExecutor.run`` from its entry to the start of its closing
wait on the device (``repro_torch.trace`` ``run_host_ns``), per
inference the program counted (``runs``).  Layer: the executor.  None
where the program has no such counter or counted none."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    runs, n = c.get("runs", 0), c.get("run_host_ns", 0)
    return n / runs / 1e6 if runs and n else None
