"""``syncs_per_infer`` (1/infer, program counter): the host waits on the
device that the program itself makes (``repro_torch.trace``
``host_syncs``: the closing sync, event waits, the report's copies to
the host) per inference the program counted (``runs``).  Layer: the
executor.  None where the program has no such counter or counted
none."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    runs, n = c.get("runs", 0), c.get("host_syncs", 0)
    return n / runs if runs and n else None
