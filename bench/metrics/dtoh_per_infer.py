"""``dtoh_per_infer`` (1/infer, device trace): the device-to-host copies
in the profiler window per inference: the executor's host waits on data."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["complete"]:
        return None
    return tr["dtoh"] / tr["calls"]
