"""``idle_share`` (%, device trace): 1 minus the device busy time over the
profiler window's wall."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["complete"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
