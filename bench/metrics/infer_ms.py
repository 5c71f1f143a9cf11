"""``infer_ms`` (ms, host clock): the window's wall over the inferences
completed in it, the snapshot rewrites between them included."""


def read(ctx):
    n = ctx["inferences"]
    return ctx["window_s"] / n * 1e3 if n else None
