"""``profile_ms`` (ms, device trace): the device time per inference of the
profiler's kernel (``tile_nnz``, ``kernels/csrc/tile_nnz.cu``): the
planner's profiling of the features."""
KERNELS = ("tile_nnz_kernel",)


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["complete"]:
        return None
    hits = [s for name, _, s in tr["events"]
            if any(k in name for k in KERNELS)]
    return sum(hits) / tr["calls"] * 1e3 if hits else None
