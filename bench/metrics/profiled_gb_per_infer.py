"""``profiled_gb_per_infer`` (GB/infer, program counter): the bytes of
every operand the profiler's ``tile_nnz`` counts, the inputs' profiles
and the kernels' writeback profiles alike (``repro_torch.trace``
``profile_bytes``), per inference the program counted (``runs``), in
1e9 bytes.  Layer: the planner and profiler.  None where the program has
no such counter or counted none."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    runs, n = c.get("runs", 0), c.get("profile_bytes", 0)
    return n / runs / 1e9 if runs and n else None
