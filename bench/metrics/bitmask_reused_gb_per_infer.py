"""``bitmask_reused_gb_per_infer`` (GB/infer, program counter): the bytes
of the dense lhs that the ``dispatch`` walk did not read again because a
held format of it served the walk (``repro_torch.trace``
``bitmask_reused_bytes``, counted in ``kernels/dispatch.py``) per
inference the program counted (``runs``), in 1e9 bytes.  Layer: the
kernels.  None where the program has no such counter or counted none."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    runs, n = c.get("runs", 0), c.get("bitmask_reused_bytes", 0)
    return n / runs / 1e9 if runs and n else None
