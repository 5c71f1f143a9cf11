"""``walk_scratch_gib`` (GiB, program counter): the ``dispatch`` walk's
largest single scratch allocation (bitmask words, staged x tiles, padded
y; on bf16 the flags and partials), the high mark ``repro_torch.trace``
``walk_scratch_bytes``, in 2**30 bytes.  Layer: the device.  None where
the program has no such counter or counted none."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    n = trace.counters().get("walk_scratch_bytes", 0)
    return n / 2 ** 30 if n else None
