"""``bitmask_repeat_pct`` (%, program counter): the share of the walk's
tile-bitmask bytes (``repro_torch.trace`` ``bitmask_bytes``) read over
an operand that an earlier pass already read unchanged, the same tensor
at the same version and k-block edge (``bitmask_repeat_bytes``): what a
bitmask kept across inferences would save.  Layer: the kernels.  None
where the program has no such counter or counted no bitmask byte."""


def read(ctx):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    c = trace.counters()
    n = c.get("bitmask_bytes", 0)
    return 100.0 * c.get("bitmask_repeat_bytes", 0) / n if n else None
