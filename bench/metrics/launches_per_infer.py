"""``launches_per_infer`` (1/infer, program counter): the launches of the
program's kernels over the window (``repro_torch.kernels.launch_counts``)
per inference.  Layer: the executor."""


def read(ctx):
    n = ctx["inferences"]
    return sum(ctx["launches"].values()) / n if n else None
