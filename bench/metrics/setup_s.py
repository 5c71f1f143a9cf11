"""``setup_s`` (s, host clock): from the start of the run's process to the
start of the window: CUDA, the program's kernels (built in the first run
of a checkout), the inputs made from the seed, the compile, the warm-up."""


def read(ctx):
    return ctx["setup_s"]
