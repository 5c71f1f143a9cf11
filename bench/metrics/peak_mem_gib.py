"""``peak_mem_gib`` (GiB): ``torch.cuda.max_memory_allocated()`` over the
window, after ``reset_peak_memory_stats()`` at its start: the resident
inputs and the program's working memory."""


def read(ctx):
    peak = ctx["peak_mem_bytes"]
    return peak / 2 ** 30 if peak else None
