"""torch.cuda.max_memory_allocated over the index build, the warm-up and
the window, the benchmark's inputs (rows, queries, bitmaps) included."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
