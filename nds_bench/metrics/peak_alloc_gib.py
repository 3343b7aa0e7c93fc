"""The caching allocator's peak of allocated bytes over the window
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats`` at the
window's start), in GiB."""


def read(run):
    if run.peak_alloc_bytes is None:
        return None
    return run.peak_alloc_bytes / 2 ** 30
