"""Peak device memory allocated in the window, GiB (the CUDA allocator's
max_memory_allocated after a reset at the window's start)."""


def read(record):
    return record["memory_peak_bytes"] / 2**30 if record["memory_peak_bytes"] else None
