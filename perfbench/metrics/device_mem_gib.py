"""``torch.cuda.max_memory_allocated()`` over the run up to the window's
close, set-up included, in GiB: the device memory a replica pays for."""


def read(rec):
    peak = rec["memory_peak_bytes"]
    return peak / 2 ** 30 if peak else None
