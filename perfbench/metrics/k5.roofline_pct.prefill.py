"""K5's share of its roofline: the counted bound of every Mamba2 layer's
intra-chunk block in the traced slice's prefills (``counts_lm.k5_work``)
over the device time of the ``ssd_chunk_kernel`` launches in the
slice."""
from perfbench import counts_lm
from perfbench.trace import kernel_seconds


def read(rec):
    t = kernel_seconds(rec["trace"], "ssd_chunk_kernel")
    win, m = rec["window"], rec["ctx"].layers
    lengths = win.stats.get("slice_lengths")
    if t <= 0 or not lengths:
        return None
    bound = sum(counts_lm.k5_work(m, win.stats["batch"], n)["bound_s"]
                for n in lengths) * m["layers"]
    return 100.0 * bound / t
