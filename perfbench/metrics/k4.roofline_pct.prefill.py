"""K4's share of its roofline: the counted bound of every site's
attention in the traced slice's prefills (``counts_lm.k4_work``) over
the device time of the ``flash_wgmma_kernel`` launches in the slice."""
from perfbench import counts_lm
from perfbench.trace import kernel_seconds


def read(rec):
    t = kernel_seconds(rec["trace"], "flash_wgmma_kernel")
    win, m = rec["window"], rec["ctx"].layers
    lengths = win.stats.get("slice_lengths")
    if t <= 0 or not lengths:
        return None
    bound = sum(counts_lm.k4_work(m, win.stats["batch"], n)["bound_s"]
                for n in lengths) * m["sites"]
    return 100.0 * bound / t
