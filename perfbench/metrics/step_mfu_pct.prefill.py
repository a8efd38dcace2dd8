"""The whole prefill's share of the card's dense BF16 peak: the counted
FLOPs of the window's prefills (``counts_lm.prefill_flops``) over the
window's seconds."""
from perfbench import counts_lm


def read(rec):
    win, m = rec["window"], rec["ctx"].layers
    lengths = win.stats.get("prefill_lengths")
    if not lengths or not rec["memory_peak_bytes"]:
        return None             # a CPU run reads no device peak
    flops = sum(counts_lm.prefill_flops(m, win.stats["batch"], n)
                for n in lengths)
    return 100.0 * flops / win.seconds / counts_lm.PEAK_FLOPS
