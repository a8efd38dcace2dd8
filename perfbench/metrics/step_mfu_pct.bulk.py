"""The whole step's share of the card's dense FP16 peak: the counted
FLOPs of the window's images over the window's seconds."""
from perfbench import counts


def read(rec):
    win, ctx = rec["window"], rec["ctx"]
    if not win.images or not rec["memory_peak_bytes"]:
        return None             # a CPU run reads no device peak
    flops = counts.total(
        counts.layer_work(ctx.layers, win.stats["forward_hw"]), "flops")
    return 100.0 * flops * win.images / win.seconds / counts.PEAK_FLOPS
