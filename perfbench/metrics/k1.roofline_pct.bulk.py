"""K1's share of its roofline: the counted bound of the configuration's
3x3 stride-1 convs for the traced slice's images, over the device time
of the ``winograd_fused_kernel`` launches in the slice."""
from perfbench.trace import roofline_pct


def read(rec):
    return roofline_pct(rec, "k1", "winograd_fused_kernel")
