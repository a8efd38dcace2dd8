"""K2's share of its roofline: the counted bound of the configuration's
1x1 stride-1 convs for the traced slice's images, over the device time
of the ``bfp_matmul_kernel`` launches in the slice."""
from perfbench.trace import roofline_pct


def read(rec):
    return roofline_pct(rec, "k2", "bfp_matmul_kernel")
