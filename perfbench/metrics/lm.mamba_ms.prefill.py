"""Summed ``lm.mamba`` spans (one per Mamba2 layer) of the traced
``lm.prefill`` calls, in ms per TFLOP of those layers' counted work
(``counts_lm.mamba_flops``)."""
from perfbench.counts_lm import mamba_flops
from perfbench.spans_lm import ms_per_tflop


def read(rec):
    return ms_per_tflop(rec, "lm.mamba", mamba_flops)
