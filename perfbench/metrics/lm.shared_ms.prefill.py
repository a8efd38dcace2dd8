"""Summed ``lm.shared`` spans (one per shared-block site: the block over
concat(hidden, embeddings) and the site's linear) of the traced
``lm.prefill`` calls, in ms per TFLOP of those sites' counted work
(``counts_lm.shared_flops``)."""
from perfbench.counts_lm import shared_flops
from perfbench.spans_lm import ms_per_tflop


def read(rec):
    return ms_per_tflop(rec, "lm.shared", shared_flops)
