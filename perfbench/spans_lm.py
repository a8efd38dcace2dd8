"""The LM prefill's per-layer readings from the program's span log
(``repro_torch.runtime.telemetry.SPANS``, read by ``spans.records``:
nothing off the card or from a program without the spans).

``lm.prefill`` roots each traced prefill (counts ``tokens`` and
``batch``); ``lm.mamba`` (one per Mamba2 layer) and ``lm.shared`` (one
per shared-block site) lie beneath it.  A span is the host's wall over
that layer's issue: the launch queue's back-pressure ties it to the
card's pace once the host runs ahead.

The traced slice is placed by time, so which prompt lengths it holds
varies from run to run and with the program's speed.  A layer's summed
spans are therefore read per unit of the work ``counts_lm`` counts for
that layer in the same prefills (ms per TFLOP), which does not depend
on the slice's mix of lengths where the layer's rate does not.
"""
from __future__ import annotations

from typing import Callable, Optional

from perfbench.spans import records


def ms_per_tflop(rec, name: str, work: Callable) -> Optional[float]:
    """The summed ``name`` spans beneath the traced ``lm.prefill`` spans,
    in ms, over ``work(m, batch, length)`` (FLOPs) summed over those
    prefills, in TFLOP; None without them."""
    spans = records(rec)
    roots = {s.id: s.counts for s in spans if s.name == "lm.prefill"}
    if not roots:
        return None
    m = rec["ctx"].layers
    flops = sum(work(m, c["batch"], c["tokens"] // c["batch"])
                for c in roots.values())
    total = sum(s.end - s.start for s in spans
                if s.name == name and s.parent in roots)
    return total * 1e-6 / (flops * 1e-12)
