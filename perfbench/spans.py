"""The per-layer metrics read from the program's span log
(``repro_torch.runtime.telemetry.SPANS``): what it recorded while the
run's profiler was on, which is the serving cell's window and its drain
and the bulk cell's traced slice.

A program without the log reads nothing, and so does a run off the
card: there the engine's ops run as they are issued, so its wall is
compute and no split of launches from waits exists.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np


def records(rec) -> list:
    """The log's spans, or none."""
    if not str(rec["ctx"].device).startswith("cuda"):
        return []
    try:
        from repro_torch.runtime import telemetry
    except ImportError:
        return []
    log = getattr(telemetry, "SPANS", None)
    return log.records() if log is not None else []


def durations_ms(spans, name: str) -> List[float]:
    return [(s.end - s.start) * 1e-6 for s in spans if s.name == name]


def engine_calls(spans) -> List[Tuple[float, float, Dict[str, int]]]:
    """Per ``engine.run`` span: its wall (ms), the summed ``cc.sync``
    spans beneath it (ms) and its counts."""
    by_id = {s.id: s for s in spans}
    sync: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s.name != "cc.sync":
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != "engine.run":
            p = by_id.get(p.parent)
        if p is not None:
            sync[p.id] += s.end - s.start
    return [((s.end - s.start) * 1e-6, sync[s.id] * 1e-6, s.counts)
            for s in spans if s.name == "engine.run"]


def p95(xs) -> Optional[float]:
    return float(np.percentile(xs, 95)) if len(xs) else None


def mean(xs) -> Optional[float]:
    return float(np.mean(xs)) if len(xs) else None


def launch_ms(rec) -> Optional[float]:
    """Mean per engine call of its wall less its ``cc.sync`` time: the
    host launching."""
    return mean([w - s for w, s, _ in engine_calls(records(rec))])


def sync_ms(rec) -> Optional[float]:
    """Mean per engine call of its ``cc.sync`` time: the host blocked on
    the device."""
    return mean([s for _, s, _ in engine_calls(records(rec))])


def rounds(rec) -> Optional[float]:
    """Mean ``cc.rounds`` per engine call."""
    return mean([c.get("cc.rounds", 0) for _, _, c in
                 engine_calls(records(rec))])
