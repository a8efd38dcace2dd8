"""The traced slice of a ``--trace 1`` run and its reduction.

``torch.profiler`` records the device's activity, and the host ops of
the thread that drives the window, over the window's last ``SLICE``
share, at most ``MAX_SLICE_S``, so that the trace stays tens of MB and
the reading fits the run's time.  The profiler is stopped and read
once the window has closed, so that neither blocks the traffic.  An open
loop starts it before the window, while the service's threads are idle,
and marks where the slice begins (``Tracer.start_quiet``).  The
reduction keeps:

* ``window_s``: the slice's span on the trace's clock;
* ``busy_s``: the union of the device's activity intervals (kernels,
  copies, fills) within it;
* ``device_ops``: device seconds by operation name;
* ``idle_gaps``: the device's idle time by what the host was doing at
  the middle of each gap (the innermost host op open then, or ``none``).

No number of a CPU run is written under a device metric: without a card
the slice records no device activity and the readers find nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

SLICE = 0.4             # share of the window the slice lasts
MAX_SLICE_S = 4.0
MIN_GAP_NS = 20_000     # shorter idle gaps are launch jitter, not named
START_MARK = "bench.slice_start"
END_MARK = "bench.window_end"


class Tracer:
    """A profiler over one slice of the window, or nothing when off."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = bool(enabled)
        self.device = device
        self._prof = None
        self._stopped = None
        self._summary: Optional[Dict] = None
        self._marked = None
        self.start_at = float("inf")

    def plan(self, t0: float, seconds: float) -> None:
        """Fix the slice's start for a window that starts at ``t0`` (host
        clock); it ends with the window."""
        self.start_at = t0 + seconds - min(SLICE * seconds, MAX_SLICE_S)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        loads its libraries."""
        if self.enabled:
            self.start()
            torch.zeros(1, device=self.device).add_(1)
            self.stop(keep=False)

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self, keep: bool = True) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        if keep:
            self._stopped = prof

    @property
    def summary(self) -> Optional[Dict]:
        """The slice's reduction, read on first use (after the window)."""
        if self._summary is None and self._stopped is not None:
            self._summary = reduce(self._stopped)
            self._stopped = None
        return self._summary

    def start_quiet(self) -> None:
        """Start the profiler now, before the window, while the program's
        threads are idle (starting it beside threads that launch work has
        crashed the process); the slice then begins at a mark."""
        if self.enabled:
            self.start()
            self._marked = False

    def tick(self, now: float) -> None:
        """Start the slice once the host clock reaches it."""
        if not self.enabled or now < self.start_at:
            return
        if self._prof is not None and self._marked is False:
            with torch.profiler.record_function(START_MARK):
                pass
            self._marked = True
        elif self._prof is None and self._stopped is None \
                and self._summary is None:
            self.start()

    def mark_end(self) -> None:
        """Mark the window's end in the slice, which the reduction cuts
        at; an open loop stops the profiler only once its requests are
        done, as stopping it beside busy threads is not safe."""
        if self._prof is not None:
            with torch.profiler.record_function(END_MARK):
                pass

    def finish(self) -> None:
        """After the window: stop the slice and read it."""
        if self._prof is not None:
            self.stop()


def _events(prof) -> Tuple[List[Tuple[int, int, str]],
                           List[Tuple[int, int, str]]]:
    """(device, host) events as (start_ns, end_ns, name)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns()
        t = (s, s + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(t)
        elif not (e.is_user_annotation() or t[2].startswith("bench.")):
            # a host annotation's span as the device saw it is no work
            dev.append(t)
    return dev, host


def _union(iv: List[Tuple[int, int, str]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e, _ in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(host_sorted, starts, t: int) -> str:
    """Name of the latest-starting host op open at ``t``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 4000, -1), -1):
        s, e, name = host_sorted[j]
        if e >= t:
            return name
    return "none"


def reduce(prof) -> Dict:
    dev, host = _events(prof)
    starts = [s for s, _, name in host if name == START_MARK]
    ends = [s for s, _, name in host if name == END_MARK]
    lo_cut = min(starts) if starts else -1
    cut = min(ends) if ends else float("inf")
    dev = [(max(s, lo_cut), min(e, cut), n) for s, e, n in dev
           if e > lo_cut and s < cut]
    host = [(max(s, lo_cut), min(e, cut), n) for s, e, n in host
            if e > lo_cut and s < cut]
    ops: Dict[str, float] = defaultdict(float)
    for s, e, name in dev:
        ops[name] += (e - s) * 1e-9
    everything = dev + host
    if not everything:
        return {"window_s": 0.0, "busy_s": 0.0, "device_ops": {},
                "idle_gaps": {}}
    lo = lo_cut if starts else min(s for s, _, _ in everything)
    hi = cut if ends else max(e for _, e, _ in everything)
    busy = _union(dev)
    host_sorted = sorted(host)
    starts = [s for s, _, _ in host_sorted]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a >= MIN_GAP_NS:
            gaps[_innermost(host_sorted, starts, (a + b) // 2)] += \
                (b - a) * 1e-9
    return {"window_s": (hi - lo) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "device_ops": dict(ops), "idle_gaps": dict(gaps)}


def top(d: Dict[str, float], n: int = 10) -> List[List[object]]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def kernel_seconds(summary: Optional[Dict], needle: str) -> float:
    """Device seconds of the ops whose name holds ``needle``."""
    if not summary:
        return 0.0
    return sum(v for k, v in summary["device_ops"].items() if needle in k)


def idle_pct(summary: Optional[Dict]) -> Optional[float]:
    """100 x (1 - busy / window) of a slice that saw device activity."""
    if not summary or not summary["device_ops"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def roofline_pct(rec: Dict, cls: str, needle: str) -> Optional[float]:
    """A kernel class's counted bound for the slice's forwards over the
    device time of the kernels named by ``needle``; None without them."""
    from perfbench import counts

    t = kernel_seconds(rec["trace"], needle)
    win = rec["window"]
    n = win.stats.get("forwards_in_slice", 0)
    if t <= 0 or not n:
        return None
    work = counts.layer_work(rec["ctx"].layers, win.stats["forward_hw"])
    return 100.0 * counts.total(work, "bound_s", cls) * n / t
