"""Telemetry: the measurement store every serving layer writes into.

:class:`CostBook` keeps engine step times keyed by ``(bucket_hw, batch,
plan_kind)`` with a ``stage`` (``"dispatch"``: the engine-call wall that
``runtime/executor.EngineFactory`` records, launches and the CC rounds'
convergence reads included, so on the card it waits for the forward;
``"step"``: dispatch through the copy to the host, recorded by
``launch/serve.STDService``; ``"postprocess"``: one image's box decode),
a ``precision`` and a ``model``, and named series, counters and gauges
from ``launch/batching.MicroBatcher`` and the engine factory.  Every
series keeps a count, an EWMA and a bounded window of recent samples for
p50/p99; all mutations hold one lock.  :meth:`CostBook.snapshot` and
:func:`prometheus_text` export it all in a flat, scrapeable form (labels
embedded Prometheus-style in the metric names), which
``STDService.metrics_snapshot()`` serves.

Spans: :data:`SPANS`, one process-wide :class:`SpanLog`, records timed
intervals at the serving and engine layers' boundaries (name, start,
end, thread, own id, parent id, and the request or batch they belong
to) while a ``torch.profiler`` profile is active, and nothing otherwise.
Where a book series and a span time the same interval, one pair of
clock reads feeds both.

Calibration: the analytic step cost (``runtime/planner.step_cost``) is
linear in five of the :class:`~repro_torch.runtime.planner.CostParams`
constants, so :func:`fit_cost_params` solves for them by least squares
from measured :class:`StepMeasurement` rows; :func:`save_cost_params` and
:func:`load_cost_params` round-trip the fit through JSON exactly, in the
JAX package's format.  The planner reads the book duck-typed
(``MeasuredCost``) and this module imports the planner only inside the
calibration functions, so the layering stays one-directional.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import threading
import time
from collections import deque
from typing import (Any, Dict, Iterable, List, NamedTuple, Optional,
                    Sequence, Tuple)

from torch.autograd import profiler as _autograd_profiler

StepKey = Tuple[Tuple[int, int], int, str]


class _Series:
    """Count + EWMA + bounded recent-sample window for one metric.

    The window is a deterministic sliding reservoir (last ``maxlen``
    samples), so percentile queries need no randomness and tests can
    pin exact values."""

    __slots__ = ("count", "ewma", "total", "window")

    def __init__(self, window: int):
        self.count = 0
        self.ewma: Optional[float] = None
        self.total = 0.0
        self.window: deque = deque(maxlen=window)

    def add(self, value: float, alpha: float) -> None:
        self.count += 1
        self.total += value
        self.ewma = (value if self.ewma is None
                     else alpha * value + (1.0 - alpha) * self.ewma)
        self.window.append(value)

    def percentile(self, q: float) -> Optional[float]:
        if not self.window:
            return None
        xs = sorted(self.window)
        i = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[i]


class CostBook:
    """Lock-guarded measurement store: engine step times keyed by
    ``(bucket_hw, batch, plan_kind)`` and named scheduler/service
    series, each with count / EWMA / p50 / p99.

    Writers (engine wrappers, scheduler stages, service completion)
    call :meth:`record_step`, :meth:`observe`, :meth:`incr`,
    :meth:`set_gauge` from their own threads; every mutation and every
    read holds ``_lock`` — the counters are read-modify-write, so the
    GIL alone would lose updates."""

    def __init__(self, *, ewma_alpha: float = 0.25, window: int = 256,
                 warmup: int = 1,
                 labels: Optional[Dict[str, str]] = None):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if warmup < 0:
            raise ValueError("warmup must be >= 0")
        self.ewma_alpha = ewma_alpha
        self.window = window
        # constant label set (e.g. {"replica": "r0"}) embedded in every
        # snapshot metric name, so N per-replica books aggregate into
        # one scrape without the named counters/gauges clobbering each
        # other
        self.labels: Dict[str, str] = dict(labels or {})
        # the first call of an engine builds its model, plans its
        # memory and (on the card) loads the kernels, a one-off that
        # would poison a millisecond-scale EWMA — skip the first
        # ``warmup`` samples per (combo, stage)
        self.warmup = warmup
        self._lock = threading.Lock()
        # step series key: (StepKey, stage, precision, model)
        self._steps: Dict[Tuple[StepKey, str, str, str], _Series] = {}
        self._warm: Dict[Tuple[StepKey, str, str, str], int] = {}
        self._series: Dict[str, _Series] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    @staticmethod
    def _step_key(hw, batch, kind) -> StepKey:
        return ((int(hw[0]), int(hw[1])), int(batch), str(kind))

    # -- writers ---------------------------------------------------------------
    def record_step(self, hw: Tuple[int, int], batch: int, kind: str,
                    seconds: float, *, stage: str = "step",
                    precision: str = "f32",
                    model: str = "pixellink") -> None:
        """One engine step's wall time for a (bucket, batch, plan_kind)
        combo.  ``stage="dispatch"`` is the engine-call wall
        (executor); ``stage="step"`` is dispatch through the copy to the
        host.  ``precision`` keeps f32 and bfp walls in separate series
        (they run different kernels); ``model`` does the same across
        detection heads."""
        key = (self._step_key(hw, batch, kind), stage, str(precision),
               str(model))
        with self._lock:
            warm = self._warm.get(key, 0)
            if warm < self.warmup:
                self._warm[key] = warm + 1
                return
            s = self._steps.get(key)
            if s is None:
                s = self._steps[key] = _Series(self.window)
            s.add(float(seconds), self.ewma_alpha)

    def observe(self, name: str, value: float) -> None:
        """One sample of a named series (stage timings, occupancy...)."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = self._series[name] = _Series(self.window)
            s.add(float(value), self.ewma_alpha)

    def incr(self, name: str, n: float = 1.0) -> None:
        """Monotonic counter (sheds, submissions...)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + n

    def set_gauge(self, name: str, value: float) -> None:
        """Point-in-time gauge (queue depth, in-flight batches...)."""
        with self._lock:
            self._gauges[name] = float(value)

    # -- readers ---------------------------------------------------------------
    def step_count(self, hw, batch, kind, *, stage: str = "step",
                   precision: str = "f32",
                   model: str = "pixellink") -> int:
        key = (self._step_key(hw, batch, kind), stage, str(precision),
               str(model))
        with self._lock:
            s = self._steps.get(key)
            return s.count if s is not None else 0

    def step_ewma(self, hw, batch, kind, *, stage: str = "step",
                  precision: str = "f32",
                  model: str = "pixellink") -> Optional[float]:
        key = (self._step_key(hw, batch, kind), stage, str(precision),
               str(model))
        with self._lock:
            s = self._steps.get(key)
            return s.ewma if s is not None else None

    def step_percentile(self, hw, batch, kind, q: float, *,
                        stage: str = "step",
                        precision: str = "f32",
                        model: str = "pixellink") -> Optional[float]:
        key = (self._step_key(hw, batch, kind), stage, str(precision),
               str(model))
        with self._lock:
            s = self._steps.get(key)
            return s.percentile(q) if s is not None else None

    def step_total(self, hw, batch, kind, *, stage: str = "step",
                   precision: str = "f32",
                   model: str = "pixellink") -> float:
        """Cumulative wall seconds for one combo — the busy-time view
        (e.g. summing ``stage="postprocess"`` walls across buckets gives
        each postprocess mode's total tail cost in an A/B)."""
        key = (self._step_key(hw, batch, kind), stage, str(precision),
               str(model))
        with self._lock:
            s = self._steps.get(key)
            return s.total if s is not None else 0.0

    def step_keys(self, *, stage: str = "step",
                  precision: str = "f32",
                  model: str = "pixellink") -> List[StepKey]:
        """Every (hw, batch, kind) combo with at least one sample at
        this (stage, precision, model)."""
        with self._lock:
            return sorted(k for k, st, pr, md in self._steps
                          if st == stage and pr == precision
                          and md == model)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def gauge(self, name: str) -> Optional[float]:
        with self._lock:
            return self._gauges.get(name)

    def snapshot(self, prefix: str = "std_") -> Dict[str, float]:
        """Flat scrapeable ``{metric_name: value}`` view of everything
        in the book.  Labels are embedded Prometheus-style in the name,
        so the dict stays flat: e.g.
        ``std_step_ewma_s{bucket="128x64",batch="4",plan="row_band",
        stage="step"}``.  A book constructed with ``labels=`` gets them
        merged into every name (see :func:`relabel`), so per-replica
        books stay disjoint when a router aggregates N snapshots."""
        out: Dict[str, float] = {}
        with self._lock:
            for ((hw, batch, kind), stage, precision, model), s in sorted(
                    self._steps.items()):
                # the f32/pixellink defaults keep the historical label
                # shape; other precisions/models append their own labels
                # so scrapers can tell them apart
                prec = ("" if precision == "f32"
                        else f',precision="{precision}"')
                mdl = ("" if model == "pixellink"
                       else f',model="{model}"')
                lbl = (f'{{bucket="{hw[0]}x{hw[1]}",batch="{batch}",'
                       f'plan="{kind}",stage="{stage}"{prec}{mdl}}}')
                out[f"{prefix}step_count{lbl}"] = float(s.count)
                if s.ewma is not None:
                    out[f"{prefix}step_ewma_s{lbl}"] = s.ewma
                p50, p99 = s.percentile(50), s.percentile(99)
                if p50 is not None:
                    out[f"{prefix}step_p50_s{lbl}"] = p50
                    out[f"{prefix}step_p99_s{lbl}"] = p99
            for name, s in sorted(self._series.items()):
                out[f"{prefix}{name}_count"] = float(s.count)
                if s.ewma is not None:
                    out[f"{prefix}{name}_ewma"] = s.ewma
                p50, p99 = s.percentile(50), s.percentile(99)
                if p50 is not None:
                    out[f"{prefix}{name}_p50"] = p50
                    out[f"{prefix}{name}_p99"] = p99
            for name, v in sorted(self._counters.items()):
                out[f"{prefix}{name}_total"] = v
            for name, v in sorted(self._gauges.items()):
                out[f"{prefix}{name}"] = v
        if self.labels:
            out = relabel(out, **self.labels)
        return out


def _merge_labels(name: str, suffix: str) -> str:
    """Insert a rendered ``k="v",...`` label suffix into a metric name,
    merging into an existing ``{...}`` group or appending a new one."""
    if not suffix:
        return name
    if name.endswith("}"):
        return f"{name[:-1]},{suffix}}}"
    return f"{name}{{{suffix}}}"


def relabel(metrics: Dict[str, float], **labels: str) -> Dict[str, float]:
    """Embed constant labels into every metric name of a flat snapshot
    (names already carrying one of the label keys keep their value).
    This is the per-replica aggregation seam: N replica snapshots
    relabel to disjoint name sets and merge into one scrape without
    gauge clobbering."""
    out: Dict[str, float] = {}
    for name, v in metrics.items():
        missing = {k: val for k, val in labels.items()
                   if f'{k}="' not in name}
        suffix = ",".join(f'{k}="{val}"'
                          for k, val in sorted(missing.items()))
        out[_merge_labels(name, suffix)] = v
    return out


def prometheus_text(metrics: Dict[str, float]) -> str:
    """Render a flat ``{metric_name: value}`` dict (labels already
    embedded in names) as Prometheus text-exposition lines."""
    lines = []
    for name in sorted(metrics):
        v = metrics[name]
        lines.append(f"{name} {float(v):.9g}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- spans ---------------------------------------------------------------------

class SpanRecord(NamedTuple):
    """One finished span.  ``start`` and ``end`` are ns: on
    ``time.perf_counter_ns()`` in the ring, on the device trace's clock
    (Unix epoch, as kineto events' ``start_ns()``) from
    :meth:`SpanLog.records`.  ``req`` and ``batch`` are the request and
    batch the span belongs to, ``reqs`` a batch's request ids; ``counts``
    what the span counted (the CC rounds of an engine call, a build's
    evictions)."""

    name: str
    start: int
    end: int
    tid: int
    id: int
    parent: Optional[int]
    req: Optional[int]
    batch: Optional[int]
    reqs: Tuple[int, ...]
    counts: Dict[str, int]


class Span:
    """An open span, as :meth:`SpanLog.begin` returns it while tracing."""

    __slots__ = ("name", "start", "tid", "id", "parent", "req", "batch",
                 "reqs", "range")


class _Scope:
    """``with log.span(name):`` while tracing."""

    __slots__ = ("log", "name", "parent", "span")

    def __init__(self, log: "SpanLog", name: str, parent: Optional[Span]):
        self.log, self.name, self.parent = log, name, parent

    def __enter__(self) -> Optional[Span]:
        self.span = self.log.begin(self.name, parent=self.parent)
        return self.span

    def __exit__(self, *exc) -> None:
        self.log.end(self.span)


_OFF = contextlib.nullcontext()        # ``span()`` with the gate off


class SpanLog:
    """A bounded ring of finished spans, kept in memory and read after
    the run.

    **The gate**: spans are recorded only while a ``torch.profiler``
    profile is active (``torch.autograd.profiler._is_profiler_enabled``, a
    module global every thread sees); with it off, :meth:`begin` and
    :meth:`span` cost one attribute read and record nothing.

    A *scoped* span opens and closes on one thread, nests on that
    thread's stack (its parent is the span open there, unless one is
    given) and opens a ``torch.profiler.record_function`` range of its
    name, so that a profiler recording every thread names each device
    idle gap by the program span open then.  An *unscoped* span is a
    wait that starts on one thread and ends on another (a request's life,
    a queue); it opens no range.  A span shares the request and batch
    ids of its parent, or of the span open on its thread.

    Counts: :meth:`count` adds to this thread's tally, ungated, and
    :meth:`take` hands the tally to whoever closes the enclosing work
    (an engine call passes it to its book and to its span's ``counts``).
    """

    def __init__(self, capacity: int = 1 << 16):
        self._ring: deque = deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._local = threading.local()
        # one anchor pairs the span clock with the device trace's
        pc, unix = time.perf_counter_ns(), time.time_ns()
        self._offset = unix - pc

    @staticmethod
    def on() -> bool:
        """Whether spans are being recorded (a profile is active)."""
        return _autograd_profiler._is_profiler_enabled

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def begin(self, name: str, start: Optional[int] = None, *,
              parent: Optional[Span] = None, req: Optional[int] = None,
              batch: Optional[int] = None, reqs: Sequence[int] = (),
              scoped: bool = True) -> Optional[Span]:
        """Open a span at ``start`` (``perf_counter_ns``; now if None);
        None with the gate off.  Ids not given come from ``parent``, else
        from the span open on this thread."""
        if not _autograd_profiler._is_profiler_enabled:
            return None
        stack = self._stack()
        ctx = parent if parent is not None else (stack[-1] if stack
                                                 else None)
        sp = Span()
        sp.name = name
        sp.tid = threading.get_ident()
        sp.id = next(self._ids)
        sp.parent = ctx.id if ctx is not None and (
            scoped or parent is not None) else None
        sp.req = req if req is not None else (ctx.req if ctx else None)
        sp.batch = batch if batch is not None else (
            ctx.batch if ctx else None)
        sp.reqs = tuple(reqs) if reqs else (ctx.reqs if ctx else ())
        sp.range = None
        if scoped:
            stack.append(sp)
            sp.range = _autograd_profiler.record_function(name)
            sp.range.__enter__()
        sp.start = time.perf_counter_ns() if start is None else start
        return sp

    def request(self, name: str) -> Optional[Span]:
        """Open the unscoped root span of a new request: its id is the
        request id every span the request causes carries."""
        sp = self.begin(name, scoped=False)
        if sp is not None:
            sp.req = sp.id
        return sp

    def batch(self, name: str, reqs: Sequence[int],
              start: Optional[int] = None) -> Optional[Span]:
        """Open the unscoped first span of a new batch of requests
        ``reqs``: its id is the batch id."""
        sp = self.begin(name, start, reqs=reqs, scoped=False)
        if sp is not None:
            sp.batch = sp.id
        return sp

    def end(self, span: Optional[Span], end: Optional[int] = None,
            counts: Optional[Dict[str, int]] = None) -> None:
        """Close ``span`` at ``end`` (now if None) and record it."""
        if span is None:
            return
        t = time.perf_counter_ns() if end is None else end
        if span.range is not None:
            stack = self._stack()
            if stack and stack[-1] is span:
                stack.pop()
            elif span in stack:
                stack.remove(span)
            span.range.__exit__(None, None, None)
        self._ring.append(SpanRecord(
            span.name, span.start, t, span.tid, span.id, span.parent,
            span.req, span.batch, span.reqs, dict(counts or {})))

    def span(self, name: str, parent: Optional[Span] = None):
        """``with SPANS.span(name):`` a scoped span around the block."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Scope(self, name, parent)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to this thread's tally of ``name``."""
        tally = getattr(self._local, "tally", None)
        if tally is None:
            tally = self._local.tally = {}
        tally[name] = tally.get(name, 0) + n

    def take(self) -> Dict[str, int]:
        """This thread's tally since the last take, emptied."""
        tally = getattr(self._local, "tally", None)
        self._local.tally = {}
        return tally or {}

    def records(self) -> List[SpanRecord]:
        """The ring's spans, oldest first, on the device trace's clock."""
        off = self._offset
        return [r._replace(start=r.start + off, end=r.end + off)
                for r in self._ring.copy()]

    def clear(self) -> None:
        self._ring.clear()


# the process's span log: the serving and engine layers write into it
SPANS = SpanLog()


# -- calibration ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepMeasurement:
    """One calibration row: the cost-model inputs of a measured step.

    ``flops``/``halo_bytes``/``halo_layers`` come from the bucket's
    PlanFeatures, ``kind``/``batch``/``data_n``/``model_n`` describe
    how it ran, ``seconds`` is the measured (blocked-until-ready) step
    wall time."""

    flops: float
    halo_bytes: float
    halo_layers: int
    kind: str
    batch: int
    data_n: int
    model_n: int
    seconds: float


def _design_row(m: StepMeasurement) -> List[float]:
    """The analytic step cost is linear in
    ``x = (1/peak_flops, 1/ici_bw, dispatch_overhead_s,
    collective_overhead_s, halo_launch_s)``; this is one row of the
    design matrix, mirroring runtime/planner.step_cost term for term."""
    from repro_torch.runtime.planner import PLAN_KINDS, _BANDED, padded_batch

    if m.kind not in PLAN_KINDS:
        raise ValueError(f"unknown plan kind {m.kind!r}")
    dn = m.data_n if m.kind in ("data_parallel", "grid") else 1
    mn = m.model_n if m.kind in _BANDED else 1
    local_b = padded_batch(m.batch, dn) // dn
    return [
        m.flops * local_b / mn,                       # 1/peak_flops
        m.halo_bytes * local_b if mn > 1 else 0.0,    # 1/ici_bw
        1.0,                                          # dispatch_overhead_s
        float((dn > 1) + (mn > 1)),                   # collective_overhead_s
        float(m.halo_layers) if mn > 1 else 0.0,      # halo_launch_s
    ]


def fit_cost_params(measurements: Iterable[StepMeasurement], *,
                    base: Optional[Any] = None):
    """Least-squares fit of the CostParams constants from measured step
    times.  Columns the sweep never exercised (e.g. no banded combos on
    a unit mesh leave every halo entry zero) are unidentifiable and
    keep ``base``'s value (default: the napkin CostParams()); fitted
    rate constants are clamped positive so 1/x stays finite."""
    import numpy as np

    from repro_torch.runtime.planner import CostParams

    base = base if base is not None else CostParams()
    measurements = list(measurements)      # may be a single-pass iterable
    rows = [_design_row(m) for m in measurements]
    if not rows:
        return base
    y = np.asarray([m.seconds for m in measurements], dtype=np.float64)
    A = np.asarray(rows, dtype=np.float64)
    identifiable = np.any(A != 0.0, axis=0)
    x = np.zeros(A.shape[1])
    if identifiable.any():
        sol, *_ = np.linalg.lstsq(A[:, identifiable], y, rcond=None)
        x[identifiable] = sol
    base_x = np.asarray([
        1.0 / base.peak_flops, 1.0 / base.ici_bw,
        base.dispatch_overhead_s, base.collective_overhead_s,
        base.halo_launch_s,
    ])
    # unidentifiable -> base; identifiable but non-positive (noise drove
    # the fit through zero) -> base as well, never a negative rate
    for i in range(5):
        if not identifiable[i] or x[i] <= 0.0:
            x[i] = base_x[i]
    return CostParams(
        peak_flops=float(1.0 / x[0]),
        ici_bw=float(1.0 / x[1]),
        dispatch_overhead_s=float(x[2]),
        collective_overhead_s=float(x[3]),
        halo_launch_s=float(x[4]),
    )


def cost_params_to_dict(params) -> Dict[str, float]:
    return {k: float(v) for k, v in dataclasses.asdict(params).items()}


def cost_params_from_dict(d: Dict[str, float]):
    from repro_torch.runtime.planner import CostParams

    fields = {f.name for f in dataclasses.fields(CostParams)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"unknown CostParams fields {sorted(unknown)}")
    return CostParams(**{k: float(v) for k, v in d.items()})


def save_cost_params(params, path: str, *,
                     measurements: Sequence[StepMeasurement] = (),
                     meta: Optional[Dict[str, Any]] = None) -> None:
    """Fitted params (+ provenance: the measurement rows and free-form
    meta) to JSON; :func:`load_cost_params` round-trips exactly."""
    doc = {
        "cost_params": cost_params_to_dict(params),
        "measurements": [dataclasses.asdict(m) for m in measurements],
        "meta": dict(meta or {}),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def load_cost_params(path: str):
    """CostParams back from a ``save_cost_params`` JSON file (also
    accepts a bare ``{field: value}`` dict for hand-written files)."""
    with open(path) as f:
        doc = json.load(f)
    d = doc.get("cost_params", doc) if isinstance(doc, dict) else doc
    return cost_params_from_dict(d)
