"""Dynamic micro-batching for the serving path (paper Fig. 2/9), and the
LRU the engine factory keeps its models, parameters and engines in.

:class:`MicroBatcher` is the request scheduler behind an async
``submit() -> Future`` API:

  * requests are grouped by a caller-supplied bucket key (the padded
    (H, W) shape, so every image in a batch shares one engine),
  * a bucket flushes when it reaches ``max_batch`` ("full") or when its
    oldest request has waited ``max_wait_ms`` ("timeout"); among ready
    buckets the one with the oldest head request goes first,
  * admission control: ``max_pending`` bounds the total queued depth so
    overload sheds ("reject" -> :class:`QueueFull`) or backpressures
    ("block") instead of growing the queue without bound,
  * the device path is a two-stage pipeline: the DISPATCH stage queues a
    batch's work on the card (``infer_fn`` returns tensors whose kernels
    may still be running) and moves on to the next batch, while the
    COMPLETION stage waits for the pending result (``finalize_fn``: the
    copy to the host) and scatters per-item outputs to a small post
    pool.  A bounded queue of depth ``inflight`` sits between the
    stages; ``inflight=0`` collapses them into one thread.

Time is read through an injectable ``clock`` (default
``time.perf_counter``): flush deadlines and latency stats use it, and
with a clock that publishes its advances (:class:`FakeClock`) the
scheduler waits event-driven instead of on real timeouts, so
timeout-flush tests run without real sleeps.

The scheduler is model-agnostic: ``infer_fn(key, payloads) -> raw``
runs one batch, ``finalize_fn(key, raw) -> outputs`` materializes it,
and ``post_fn(payload, output) -> result`` finishes one item.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Hashable, List, Optional

from repro_torch.runtime.telemetry import SPANS, Span


class QueueFull(RuntimeError):
    """submit() rejected: the scheduler's pending queue is at
    ``max_pending`` and the admission policy is "reject"."""


class LatencyRecorder:
    """Event-driven per-request latency samples (replaces the old
    ``wait_for_samples`` sleep-polling helper).

    ``Future.set_result`` wakes ``result()`` waiters *before* running
    done-callbacks, so a latency list appended from callbacks can lag
    the final ``result()`` return.  ``track(fut)`` registers a callback
    that appends the sample and releases a semaphore; ``wait()``
    acquires once per tracked future, so when it returns every sample
    has landed — no sleep loop, no truncated tail percentiles.

    Done-callbacks run on whichever thread resolves the future
    (mb-post workers, completion stage, ...), so ``samples`` is a
    shared list: appends happen under ``_lock``, and ``wait()`` returns
    a snapshot copied under the same lock — callers can sort/percentile
    the return value while later-tracked futures keep resolving."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.samples: List[float] = []
        self._clock = clock
        self._sem = threading.Semaphore(0)
        self._lock = threading.Lock()
        self._tracked = 0

    def track(self, fut: Future, t0: Optional[float] = None) -> Future:
        """Register one future; latency is measured from ``t0`` (or from
        now) to the moment the future resolves."""
        t = self._clock() if t0 is None else t0
        with self._lock:
            self._tracked += 1

        def _record(f, t=t):
            dt = self._clock() - t
            with self._lock:
                self.samples.append(dt)
            self._sem.release()

        fut.add_done_callback(_record)
        return fut

    def wait(self, timeout_s: float = 60.0) -> List[float]:
        """Block until every tracked future's sample has landed; returns
        a snapshot of the samples (not the live list)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            n, self._tracked = self._tracked, 0
        for _ in range(n):
            left = deadline - time.monotonic()
            if left <= 0 or not self._sem.acquire(timeout=left):
                raise TimeoutError(
                    f"latency samples missing after {timeout_s}s"
                )
        with self._lock:
            return list(self.samples)


class FakeClock:
    """Deterministic manual clock for scheduler tests.

    Calling the instance reads the current fake time; :meth:`advance`
    moves it forward and notifies every subscriber — a
    :class:`MicroBatcher` built with ``clock=FakeClock()`` subscribes
    its :meth:`~MicroBatcher.wake`, so timeout flushes fire exactly when
    the test advances time, with no real sleeps anywhere."""

    def __init__(self, t0: float = 0.0):
        self._t = t0
        self._lock = threading.Lock()
        self._subs: List[Callable[[], None]] = []

    def __call__(self) -> float:
        with self._lock:
            return self._t

    def subscribe(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._subs.append(fn)

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clocks only move forward")
        with self._lock:
            self._t += dt
            t, subs = self._t, list(self._subs)
        for fn in subs:
            fn()
        return t


def round_batch(n: int, max_batch: int, mode: str = "pow2") -> int:
    """Padded batch size for ``n`` live items: "pow2" rounds up to the
    next power of two (<= max_batch) so each bucket builds at most
    log2(max_batch)+1 engine variants; "none" keeps the exact size."""
    if mode == "none":
        return n
    if mode == "pow2":
        b = 1
        while b < n:
            b *= 2
        return min(b, max_batch) if n <= max_batch else n
    raise ValueError(f"unknown batch rounding mode: {mode}")


class LRUCache:
    """Tiny LRU for engines: key -> value, least-recently-used eviction
    at ``capacity`` (0 or negative = unbounded).

    ``byte_budget`` adds a second, byte-weighted eviction rule: callers
    that know an entry's footprint pass ``put(key, value, weight=bytes)``
    and the cache also evicts LRU-first while the summed weights exceed
    the budget (0 = no byte rule).  The most-recent entry always stays —
    a single engine over budget must still be usable.  Entries stored
    without a weight count 0 bytes (capacity still bounds them).
    """

    def __init__(self, capacity: int = 8, *, byte_budget: int = 0):
        self.capacity = capacity
        self.byte_budget = byte_budget
        self._d: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._w: Dict[Hashable, int] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key: Hashable, value: Any, *, weight: int = 0) -> int:
        """Store ``key``; returns how many entries it evicted (also
        summed in ``evictions``)."""
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            self._w[key] = int(weight)
            n = len(self._d)
            while self.capacity > 0 and len(self._d) > self.capacity:
                k, _ = self._d.popitem(last=False)
                self._w.pop(k, None)
            while (self.byte_budget > 0 and len(self._d) > 1
                   and sum(self._w.values()) > self.byte_budget):
                k, _ = self._d.popitem(last=False)
                self._w.pop(k, None)
            evicted = n - len(self._d)
            self.evictions += evicted
            return evicted

    @property
    def weight_bytes(self) -> int:
        """Summed weights of resident entries."""
        with self._lock:
            return sum(self._w.values())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._d


@dataclasses.dataclass
class _Item:
    key: Hashable
    payload: Any
    future: Future
    t_submit: float
    span: Optional[Span] = None      # the request's root span
    form: Optional[Span] = None      # its open ``mb.form`` wait


def _ids(batch: Optional[Span]) -> Dict[str, Any]:
    """The batch and request ids a batch's spans carry."""
    return {} if batch is None else {"batch": batch.batch,
                                     "reqs": batch.reqs}


class MicroBatcher:
    """Async request queue -> bucketed micro-batches -> futures.

    Lifecycle: ``start()`` / ``stop()`` (or use as a context manager).
    ``stop()`` drains every pending request before returning.

    Threads: ``mb-sched`` forms batches, ``mb-dispatch`` runs
    ``infer_fn`` (it queues work on the card; ``STDService``'s engine
    also reads the CC rounds' convergence flags, which wait for the
    forward), ``mb-complete`` runs ``finalize_fn`` on the pending result
    (the wait for the rest and the copies to the host), and a small
    ``mb-post`` pool scatters per-item results.  At most ``inflight``
    dispatched-but-unfinalized batches queue between dispatch and
    completion (plus the one each stage is
    holding), which bounds device memory while letting H2D/compute/D2H
    of consecutive batches overlap.  ``inflight=0`` finalizes inline in
    the dispatch thread — the fully serialized legacy path.

    While a profile is active (``runtime/telemetry.SPANS``) each stage
    is a span: per request ``mb.form`` (submit to popped into a batch)
    and ``mb.post``; per batch ``mb.handoff`` (popped to picked up by
    the dispatch thread), ``mb.dispatch``, ``mb.inflight`` (dispatch end
    to picked up by the completion thread) and ``mb.complete``.  A
    request's root span, passed to :meth:`submit`, ends when its future
    resolves.
    """

    def __init__(
        self,
        infer_fn: Callable[[Hashable, List[Any]], Any],
        post_fn: Optional[Callable[[Any, Any], Any]] = None,
        *,
        finalize_fn: Optional[Callable[[Hashable, Any], List[Any]]] = None,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        queue_depth: int = 4,
        post_workers: int = 2,
        max_pending: int = 0,
        admission: str = "block",
        inflight: int = 1,
        clock: Callable[[], float] = time.perf_counter,
        book: Optional[Any] = None,
        max_batch_for: Optional[Callable[[Hashable], int]] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if inflight < 0:
            raise ValueError("inflight must be >= 0")
        if admission not in ("block", "reject"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.infer_fn = infer_fn
        self.post_fn = post_fn
        self.finalize_fn = finalize_fn
        self.max_batch = max_batch
        # optional per-bucket batch cap (memory-aware batching): the
        # scheduler flushes bucket ``key`` at min(max_batch,
        # max_batch_for(key)).  The callable must be cheap — it runs
        # under the scheduler condition lock (cache inside, as
        # STDService._bucket_cap does).
        self.max_batch_for = max_batch_for
        self.max_wait_s = max_wait_ms / 1e3
        self.queue_depth = queue_depth
        self.post_workers = post_workers
        self.max_pending = max_pending           # 0 = unbounded
        self.admission = admission
        self.inflight = inflight
        self.clock = clock
        # telemetry sink (runtime/telemetry.CostBook): per-batch stage
        # timing series, shed/submit counters, batch occupancy — the
        # autoscaling signals STDService.metrics_snapshot() exports
        # (live queue depth / in-flight come from stats_snapshot(), so
        # their metric names stay per-batcher even on a shared book).
        # The book carries its own leaf lock and never takes _cond or
        # _stats_lock, so recording from any point here is inversion-free.
        self.book = book
        # flush deadlines are measured on the injected clock.  A clock
        # that publishes advances (has ``subscribe``, like FakeClock) is
        # event-driven: the scheduler waits without a real timeout and
        # the clock wakes it on every advance.  Any plain callable
        # (perf_counter, monotonic, ...) is assumed to tick in real
        # seconds, so deadline deltas convert directly to wait timeouts.
        self._event_driven = hasattr(clock, "subscribe")
        if self._event_driven:
            clock.subscribe(self.wake)
        self._cond = threading.Condition()
        self._pending: Dict[Hashable, deque] = {}
        self._n_pending = 0                      # total items across buckets
        self._in_flight = 0                      # dispatched, not finalized
        self._wall_s = 0.0                       # running wall across starts
        self._stop = False
        self._running = False
        # stats are mutated from scheduler, dispatch, completion, post,
        # and caller threads — every mutation holds _stats_lock (the
        # counters are read-modify-write, so the GIL alone loses updates)
        self._stats_lock = threading.Lock()
        self.stats: Dict[str, Any] = {
            "batches": [],            # {key, n, reason, queued_ms}
            "flush_full": 0,
            "flush_timeout": 0,
            "flush_drain": 0,
            "submitted": 0,
            "batch_items": 0,         # running sum of formed-batch sizes
            "rejected": 0,            # admission-control sheds
            "finalize_short": 0,      # finalize arity errors (stranded futures)
            "pending_peak": 0,        # max queued items ever observed
            "inflight_peak": 0,       # max dispatched-but-unfinalized
            "dispatch_busy_s": 0.0,   # real time inside infer_fn
            "complete_busy_s": 0.0,   # real time inside finalize_fn
            "post_busy_s": 0.0,       # real time inside post_fn (all workers)
            "stage_occupancy": {},    # busy/wall per stage, set by stop()
        }

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._running:
            return self
        self._stop = False
        self._running = True
        self._in_flight = 0
        self._infer_q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        # dispatch -> completion handoff; its bound IS the in-flight bound
        self._done_q: "queue.Queue" = queue.Queue(
            maxsize=max(self.inflight, 1)
        )
        self._post_pool = ThreadPoolExecutor(
            self.post_workers, thread_name_prefix="mb-post"
        )
        self._sched_t = threading.Thread(
            target=self._sched_loop, name="mb-sched", daemon=True
        )
        self._dispatch_t = threading.Thread(
            target=self._dispatch_loop, name="mb-dispatch", daemon=True
        )
        self._complete_t = (
            threading.Thread(target=self._complete_loop, name="mb-complete",
                             daemon=True)
            if self.inflight > 0 else None
        )
        # occupancy is a wall-time diagnostic, always on the real clock;
        # wall accumulates across stop()/start() cycles because the busy
        # counters (and every other stat) do too
        self._t_start = time.perf_counter()
        self._sched_t.start()
        self._dispatch_t.start()
        if self._complete_t is not None:
            self._complete_t.start()
        return self

    def stop(self) -> None:
        if not self._running:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._sched_t.join()
        self._dispatch_t.join()
        if self._complete_t is not None:
            self._complete_t.join()
        self._post_pool.shutdown(wait=True)
        self._wall_s += time.perf_counter() - self._t_start
        with self._stats_lock:
            self.stats["stage_occupancy"] = {
                "dispatch": (self.stats["dispatch_busy_s"] / self._wall_s
                             if self._wall_s > 0 else 0.0),
                "complete": (self.stats["complete_busy_s"] / self._wall_s
                             if self._wall_s > 0 else 0.0),
                # the post pool runs post_workers threads, so its busy
                # time is normalized per worker to stay a [0, 1] occupancy
                "post": (self.stats["post_busy_s"]
                         / (self._wall_s * max(self.post_workers, 1))
                         if self._wall_s > 0 else 0.0),
            }
        self._running = False

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def wake(self) -> None:
        """Re-check flush deadlines now (the event-driven flush wait:
        clock owners call this after advancing a non-real clock)."""
        with self._cond:
            self._cond.notify_all()

    def stats_snapshot(self) -> Dict[str, float]:
        """Scalar stats copied under the lock, plus the live queue
        depth and in-flight count — safe to scrape while the scheduler
        runs (STDService.metrics_snapshot feeds autoscalers from
        this)."""
        with self._stats_lock:
            out = {k: float(v) for k, v in self.stats.items()
                   if isinstance(v, (int, float))}
            out["inflight"] = float(self._in_flight)
            # running counters, not an O(batches) scan — scrapes must
            # not stall the per-batch hot paths behind _stats_lock
            n_batches = len(self.stats["batches"])
            if n_batches:
                out["mean_batch"] = self.stats["batch_items"] / n_batches
                out["batch_occupancy"] = out["mean_batch"] / self.max_batch
        with self._cond:
            out["queue_depth"] = float(self._n_pending)
        return out

    # -- request side ----------------------------------------------------------
    def submit(self, key: Hashable, payload: Any,
               span: Optional[Span] = None) -> Future:
        """Enqueue one request.  At ``max_pending`` queued items the
        admission policy applies: "reject" raises :class:`QueueFull`
        immediately (load shedding), "block" waits for the scheduler to
        drain a batch (backpressure on the caller thread).  ``span``: the
        request's root span (``SPANS.request``), ended on resolve."""
        fut: Future = Future()
        with self._cond:
            if self._stop or not self._running:
                raise RuntimeError("MicroBatcher is not running")
            while self.max_pending > 0 and self._n_pending >= self.max_pending:
                if self.admission == "reject":
                    with self._stats_lock:
                        self.stats["rejected"] += 1
                    if self.book is not None:
                        self.book.incr("mb_shed")
                    raise QueueFull(
                        f"pending queue at max_pending={self.max_pending}"
                    )
                self._cond.wait()
                if self._stop or not self._running:
                    raise RuntimeError("MicroBatcher is not running")
            item = _Item(key, payload, fut, self.clock(), span,
                         SPANS.begin("mb.form", parent=span, scoped=False))
            self._pending.setdefault(key, deque()).append(item)
            self._n_pending += 1
            with self._stats_lock:
                self.stats["submitted"] += 1
                if self._n_pending > self.stats["pending_peak"]:
                    self.stats["pending_peak"] = self._n_pending
            if self.book is not None:
                self.book.incr("mb_submitted")
            self._cond.notify_all()
        return fut

    # -- scheduler thread ------------------------------------------------------
    def _cap(self, key: Hashable) -> int:
        """Effective flush size for one bucket.  When a per-bucket cap
        is wired (memory-aware batching) it REPLACES the fixed
        max_batch — a memory-light bucket may batch above it, a
        memory-heavy one is held below; <=0 falls back to max_batch."""
        if self.max_batch_for is None:
            return self.max_batch
        try:
            cap = int(self.max_batch_for(key))
        except Exception:
            return self.max_batch
        return cap if cap > 0 else self.max_batch

    def _next_batch(self):
        """Block until a bucket is ready; None once stopped AND drained.

        Every non-empty bucket is classified (full / drain-on-stop /
        timeout) and, among the ready ones, the bucket whose HEAD
        request is oldest wins.  Scanning ``self._pending`` in dict
        insertion order and taking the first ready bucket — the old
        behaviour — let an early bucket under sustained full-batch load
        starve a later bucket's timeout flush indefinitely."""
        with self._cond:
            while True:
                now = self.clock()
                ready_key, reason, deadline = None, None, None
                oldest_head = None
                for k, dq in self._pending.items():
                    if not dq:
                        continue
                    head_t = dq[0].t_submit
                    if len(dq) >= self._cap(k):
                        r = "full"
                    elif self._stop:
                        r = "drain"
                    elif head_t + self.max_wait_s <= now:
                        r = "timeout"
                    else:
                        d = head_t + self.max_wait_s
                        deadline = d if deadline is None else min(deadline, d)
                        continue
                    if oldest_head is None or head_t < oldest_head:
                        ready_key, reason, oldest_head = k, r, head_t
                if ready_key is not None:
                    dq = self._pending[ready_key]
                    n = min(len(dq), self._cap(ready_key))
                    items = [dq.popleft() for _ in range(n)]
                    self._n_pending -= n
                    self._cond.notify_all()      # wake blocked submitters
                    return ready_key, reason, items
                if self._stop:
                    return None
                # an event-driven clock wakes us on every advance; a
                # plain real-seconds clock converts the deadline delta
                # to a wait timeout
                timeout = None
                if deadline is not None and not self._event_driven:
                    timeout = max(deadline - now, 0.0)
                self._cond.wait(timeout=timeout)

    def _sched_loop(self):
        while True:
            batch = self._next_batch()
            if batch is not None:
                batch = self._formed(*batch)
            self._infer_q.put(batch)          # None = drained sentinel
            if batch is None:
                return

    @staticmethod
    def _formed(key, reason, items):
        """A popped batch with its ``mb.handoff`` span (None with the gate
        off): the items' ``mb.form`` waits end where it begins."""
        if not SPANS.on():
            return key, reason, items, None
        t = time.perf_counter_ns()
        for it in items:
            SPANS.end(it.form, t)
        handoff = SPANS.batch("mb.handoff", [it.span.req for it in items
                                             if it.span is not None], t)
        for it in items:
            if it.span is not None:
                it.span.batch = handoff.batch
        return key, reason, items, handoff

    # -- dispatch stage --------------------------------------------------------
    def _dispatch_loop(self):
        """Submit each batch's computation and hand the (possibly
        un-materialized) result to the completion stage.  With an async
        engine this thread never blocks on the device, so batch i+1's
        H2D/compute dispatch overlaps batch i's D2H in mb-complete."""
        while True:
            got = self._infer_q.get()
            if got is None:
                if self._complete_t is not None:
                    self._done_q.put(None)
                return
            key, reason, items, handoff = got
            with self._stats_lock:
                self.stats[f"flush_{reason}"] += 1
                self.stats["batch_items"] += len(items)
                self.stats["batches"].append({
                    "key": key, "n": len(items), "reason": reason,
                    "queued_ms": (self.clock() - items[0].t_submit) * 1e3,
                })
            if self.book is not None:
                self.book.observe("mb_batch_occupancy",
                                  len(items) / self.max_batch)
            t0 = time.perf_counter_ns()
            SPANS.end(handoff, t0)
            span = SPANS.begin("mb.dispatch", t0, **_ids(handoff))
            try:
                raw = self.infer_fn(key, [it.payload for it in items])
            except Exception as e:
                for it in items:
                    self._fail(it, e)
                continue
            finally:
                t1 = time.perf_counter_ns()
                SPANS.end(span, t1)
                dt = (t1 - t0) * 1e-9
                with self._stats_lock:
                    self.stats["dispatch_busy_s"] += dt
                if self.book is not None:
                    self.book.observe("mb_dispatch_s", dt)
            with self._stats_lock:
                self._in_flight += 1
                if self._in_flight > self.stats["inflight_peak"]:
                    self.stats["inflight_peak"] = self._in_flight
            if self._complete_t is None:
                self._complete_one(key, items, raw, handoff)
            else:
                inflight = SPANS.begin("mb.inflight", t1, scoped=False,
                                       **_ids(handoff))
                # bounded: backpressure
                self._done_q.put((key, items, raw, handoff, inflight))

    # -- completion stage ------------------------------------------------------
    def _complete_loop(self):
        while True:
            got = self._done_q.get()
            if got is None:
                return
            self._complete_one(*got)

    def _complete_one(self, key, items, raw, handoff=None, inflight=None):
        t0 = time.perf_counter_ns()
        SPANS.end(inflight, t0)
        span = SPANS.begin("mb.complete", t0, **_ids(handoff))
        try:
            outs = raw if self.finalize_fn is None \
                else self.finalize_fn(key, raw)
            n_out = len(outs)
        except Exception as e:
            for it in items:
                self._fail(it, e)
            return
        finally:
            t1 = time.perf_counter_ns()
            SPANS.end(span, t1)
            dt = (t1 - t0) * 1e-9
            with self._stats_lock:
                self._in_flight -= 1
                self.stats["complete_busy_s"] += dt
            if self.book is not None:
                self.book.observe("mb_complete_s", dt)
        if n_out < len(items):
            # a finalize returning fewer outputs than live items would
            # silently strand the tail futures (zip stops early) and
            # hang their callers forever — fail them loudly instead.
            # MORE outputs than items is legal: the batch axis may be
            # padded, and zip ignores the padding rows.
            err = RuntimeError(
                f"finalize_fn returned {n_out} outputs for {len(items)} "
                f"batch items (key={key!r}); stranded futures failed"
            )
            with self._stats_lock:
                self.stats["finalize_short"] += 1
            if self.book is not None:
                self.book.incr("mb_finalize_short")
            for it in items[n_out:]:
                self._fail(it, err)
            items = items[:n_out]
        for it, out in zip(items, outs):
            if self.post_fn is None:
                self._resolve(it, out)
            else:
                self._post_pool.submit(self._post_one, it, out)

    def _post_one(self, item: _Item, out: Any):
        t0 = time.perf_counter_ns()
        span = SPANS.begin("mb.post", t0, parent=item.span)
        try:
            result = self.post_fn(item.payload, out)
        except Exception as e:
            self._fail(item, e)
            return
        finally:
            t1 = time.perf_counter_ns()
            SPANS.end(span, t1)
            with self._stats_lock:
                self.stats["post_busy_s"] += (t1 - t0) * 1e-9
        self._resolve(item, result)

    @staticmethod
    def _resolve(item: _Item, result: Any):
        # the request's span ends BEFORE set_result, so a caller that
        # reads result() finds it recorded
        SPANS.end(item.span)
        item.future.set_result(result)

    @staticmethod
    def _fail(item: _Item, err: BaseException):
        SPANS.end(item.span)
        item.future.set_exception(err)
