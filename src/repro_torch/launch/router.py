"""The serving fleet: N replicated STDServices behind a
telemetry-driven router (the paper's deployed, stable detection
service rather than one service's throughput).

Two layers:

  * :class:`ServiceReplica` wraps one service (anything with ``submit()
    -> Future`` and ``start_batched()`` / ``stop_batched()``: an
    ``STDService`` or an in-process simulator) and its scrape surface.
    It names the service's :class:`~repro_torch.runtime.telemetry.
    CostBook` with a ``{"replica": name}`` label, so N books aggregate
    into one snapshot without gauges clobbering each other; counts its
    outstanding requests through done-callbacks; feeds completed
    requests' latencies to a :class:`~repro_torch.runtime.
    fault_tolerance.Watchdog` (the replica's health); and runs its own
    online refit (:meth:`ServiceReplica.refit`: live book ->
    ``StepMeasurement`` rows -> ``fit_cost_params`` ->
    ``planner.set_params``).

  * :class:`Router` places each request on one replica:

      - ``round_robin``   cycle through the healthy replicas,
      - ``least_loaded``  fewest queued + in-flight requests (the
                          service's ``queue_gauges()`` when it has them,
                          else the replica's outstanding count),
      - ``p99``           least ``(load + 1) * step_p99``, the tail from
                          the replica book's p99 step windows, so a
                          slower replica takes proportionally less.

    Deadline-class admission: a request is ``"interactive"`` or
    ``"batch"``; batch requests stop being admitted at
    ``batch_threshold`` outstanding, interactive ones at
    ``max_outstanding``, so under overload batch traffic sheds first
    (:class:`~repro_torch.launch.batching.QueueFull`).

    Health: a replica whose watchdog is in an incident streak
    (``consecutive >= unhealthy_after``) takes no placements except a
    probe every ``probe_every`` placements, which keeps its watchdog
    fed; once a sustained slowdown becomes its baseline the streak
    resets and it rejoins.

    The control loop: with ``refit_interval_s`` the router calls every
    replica's :meth:`~ServiceReplica.refit` once per interval, inside
    ``FakeClock.advance()`` on a clock that publishes its advances
    (``launch/batching.FakeClock.subscribe``: deterministic, no sleeps)
    and on a background thread on a real clock.

The whole fleet runs in one process.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.launch.batching import QueueFull
from repro_torch.runtime.fault_tolerance import Watchdog
from repro_torch.runtime.telemetry import (
    StepMeasurement,
    fit_cost_params,
    relabel,
)

POLICIES = ("round_robin", "p99", "least_loaded")
DEADLINE_CLASSES = ("interactive", "batch")


class ServiceReplica:
    """One service instance plus its scrape/health/refit surface.

    ``service`` needs ``submit(payload) -> Future``; ``start_batched``
    / ``stop_batched``, ``book``, ``planner``, ``queue_gauges``,
    ``precision``, ``model_name`` and ``_plan_features`` are all
    optional and duck-typed, so simulators and STDService plug in the
    same way."""

    def __init__(self, name: str, service: Any, *,
                 features_fn: Optional[Callable[[Tuple[int, int]], Any]]
                 = None,
                 watchdog: Optional[Watchdog] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.name = str(name)
        self.service = service
        self.clock = clock
        self.book = getattr(service, "book", None)
        if self.book is not None and hasattr(self.book, "labels"):
            # name the book so N replicas' metrics stay disjoint in one
            # aggregated scrape (an explicit label set on the book wins)
            self.book.labels.setdefault("replica", self.name)
        self.features_fn = (features_fn if features_fn is not None
                            else getattr(service, "_plan_features", None))
        # request-latency watchdog = replica health: warmup absorbs
        # compile-time outliers, adapt_after lets a permanently slower
        # replica become its own baseline and rejoin the fleet
        self.watchdog = (watchdog if watchdog is not None
                         else Watchdog(threshold=3.0, ema=0.5,
                                       warmup_steps=2, adapt_after=3))
        self._lock = threading.Lock()
        self._outstanding = 0
        self._completed = 0
        self._step = 0

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "ServiceReplica":
        fn = getattr(self.service, "start_batched", None)
        if fn is not None:
            fn()
        return self

    def stop(self) -> None:
        fn = getattr(self.service, "stop_batched", None)
        if fn is not None:
            fn()

    # -- request path ----------------------------------------------------------
    def submit(self, payload: Any) -> Future:
        t0 = self.clock()
        fut = self.service.submit(payload)
        with self._lock:
            self._outstanding += 1

        def _done(f: Future) -> None:
            dt = self.clock() - t0
            with self._lock:
                self._outstanding -= 1
                self._completed += 1
                self._step += 1
                step = self._step
            # errored requests are not latency evidence; the watchdog
            # only learns from completed ones
            if f.exception() is None:
                self.watchdog.observe(step, dt)

        fut.add_done_callback(_done)
        return fut

    # -- scoring signals -------------------------------------------------------
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def load(self) -> float:
        """Queued + in-flight work: the service's own scheduler gauges
        (``queue_gauges()``) when it runs a MicroBatcher, else the
        router-side outstanding count (exact for simulators)."""
        gauges = getattr(self.service, "queue_gauges", None)
        if gauges is not None:
            g = gauges()
            return float(g.get("queue_depth", 0.0)
                         + g.get("inflight", 0.0))
        return float(self.outstanding())

    def step_p99(self) -> Optional[float]:
        """Mean of the book's p99 step walls across every measured
        (bucket, batch, plan) combo for this service's precision/model —
        one scalar tail estimate per replica; None until anything is
        measured."""
        book = self.book
        if book is None:
            return None
        precision = getattr(self.service, "precision", "f32")
        model = getattr(self.service, "model_name", "pixellink")
        vals = []
        for hw, batch, kind in book.step_keys(stage="step",
                                              precision=precision,
                                              model=model):
            p = book.step_percentile(hw, batch, kind, 99, stage="step",
                                     precision=precision, model=model)
            if p is not None:
                vals.append(p)
        if not vals:
            return None
        return sum(vals) / len(vals)

    def healthy(self, unhealthy_after: int) -> bool:
        return self.watchdog.consecutive < unhealthy_after

    # -- online refit ----------------------------------------------------------
    def refit(self) -> Optional[Any]:
        """Fit CostParams from this replica's live book and swap them
        into its planner (``Planner.set_params``): calibration, run
        online.  Returns the
        fitted params, or None when the replica has no planner, no
        book, no features, or no measurements yet."""
        planner = getattr(self.service, "planner", None)
        book = self.book
        if planner is None or book is None or self.features_fn is None:
            return None
        precision = getattr(self.service, "precision", "f32")
        model = getattr(self.service, "model_name", "pixellink")
        rows: List[StepMeasurement] = []
        for hw, batch, kind in book.step_keys(stage="step",
                                              precision=precision,
                                              model=model):
            seconds = book.step_ewma(hw, batch, kind, stage="step",
                                     precision=precision, model=model)
            if seconds is None:
                continue
            f = self.features_fn(hw)
            rows.append(StepMeasurement(
                flops=f.flops, halo_bytes=f.halo_bytes,
                halo_layers=f.halo_layers, kind=kind, batch=batch,
                data_n=planner.data_n, model_n=planner.model_n,
                seconds=seconds,
            ))
        if not rows:
            return None
        fitted = fit_cost_params(rows, base=planner.params)
        planner.set_params(fitted)
        return fitted

    # -- scrape ----------------------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, float]:
        """The service's full snapshot plus replica-level gauges, every
        metric name carrying this replica's label (names the book
        already labeled keep theirs)."""
        out: Dict[str, float] = {}
        snap_fn = getattr(self.service, "metrics_snapshot", None)
        if snap_fn is not None:
            out.update(snap_fn())
        elif self.book is not None:
            out.update(self.book.snapshot())
        with self._lock:
            out["std_replica_outstanding"] = float(self._outstanding)
            out["std_replica_completed_total"] = float(self._completed)
        out["std_replica_watchdog_streak"] = float(
            self.watchdog.consecutive)
        out["std_replica_watchdog_incidents_total"] = float(
            len(self.watchdog.incidents))
        return relabel(out, replica=self.name)


class Router:
    """Places requests across replicas; see the module docstring for
    the policy, admission, health, and control-loop semantics."""

    def __init__(self, replicas: List[ServiceReplica], *,
                 policy: str = "p99",
                 max_outstanding: int = 0,
                 batch_threshold: Optional[int] = None,
                 unhealthy_after: int = 3,
                 probe_every: int = 8,
                 refit_interval_s: Optional[float] = None,
                 default_step_s: float = 0.0,
                 clock: Callable[[], float] = time.perf_counter):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {names}")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"expected one of {POLICIES}")
        if max_outstanding < 0 or (batch_threshold is not None
                                   and batch_threshold < 0):
            raise ValueError("outstanding bounds must be >= 0")
        self.replicas = list(replicas)
        self.policy = policy
        self.max_outstanding = max_outstanding        # 0 = unbounded
        # batch-class admission stops at this total outstanding depth
        # (default: half the cap), interactive continues to the cap —
        # that ordering is the deadline-class shed policy
        self.batch_threshold = (
            batch_threshold if batch_threshold is not None
            else max_outstanding // 2)
        self.unhealthy_after = unhealthy_after
        self.probe_every = probe_every
        self.refit_interval_s = refit_interval_s
        # an unmeasured replica's tail estimate under the p99 policy:
        # 0.0 makes fresh replicas look free, so they get explored (and
        # measured) before scoring starts discriminating
        self.default_step_s = default_step_s
        self.clock = clock
        self._lock = threading.Lock()
        self.stats: Dict[str, Any] = {
            "submitted": {c: 0 for c in DEADLINE_CLASSES},
            "shed": {c: 0 for c in DEADLINE_CLASSES},
            "placed": {r.name: 0 for r in self.replicas},
            "probes": 0,
            "refits": 0,
        }
        self._outstanding = 0
        self._rr = 0
        self._probe_rr = 0
        self._since_probe = 0
        self._started = False
        self._next_refit: Optional[float] = None
        self._refit_thread: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()
        self._event_driven = hasattr(clock, "subscribe")
        if self._event_driven and refit_interval_s is not None:
            clock.subscribe(self._on_tick)

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "Router":
        if self._started:
            return self
        for r in self.replicas:
            r.start()
        self._started = True
        if self.refit_interval_s is not None:
            self._next_refit = self.clock() + self.refit_interval_s
            if not self._event_driven:
                self._stop_ev.clear()
                self._refit_thread = threading.Thread(
                    target=self._refit_loop, name="router-refit",
                    daemon=True)
                self._refit_thread.start()
        return self

    def stop(self) -> None:
        if not self._started:
            return
        self._started = False
        self._stop_ev.set()
        if self._refit_thread is not None:
            self._refit_thread.join()
            self._refit_thread = None
        for r in self.replicas:
            r.stop()

    def __enter__(self) -> "Router":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- control loop ----------------------------------------------------------
    def _refit_loop(self) -> None:
        while not self._stop_ev.wait(self.refit_interval_s):
            self.refit_now()

    def _on_tick(self) -> None:
        """Event-driven control loop: runs synchronously inside a
        FakeClock ``advance()``, so refits land at deterministic fake
        times."""
        if not self._started or self._next_refit is None:
            return
        now = self.clock()
        while now >= self._next_refit:
            self._next_refit += self.refit_interval_s
            self.refit_now()

    def refit_now(self) -> Dict[str, Any]:
        """Re-fit every replica's CostParams from its live book and
        swap them into its planner.  Returns {replica_name: params} for
        the replicas that had measurements."""
        fitted = {}
        for r in self.replicas:
            p = r.refit()
            if p is not None:
                fitted[r.name] = p
        with self._lock:
            self.stats["refits"] += 1
        return fitted

    # -- placement -------------------------------------------------------------
    def submit(self, payload: Any, *,
               deadline_class: str = "interactive") -> Future:
        """Admit (or shed) one request and place it on a replica.
        Sheds raise :class:`~repro_torch.launch.batching.QueueFull`."""
        if deadline_class not in DEADLINE_CLASSES:
            raise ValueError(f"unknown deadline class {deadline_class!r}; "
                             f"expected one of {DEADLINE_CLASSES}")
        if not self._started:
            raise RuntimeError("call start() first")
        with self._lock:
            cap = (self.max_outstanding
                   if deadline_class == "interactive"
                   else self.batch_threshold or self.max_outstanding)
            if self.max_outstanding > 0 and self._outstanding >= cap:
                self.stats["shed"][deadline_class] += 1
                raise QueueFull(
                    f"{deadline_class} admission at {self._outstanding} "
                    f"outstanding (cap {cap})"
                )
            replica = self.replicas[self._place_locked()]
            self._outstanding += 1
            self.stats["submitted"][deadline_class] += 1
            self.stats["placed"][replica.name] += 1
        try:
            fut = replica.submit(payload)
        except BaseException:
            # the service's own admission control may shed after the
            # router admitted — roll the outstanding count back so the
            # router's cap does not leak
            with self._lock:
                self._outstanding -= 1
                self.stats["shed"][deadline_class] += 1
            raise

        def _done(f: Future) -> None:
            with self._lock:
                self._outstanding -= 1

        fut.add_done_callback(_done)
        return fut

    def _place_locked(self) -> int:
        idx = list(range(len(self.replicas)))
        healthy = [i for i in idx
                   if self.replicas[i].healthy(self.unhealthy_after)]
        unhealthy = [i for i in idx if i not in healthy]
        if not healthy:
            healthy = idx              # degraded fleet: route anyway
        elif unhealthy:
            # keep probing excluded replicas so their watchdogs see
            # traffic — the EMA adapts, the streak resets, they rejoin
            self._since_probe += 1
            if self._since_probe >= self.probe_every:
                self._since_probe = 0
                self._probe_rr += 1
                self.stats["probes"] += 1
                return unhealthy[self._probe_rr % len(unhealthy)]
        if self.policy == "round_robin":
            self._rr += 1
            return healthy[self._rr % len(healthy)]
        if self.policy == "least_loaded":
            return min(healthy,
                       key=lambda i: (self.replicas[i].load(), i))
        # p99: queue-discounted tail estimate — a slow replica must be
        # this much emptier before it wins a placement
        def score(i: int) -> Tuple[float, float, int]:
            r = self.replicas[i]
            p99 = r.step_p99()
            if p99 is None:
                p99 = self.default_step_s
            load = r.load()
            return ((load + 1.0) * p99, load, i)
        return min(healthy, key=score)

    # -- scrape ----------------------------------------------------------------
    def outstanding(self) -> int:
        with self._lock:
            return self._outstanding

    def metrics_snapshot(self) -> Dict[str, float]:
        """One flat scrape for the whole fleet: every replica's
        snapshot (names disjoint via the per-replica label) plus
        router-level placement/shed/refit counters."""
        out: Dict[str, float] = {}
        for r in self.replicas:
            out.update(r.metrics_snapshot())
        with self._lock:
            out["std_router_outstanding"] = float(self._outstanding)
            out["std_router_refits_total"] = float(self.stats["refits"])
            out["std_router_probes_total"] = float(self.stats["probes"])
            for c in DEADLINE_CLASSES:
                out[f'std_router_submitted_total{{class="{c}"}}'] = float(
                    self.stats["submitted"][c])
                out[f'std_router_shed_total{{class="{c}"}}'] = float(
                    self.stats["shed"][c])
            for name, n in self.stats["placed"].items():
                out[f'std_router_placed_total{{replica="{name}"}}'] = \
                    float(n)
        return out
