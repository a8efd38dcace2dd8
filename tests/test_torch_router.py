"""repro_torch's serving fleet (``launch/router.py``) and watchdog
(``runtime/fault_tolerance.py``) against the JAX package's.

Every script of the reference's ``tests/test_router.py`` runs twice, on
the reference's Router, ServiceReplica, Watchdog, CostBook, Planner and
FakeClock and on the port's, against the same simulated replicas; each
run returns a trace (placement sequence, shed order and QueueFull
counts, watchdog streaks and incidents, refit results, latencies), and
the traces must be equal.  The reference's own assertions are then held
on the port's trace.  A fleet of two port ``STDService`` replicas serves
the same images as the JAX service, with equal boxes.  No real sleeps
where a deadline is meant; every wait has its own timeout.
"""
import dataclasses
import os
import signal
import threading
from concurrent.futures import Future
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

PKGS = ("jax", "torch")


def _ns(pkg):
    """One package's fleet classes, and a (1, 4) data x model mesh its
    Planner accepts."""
    if pkg == "jax":
        from repro.launch import batching, router
        from repro.runtime import executor, fault_tolerance, planner, \
            telemetry
        mesh = SimpleNamespace(axis_names=("data", "model"),
                               devices=np.empty((1, 4), dtype=object))
    else:
        from repro_torch.launch import batching, router
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.runtime import executor, fault_tolerance, \
            planner, telemetry
        mesh = make_host_mesh((1, 4), device="cpu")
    return SimpleNamespace(
        FakeClock=batching.FakeClock, QueueFull=batching.QueueFull,
        Router=router.Router, ServiceReplica=router.ServiceReplica,
        POLICIES=router.POLICIES, DEADLINE_CLASSES=router.DEADLINE_CLASSES,
        Watchdog=fault_tolerance.Watchdog,
        PreemptionGuard=fault_tolerance.PreemptionGuard,
        CostBook=telemetry.CostBook, Planner=planner.Planner,
        PlanFeatures=planner.PlanFeatures, CostParams=planner.CostParams,
        MeasuredCost=planner.MeasuredCost, plan_kind=executor.plan_kind,
        mesh=mesh, pkg=pkg)


def both(script, *args):
    """The script's trace on each package; they must be equal."""
    traces = [script(_ns(p), *args) for p in PKGS]
    assert traces[0] == traces[1], traces
    return traces[1]


class SimService:
    """One simulated replica: a FIFO single-server queue on a shared
    FakeClock (the reference test's simulator, over either package's
    CostBook and clock)."""

    def __init__(self, ns, clk, service_s: float, hw=(64, 64)):
        self.clock = clk
        self.service_s = service_s
        self.hw = tuple(hw)
        self.book = ns.CostBook(warmup=0)
        self.started = False
        self._busy_until = 0.0
        self._queue = []
        self._seq = 0
        clk.subscribe(self._drain)

    def start_batched(self):
        self.started = True

    def stop_batched(self):
        self.started = False

    def submit(self, payload):
        assert self.started, "submit before start_batched"
        fut = Future()
        now = self.clock()
        done = max(now, self._busy_until) + self.service_s
        self._busy_until = done
        self.book.record_step(self.hw, 1, "single_device", self.service_s)
        self._queue.append((done, self._seq, fut, payload))
        self._seq += 1
        return fut

    def _drain(self):
        now = self.clock()
        due = sorted((q for q in self._queue if q[0] <= now),
                     key=lambda q: q[:2])
        self._queue = [q for q in self._queue if q[0] > now]
        for _done_at, _seq, fut, payload in due:
            fut.set_result(payload)


def no_health_watchdog(ns):
    return ns.Watchdog(threshold=float("inf"), warmup_steps=0)


def make_fleet(ns, clk, service_times, *, policy, **router_kw):
    sims = [SimService(ns, clk, s) for s in service_times]
    reps = [ns.ServiceReplica(f"r{i}", sim, clock=clk,
                              watchdog=no_health_watchdog(ns))
            for i, sim in enumerate(sims)]
    router_kw.setdefault("unhealthy_after", 10 ** 9)
    return sims, reps, ns.Router(reps, policy=policy, clock=clk,
                                 **router_kw)


def place(router, payload, **kw):
    """Submit one request; the name of the replica it went to."""
    before = dict(router.stats["placed"])
    fut = router.submit(payload, **kw)
    after = router.stats["placed"]
    return fut, next(n for n in after if after[n] != before[n])


def drive(clk, router, n_requests, arrival_dt):
    """Open-loop arrivals, one per ``arrival_dt`` of fake time: the
    sorted latencies and the placement sequence."""
    lat, futs, seq = [], [], []
    for i in range(n_requests):
        t0 = clk()
        fut, name = place(router, i)
        fut.add_done_callback(lambda f, t0=t0: lat.append(clk() - t0))
        futs.append(fut)
        seq.append(name)
        clk.advance(arrival_dt)
    clk.advance(1000.0)
    assert all(f.done() for f in futs)
    return sorted(lat), seq


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------

def script_two_replicas(ns, policy, times, n, arrival):
    clk = ns.FakeClock()
    _, _, router = make_fleet(ns, clk, times, policy=policy)
    with router:
        lat, seq = drive(clk, router, n, arrival)
        placed = dict(router.stats["placed"])
    return {"lat": lat, "seq": seq, "placed": placed}


def test_p99_routing_beats_round_robin_tail():
    """Heterogeneous replicas (one 10x slower): round-robin piles half
    the traffic on the slow one, p99 scoring discounts it."""
    rr = both(script_two_replicas, "round_robin", (0.05, 0.5), 24, 0.1)
    p99 = both(script_two_replicas, "p99", (0.05, 0.5), 24, 0.1)
    assert rr["placed"] == {"r0": 12, "r1": 12}
    assert p99["placed"]["r0"] >= 20
    assert max(rr["lat"]) > 2.0 * max(p99["lat"])
    assert max(p99["lat"]) <= 1.0
    assert len(rr["lat"]) == len(p99["lat"]) == 24


def script_least_loaded(ns):
    clk = ns.FakeClock()
    _, reps, router = make_fleet(ns, clk, (0.05, 0.05),
                                 policy="least_loaded")
    with router:
        for i in range(4):                 # preload r0 outside the router
            reps[0].submit(("pre", i))
        load = reps[0].load()
        _, name = place(router, "x")
        clk.advance(10.0)
    return {"load": load, "placed_on": name}


def test_least_loaded_follows_queue_depth():
    t = both(script_least_loaded)
    assert t == {"load": 4.0, "placed_on": "r1"}


def script_unmeasured_explored(ns):
    clk = ns.FakeClock()
    _, _, router = make_fleet(ns, clk, (0.05, 0.05), policy="p99")
    seq = []
    with router:
        for i in range(4):
            seq.append(place(router, i)[1])
            clk.advance(0.2)
        placed = dict(router.stats["placed"])
        clk.advance(10.0)
    return {"seq": seq, "placed": placed}


def test_unmeasured_replica_gets_explored_under_p99():
    t = both(script_unmeasured_explored)
    assert t["placed"]["r0"] >= 1 and t["placed"]["r1"] >= 1


# ---------------------------------------------------------------------------
# deadline-class admission
# ---------------------------------------------------------------------------

def _admission_router(ns, clk):
    _, _, router = make_fleet(ns, clk, (100.0,), policy="round_robin",
                              max_outstanding=8, batch_threshold=4)
    return router


def script_batch_sheds_first(ns):
    clk = ns.FakeClock()
    router = _admission_router(ns, clk)
    events = []
    with router:
        admitted = [router.submit(i, deadline_class="batch")
                    for i in range(4)]
        with pytest.raises(ns.QueueFull):
            router.submit("b!", deadline_class="batch")
        events.append(dict(router.stats["shed"]))
        admitted += [router.submit(i, deadline_class="interactive")
                     for i in range(4)]
        with pytest.raises(ns.QueueFull):
            router.submit("i!", deadline_class="interactive")
        events.append(dict(router.stats["shed"]))
        clk.advance(10_000.0)
        done = all(f.done() for f in admitted)
    return {"shed": events, "done": done}


def test_batch_sheds_before_interactive():
    t = both(script_batch_sheds_first)
    assert t["shed"] == [{"interactive": 0, "batch": 1},
                         {"interactive": 1, "batch": 1}]
    assert t["done"]


def script_mixed_overload(ns):
    clk = ns.FakeClock()
    router = _admission_router(ns, clk)
    sheds = []
    with router:
        for i in range(30):              # overload, nothing completes
            cls = "interactive" if i % 2 else "batch"
            try:
                router.submit(i, deadline_class=cls)
            except ns.QueueFull:
                sheds.append((i, cls))
        stats = {k: dict(router.stats[k]) for k in ("submitted", "shed")}
        clk.advance(10_000.0)
    return {"sheds": sheds, "stats": stats}


def test_interactive_never_sheds_before_batch_on_mixed_stream():
    t = both(script_mixed_overload)
    order = [c for _, c in t["sheds"]]
    assert order and order[0] == "batch"
    first_interactive = order.index("interactive") \
        if "interactive" in order else len(order)
    assert "batch" in order[:first_interactive]
    assert sum(t["stats"]["shed"].values()) == len(order)


def script_unknown_class(ns):
    clk = ns.FakeClock()
    router = _admission_router(ns, clk)
    with router:
        with pytest.raises(ValueError, match="deadline class"):
            router.submit(0, deadline_class="best_effort")
        clk.advance(10_000.0)
    return dict(router.stats["submitted"])


def test_unknown_deadline_class_rejected():
    assert both(script_unknown_class) == {"interactive": 0, "batch": 0}


# ---------------------------------------------------------------------------
# online refit
# ---------------------------------------------------------------------------

HW = (128, 64)


def tall_features(ns):
    def f(hw):
        h, w = hw
        return ns.PlanFeatures(flops=2e5 * h * w / 64.0,
                               halo_bytes=3e4 * w / 64.0,
                               deepest_stride=32, halo_layers=20)
    return f


def _reference_constants(ns):
    """The reference's CostParams defaults in ``ns``'s CostParams (the
    port's defaults are H100 rates), so both fits start from one base."""
    from repro.runtime.planner import CostParams

    return ns.CostParams(**dataclasses.asdict(CostParams()))


def _fitted(params):
    """The constants a refit fits (the others are each package's
    defaults: the port's are H100 rates)."""
    return {k: getattr(params, k) for k in (
        "peak_flops", "ici_bw", "dispatch_overhead_s",
        "collective_overhead_s", "halo_launch_s")}


def _refit_replica(ns, clk, own_defaults=False):
    svc = SimService(ns, clk, 0.05)
    svc.planner = ns.Planner(
        ns.mesh, tall_features(ns),
        params=None if own_defaults else _reference_constants(ns))
    for _ in range(3):
        svc.book.record_step(HW, 1, "single_device", 0.02)
        svc.book.record_step((64, 64), 1, "single_device", 0.01)
    return svc, ns.ServiceReplica("r0", svc, clock=clk,
                                  features_fn=tall_features(ns),
                                  watchdog=no_health_watchdog(ns))


def script_control_loop(ns, own_defaults=False):
    clk = ns.FakeClock()
    svc, rep = _refit_replica(ns, clk, own_defaults)
    router = ns.Router([rep], policy="p99", refit_interval_s=10.0,
                       clock=clk)
    with router:
        before = ns.plan_kind(svc.planner.choose(HW, 1))
        clk.advance(10.5)                # the control loop fires
        refits = router.stats["refits"]
        after = ns.plan_kind(svc.planner.choose(HW, 1))
        params = _fitted(svc.planner.params)
    return {"before": before, "after": after, "refits": refits,
            "params": params}


def script_refit_now(ns):
    clk = ns.FakeClock()
    _, rep = _refit_replica(ns, clk)
    router = ns.Router([rep], policy="p99", clock=clk)
    with router:
        fitted = router.refit_now()
    return {k: _fitted(v) for k, v in fitted.items()}


def test_control_loop_refit_flips_routing_online():
    """From the reference's constants the traces are equal; from the
    port's own H100 defaults the refit flips the same decision."""
    for t in (both(script_control_loop),
              script_control_loop(_ns("torch"), own_defaults=True)):
        assert (t["before"], t["after"]) == ("single_device", "row_band")
        assert t["refits"] >= 1
        assert t["params"]["peak_flops"] == pytest.approx(1.28e9,
                                                          rel=1e-3)


def test_refit_now_returns_fitted_params_per_replica():
    t = both(script_refit_now)
    assert set(t) == {"r0"}
    assert t["r0"]["peak_flops"] == pytest.approx(1.28e9, rel=1e-3)


@pytest.mark.parametrize("pkg", PKGS)
def test_set_params_preserves_measured_overlay(pkg):
    ns = _ns(pkg)
    book = ns.CostBook(warmup=0)
    planner = ns.Planner(ns.mesh, tall_features(ns))
    planner.use_measurements(book)
    new = ns.CostParams(peak_flops=1.28e9)
    planner.set_params(new)
    assert isinstance(planner.cost, ns.MeasuredCost)
    assert planner.cost.book is book
    assert planner.params == new


def script_no_planner(ns):
    clk = ns.FakeClock()
    rep = ns.ServiceReplica("r0", SimService(ns, clk, 0.05), clock=clk,
                            watchdog=no_health_watchdog(ns))
    return rep.refit()


def test_replica_without_planner_refits_to_none():
    assert both(script_no_planner) is None


# ---------------------------------------------------------------------------
# replica health
# ---------------------------------------------------------------------------

def script_slow_replica(ns):
    clk = ns.FakeClock()
    fast = SimService(ns, clk, 0.05)
    sick = SimService(ns, clk, 0.05)
    wd = ns.Watchdog(threshold=3.0, ema=0.5, warmup_steps=0, adapt_after=2)
    reps = [ns.ServiceReplica("r0", fast, clock=clk,
                              watchdog=no_health_watchdog(ns)),
            ns.ServiceReplica("r1", sick, clock=clk, watchdog=wd)]
    router = ns.Router(reps, policy="round_robin", unhealthy_after=2,
                       probe_every=4, clock=clk)
    streaks = []

    def place_one(i):
        _, name = place(router, i)
        for _ in range(11):              # 0.1 s ticks resolve each request
            clk.advance(0.1)
        streaks.append(wd.consecutive)
        return name

    with router:
        for i in range(6):               # warm both watchdogs
            place_one(i)
        sick.service_s = 1.0             # a sustained 10x slowdown
        placements = [place_one(i) for i in range(16)]
    return {"placements": placements, "streaks": streaks,
            "incidents": list(wd.incidents), "ema": wd.ema,
            "consecutive": wd.consecutive,
            "probes": router.stats["probes"]}


def test_slow_replica_excluded_then_recovers():
    t = both(script_slow_replica)
    placements = t["placements"]
    assert t["incidents"], "slowdown never flagged"
    r0_run = max(len(s) for s in "".join(
        "x" if p == "r0" else "." for p in placements).split("."))
    assert r0_run >= 3, placements
    assert t["probes"] >= 1
    assert t["consecutive"] == 0
    first = placements.index("r0")
    assert "r1" in placements[first + r0_run:], placements


def script_all_unhealthy(ns):
    clk = ns.FakeClock()
    wd = ns.Watchdog(threshold=3.0, warmup_steps=0, adapt_after=10 ** 9)
    rep = ns.ServiceReplica("r0", SimService(ns, clk, 0.05), clock=clk,
                            watchdog=wd)
    router = ns.Router([rep], policy="round_robin", unhealthy_after=1,
                       clock=clk)
    with router:
        wd.ema = 1e-9                    # everything is a straggler now
        router.submit(0)
        clk.advance(1.0)
        router.submit(1)                 # a degraded fleet still routes
        clk.advance(1.0)
    return {"placed": dict(router.stats["placed"]),
            "streak": wd.consecutive, "incidents": len(wd.incidents)}


def test_all_unhealthy_still_routes():
    assert both(script_all_unhealthy)["placed"] == {"r0": 2}


# ---------------------------------------------------------------------------
# fleet telemetry and validation
# ---------------------------------------------------------------------------

def script_scrape(ns):
    clk = ns.FakeClock()
    _, _, router = make_fleet(ns, clk, (0.05, 0.5), policy="p99")
    with router:
        drive(clk, router, 8, 0.1)
        return router.metrics_snapshot()


def test_one_scrape_aggregates_all_replicas_without_clobbering():
    snap = both(script_scrape)
    for name in ("r0", "r1"):
        assert any(f'replica="{name}"' in k
                   and k.startswith("std_step_p99_s{") for k in snap), name
        assert snap[f'std_replica_outstanding{{replica="{name}"}}'] == 0.0
    assert sum(snap[f'std_router_placed_total{{replica="{n}"}}']
               for n in ("r0", "r1")) == 8.0
    assert snap['std_router_shed_total{class="interactive"}'] == 0.0
    assert snap["std_router_outstanding"] == 0.0
    assert all(k.count("replica=") <= 1 for k in snap)


def script_label_on_wrap(ns):
    clk = ns.FakeClock()
    sim = SimService(ns, clk, 0.05)
    ns.ServiceReplica("west-3", sim, clock=clk)
    return sim.book.labels


def test_replica_labels_book_on_wrap():
    assert both(script_label_on_wrap) == {"replica": "west-3"}


@pytest.mark.parametrize("pkg", PKGS)
def test_policy_and_replica_validation(pkg):
    ns = _ns(pkg)
    clk = ns.FakeClock()
    rep = ns.ServiceReplica("r0", SimService(ns, clk, 0.05), clock=clk)
    with pytest.raises(ValueError, match="at least one"):
        ns.Router([])
    with pytest.raises(ValueError, match="unknown policy"):
        ns.Router([rep], policy="fastest_first")
    dup = ns.ServiceReplica("r0", SimService(ns, clk, 0.05), clock=clk)
    with pytest.raises(ValueError, match="unique"):
        ns.Router([rep, dup])
    with pytest.raises(ValueError, match="outstanding"):
        ns.Router([rep], max_outstanding=-1)
    assert set(ns.POLICIES) == {"round_robin", "p99", "least_loaded"}
    assert set(ns.DEADLINE_CLASSES) == {"interactive", "batch"}


@pytest.mark.parametrize("pkg", PKGS)
def test_submit_before_start_rejected(pkg):
    ns = _ns(pkg)
    clk = ns.FakeClock()
    router = ns.Router([ns.ServiceReplica("r0", SimService(ns, clk, 0.05),
                                          clock=clk)])
    with pytest.raises(RuntimeError, match="start"):
        router.submit(0)


@pytest.mark.parametrize("pkg", PKGS)
def test_service_level_shed_rolls_back_outstanding(pkg):
    ns = _ns(pkg)
    clk = ns.FakeClock()

    class Shedding:
        book = None

        def start_batched(self):
            pass

        def stop_batched(self):
            pass

        def submit(self, payload):
            raise ns.QueueFull("service full")

    router = ns.Router([ns.ServiceReplica("r0", Shedding(), clock=clk)],
                       policy="round_robin")
    with router:
        with pytest.raises(ns.QueueFull):
            router.submit(0)
        assert router.outstanding() == 0
        assert router.stats["shed"]["interactive"] == 1


# ---------------------------------------------------------------------------
# Watchdog and PreemptionGuard (the reference's test_substrate cases)
# ---------------------------------------------------------------------------

WATCHDOG_SCRIPTS = {
    # (Watchdog kwargs, step times): the straggler at 10x the EMA, a lone
    # spike, a sustained 10x slowdown the EMA adapts to
    "straggler": (dict(threshold=3.0, warmup_steps=1),
                  [0.1] * 10 + [1.0]),
    "transient": (dict(threshold=3.0, warmup_steps=1),
                  [0.1] * 10 + [1.0, 0.1]),
    "sustained": (dict(threshold=3.0, ema=0.5, warmup_steps=1,
                       adapt_after=3), [0.1] * 10 + [1.0] * 21),
}


def script_watchdog(ns, kw, times):
    wd = ns.Watchdog(**kw)
    flags, emas, streaks = [], [], []
    for i, dt in enumerate(times):
        flags.append(wd.observe(100 + i, dt))
        emas.append(wd.ema)
        streaks.append(wd.consecutive)
    return {"flags": flags, "emas": emas, "streaks": streaks,
            "incidents": list(wd.incidents)}


@pytest.mark.parametrize("name", sorted(WATCHDOG_SCRIPTS))
def test_watchdog_incident_sequence_equals_reference(name):
    t = both(script_watchdog, *WATCHDOG_SCRIPTS[name])
    flags = t["flags"]
    assert not any(flags[:10])
    if name == "straggler":
        assert flags[10] and t["incidents"][-1]["step"] == 110
    elif name == "transient":
        # flagged, and the spike leaves the EMA where it was
        assert flags[10] and not flags[11]
        assert t["emas"][10] == t["emas"][9] and t["streaks"][11] == 0
    else:
        tail = flags[10:30]
        assert tail[0] and tail[1] and tail[2]
        assert not all(tail) and not tail[-1]
        assert t["streaks"][29] == 0
        assert t["emas"][29] == pytest.approx(1.0, rel=0.35)
        assert not flags[30]
        assert t["incidents"][0]["step"] == 110


@pytest.mark.parametrize("pkg", PKGS)
def test_watchdog_adapt_after_validation(pkg):
    with pytest.raises(ValueError):
        _ns(pkg).Watchdog(adapt_after=0)


@pytest.mark.parametrize("pkg", PKGS)
def test_preemption_guard_request_and_signal(pkg):
    ns = _ns(pkg)
    guard = ns.PreemptionGuard(install=False)
    assert not guard.requested and guard._orig == {}
    guard.request()
    assert guard.requested
    if threading.current_thread() is not threading.main_thread():
        return
    before = signal.getsignal(signal.SIGTERM)
    guard = ns.PreemptionGuard(install=True)
    try:
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(1000):            # the handler runs between
            if guard.requested:          # bytecodes of the main thread
                break
        assert guard.requested
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


# ---------------------------------------------------------------------------
# a fleet of port STDServices against the JAX service
# ---------------------------------------------------------------------------

KW = dict(width=0.125, buckets=(64,), max_batch=2)


def _keys(out):
    return [[(b["label"], b["box"], b["area"]) for b in r] for r in out]


@pytest.fixture(scope="module")
def fleet_images():
    rng = np.random.default_rng(3)
    return [rng.uniform(0, 1, (int(rng.integers(48, 65)),
                               int(rng.integers(48, 65)), 3)
                        ).astype(np.float32) for _ in range(6)]


@pytest.fixture(scope="module")
def reference_fleet_boxes(fleet_images):
    """The JAX service's sequential boxes and its f32 weights."""
    from repro.launch.serve import STDService as JSTDService

    svc = JSTDService(**KW, postprocess="device")
    tree = jax.tree_util.tree_map(
        np.asarray, svc.factory.params((64, 64), "f32", "pixellink"))
    return [svc(img) for img in fleet_images], tree


@pytest.mark.parametrize("policy", ["round_robin", "least_loaded", "p99"])
def test_fleet_of_std_services_equals_reference(policy, fleet_images,
                                                reference_fleet_boxes):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.router import Router, ServiceReplica
    from repro_torch.launch.serve import STDService
    from repro_torch.models.fcn import params_from_numpy
    from repro_torch.runtime.planner import CostParams, Planner
    from repro_torch.runtime.telemetry import CostBook, prometheus_text

    want, tree = reference_fleet_boxes
    params = params_from_numpy(tree)
    # replica r0 routes through a Planner; its book keeps every step
    # (no warm-up skip), so a few requests leave rows to fit
    svcs = [STDService(**KW, device="cpu", params=params,
                       postprocess="device", max_wait_ms=20,
                       planner=Planner(make_host_mesh((1, 1), device="cpu")),
                       book=CostBook(warmup=0)),
            STDService(**KW, device="cpu", params=params,
                       postprocess="device", max_wait_ms=20)]
    reps = [ServiceReplica(f"r{i}", s) for i, s in enumerate(svcs)]
    with Router(reps, policy=policy) as router:
        futs = [router.submit(img, deadline_class="batch" if i % 3 == 2
                              else "interactive")
                for i, img in enumerate(fleet_images)]
        got = [f.result(timeout=120) for f in futs]
        fitted = router.refit_now()
        text = prometheus_text(router.metrics_snapshot())
    assert _keys(got) == _keys(want)
    assert sum(router.stats["placed"].values()) == len(fleet_images)
    assert router.stats["submitted"] == {"interactive": 4, "batch": 2}
    assert set(fitted) == {"r0"} and isinstance(fitted["r0"], CostParams)
    for name in ("r0", "r1"):
        assert f'replica="{name}"' in text
    assert all(line.count("replica=") <= 1 for line in text.splitlines())
