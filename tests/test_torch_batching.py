"""repro_torch's serving layer against the JAX package's: the telemetry
book, the micro-batching scheduler, the host pipeline, the byte-budget
LRU, and STDService end to end in its three modes and both box tails.

The scheduler scripts run the port's and the reference's MicroBatcher on
the same FakeClock scripts (no real sleeps where a deadline is meant) and
require the same flush sequence: bucket key, batch size and reason, in
order.  The service tests hand the reference service's f32 weights to the
port (``params_from_numpy``) and require equal boxes.  Every wait on a
thread or a Future has its own timeout.
"""
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from repro.launch import batching as jbatch
from repro.launch.serve import STDService as JSTDService
from repro.runtime import telemetry as jtel
from repro.runtime.pipeline import HostPipeline as JHostPipeline
from repro_torch.launch import batching as tbatch
from repro_torch.launch.serve import STDService
from repro_torch.models.fcn import params_from_numpy
from repro_torch.runtime import telemetry as ttel
from repro_torch.runtime.pipeline import HostPipeline

torch.set_num_threads(2)

WAIT = 10                    # seconds any single wait may take


# ---------------------------------------------------------------------------
# CostBook
# ---------------------------------------------------------------------------

def _fill(book):
    for v in (5.0, 0.010, 0.020, 0.030, 0.015):
        book.record_step((64, 64), 4, "single_device", v)
    for v in (0.002, 0.004):
        book.record_step((64, 128), 1, "single_device", v, stage="dispatch",
                         precision="bfp")
    book.record_step((64, 64), 1, "device", 0.001, stage="postprocess")
    book.record_step((64, 64), 1, "device", 0.003, stage="postprocess")
    for v in range(300):                      # past the 256-sample window
        book.observe("mb_dispatch_s", v * 1e-4)
    book.observe("mb_batch_occupancy", 0.5)
    book.incr("pp_overflow")
    book.incr("mb_submitted", 7)
    book.set_gauge("queue_depth", 3)
    return book


@pytest.mark.parametrize("kw", [dict(), dict(ewma_alpha=0.5, warmup=0),
                                dict(window=4, labels={"replica": "r0"})])
def test_costbook_snapshot_and_prometheus_equal_reference(kw):
    got = _fill(ttel.CostBook(**kw))
    want = _fill(jtel.CostBook(**kw))
    assert got.snapshot() == want.snapshot()
    assert ttel.prometheus_text(got.snapshot()) == \
        jtel.prometheus_text(want.snapshot())
    for stage in ("step", "dispatch", "postprocess"):
        for prec in ("f32", "bfp"):
            assert got.step_keys(stage=stage, precision=prec) == \
                want.step_keys(stage=stage, precision=prec)
    assert got.step_total((64, 64), 4, "single_device") == \
        want.step_total((64, 64), 4, "single_device")
    assert got.counter("mb_submitted") == 7.0 and got.gauge("queue_depth") == 3


def test_relabel_and_merge_labels_equal_reference():
    snap = _fill(ttel.CostBook()).snapshot()
    assert ttel.relabel(snap, replica="r1", zone="a") == \
        jtel.relabel(snap, replica="r1", zone="a")
    for name, suffix in (("a", ""), ("a", 'k="v"'), ('a{x="1"}', 'k="v"')):
        assert ttel._merge_labels(name, suffix) == \
            jtel._merge_labels(name, suffix)
    assert ttel.prometheus_text({}) == jtel.prometheus_text({}) == ""


def test_costbook_concurrent_writers_lose_nothing():
    book = ttel.CostBook(warmup=0)
    n, per = 8, 500

    def worker(i):
        for _ in range(per):
            book.incr("hits")
            book.record_step((64, 64), 1, "single_device", 1e-3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert book.counter("hits") == n * per
    assert book.step_count((64, 64), 1, "single_device") == n * per


# ---------------------------------------------------------------------------
# MicroBatcher: the same scripts on both schedulers
# ---------------------------------------------------------------------------

def _flushes(mb):
    return [(b["key"], b["n"], b["reason"]) for b in mb.stats["batches"]]


def script_full(m):
    with m.MicroBatcher(lambda k, ps: [f"{k}:{p}" for p in ps], max_batch=2,
                        max_wait_ms=10_000) as mb:
        futs = [mb.submit(k, i) for i, k in enumerate("abab")]
        out = [f.result(timeout=WAIT) for f in futs]
    return _flushes(mb), out


def script_timeout(m):
    clk = m.FakeClock()
    rec = m.LatencyRecorder(clk)
    with m.MicroBatcher(lambda k, ps: ps, max_batch=8, max_wait_ms=30,
                        clock=clk) as mb:
        fut = rec.track(mb.submit("a", 42))
        clk.advance(0.029)
        early = fut.done()
        clk.advance(0.002)
        out = [fut.result(timeout=WAIT), early]
    return _flushes(mb), out + [rec.wait(WAIT)]


def script_drain(m):
    mb = m.MicroBatcher(lambda k, ps: ps, max_batch=8,
                        max_wait_ms=60_000).start()
    futs = [mb.submit("a", i) for i in range(3)]
    mb.stop()
    with pytest.raises(RuntimeError):
        mb.submit("a", 99)
    return _flushes(mb), [f.result(timeout=WAIT) for f in futs]


def script_reject(m):
    mb = m.MicroBatcher(lambda k, ps: ps, max_batch=8, max_wait_ms=10_000,
                        max_pending=2, admission="reject").start()
    try:
        futs = [mb.submit("a", 0), mb.submit("a", 1)]
        with pytest.raises(m.QueueFull):
            mb.submit("a", 2)
    finally:
        mb.stop()
    return _flushes(mb), [[f.result(timeout=WAIT) for f in futs],
                          mb.stats["rejected"], mb.stats["submitted"]]


def script_block_freed_by_timeout(m):
    clk = m.FakeClock()
    done = []
    mb = m.MicroBatcher(lambda k, ps: ps, max_batch=8, max_wait_ms=100,
                        max_pending=2, admission="block", clock=clk).start()
    try:
        futs = [mb.submit("a", 0), mb.submit("a", 1)]
        attempted = threading.Event()

        def blocked_client():
            attempted.set()
            futs.append(mb.submit("a", 2))
            done.append(True)

        t = threading.Thread(target=blocked_client)
        t.start()
        assert attempted.wait(WAIT)
        blocked = not done
        clk.advance(0.2)
        t.join(timeout=WAIT)
        assert not t.is_alive()
    finally:
        mb.stop()
    return _flushes(mb), [[f.result(timeout=WAIT) for f in futs], blocked,
                          mb.stats["pending_peak"], mb.stats["rejected"]]


def script_fairness_direct(m):
    """The oldest ready head wins over dict insertion order (the
    scheduler thread never starts: _next_batch runs here)."""
    clk = m.FakeClock()
    mb = m.MicroBatcher(lambda k, ps: ps, max_batch=2, max_wait_ms=10,
                        clock=clk)

    def put(key, t_submit):
        mb._pending.setdefault(key, deque()).append(
            m._Item(key, None, Future(), t_submit))
        mb._n_pending += 1

    put("a", 0.5)
    put("b", 0.0)
    put("a", 0.5)
    clk.advance(0.6)
    seq = []
    for _ in range(2):
        key, reason, items = mb._next_batch()
        seq.append((key, len(items), reason))
    return seq, None


def script_hot_bucket_does_not_starve(m):
    clk = m.FakeClock()
    with m.MicroBatcher(lambda k, ps: ps, max_batch=2, max_wait_ms=10,
                        clock=clk) as mb:
        cold = mb.submit("cold", "c")
        hot = [mb.submit("hot", i) for i in range(6)]
        out = [f.result(timeout=WAIT) for f in hot]
        clk.advance(0.011)
        out.append(cold.result(timeout=WAIT))
    return _flushes(mb), out


def script_finalize_short(m):
    with m.MicroBatcher(lambda k, ps: ps, finalize_fn=lambda k, r: r[:-1],
                        max_batch=3, max_wait_ms=10_000) as mb:
        futs = [mb.submit("a", i) for i in range(3)]
        out = [f.result(timeout=WAIT) for f in futs[:2]]
        with pytest.raises(RuntimeError, match="2 outputs for 3"):
            futs[2].result(timeout=WAIT)
    return _flushes(mb), [out, mb.stats["finalize_short"]]


def script_post_and_inflight0(m):
    with m.MicroBatcher(lambda k, ps: ps, post_fn=lambda p, o: o * 10,
                        finalize_fn=lambda k, r: list(r) + ["pad"],
                        max_batch=2, max_wait_ms=10_000, inflight=0) as mb:
        futs = [mb.submit("a", i) for i in range(4)]
        out = [f.result(timeout=WAIT) for f in futs]
    return _flushes(mb), [out, mb.stats["finalize_short"],
                          mb.stats["inflight_peak"]]


SCRIPTS = {
    "full": (script_full, [("a", 2, "full"), ("b", 2, "full")]),
    "timeout": (script_timeout, [("a", 1, "timeout")]),
    "drain": (script_drain, [("a", 3, "drain")]),
    "reject": (script_reject, [("a", 2, "drain")]),
    "block_freed_by_timeout": (script_block_freed_by_timeout,
                               [("a", 2, "timeout"), ("a", 1, "drain")]),
    "fairness": (script_fairness_direct, [("b", 1, "timeout"),
                                          ("a", 2, "full")]),
    "hot_bucket": (script_hot_bucket_does_not_starve,
                   [("hot", 2, "full")] * 3 + [("cold", 1, "timeout")]),
    "finalize_short": (script_finalize_short, [("a", 3, "full")]),
    "post_inflight0": (script_post_and_inflight0, [("a", 2, "full")] * 2),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_microbatcher_flush_sequence_equals_reference(name):
    script, want = SCRIPTS[name]
    got_seq, got_out = script(tbatch)
    ref_seq, ref_out = script(jbatch)
    assert got_seq == ref_seq == want
    assert got_out == ref_out


def test_microbatcher_concurrent_submitters_and_stats():
    results = {}
    book = ttel.CostBook()

    with tbatch.MicroBatcher(lambda k, ps: ps, max_batch=4, max_wait_ms=10,
                             book=book) as mb:
        def client(i):
            results[i] = mb.submit(i % 2, i).result(timeout=WAIT)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT)
        snap = mb.stats_snapshot()
    assert not any(t.is_alive() for t in ts)
    assert results == {i: i for i in range(16)}
    assert snap["submitted"] == 16 and snap["queue_depth"] == 0
    assert book.counter("mb_submitted") == 16
    assert set(mb.stats["stage_occupancy"]) == {"dispatch", "complete",
                                                "post"}


def test_microbatcher_rejects_bad_options():
    for kw in (dict(max_batch=0), dict(inflight=-1), dict(admission="drop")):
        with pytest.raises(ValueError):
            tbatch.MicroBatcher(lambda k, ps: ps, **kw)


def test_latency_recorder_waits_for_every_sample():
    rec = tbatch.LatencyRecorder()
    futs = [Future() for _ in range(50)]
    for f in futs:
        rec.track(f)
    ts = [threading.Thread(target=f.set_result, args=(None,)) for f in futs]
    for t in ts:
        t.start()
    samples = rec.wait(timeout_s=WAIT)
    for t in ts:
        t.join(timeout=WAIT)
    assert len(samples) == 50 and samples is not rec.samples


def test_fake_clock_is_monotone():
    clk = tbatch.FakeClock(1.0)
    assert clk.advance(0.5) == 1.5 and clk() == 1.5
    with pytest.raises(ValueError):
        clk.advance(-1)


# ---------------------------------------------------------------------------
# LRU and HostPipeline
# ---------------------------------------------------------------------------

def test_lru_byte_budget_equals_reference():
    def run(m):
        c = m.LRUCache(8, byte_budget=100)
        log = []
        for i, w in enumerate((40, 40, 30, 90, 10, 200)):
            c.put(i, i, weight=w)
            log.append((sorted(k for k in range(6) if k in c),
                        c.weight_bytes))
        c.get(4)
        return log, c.hits, c.misses, len(c)

    assert run(tbatch) == run(jbatch)
    assert run(tbatch)[0][-1] == ([5], 200)    # the newest always stays


def test_lru_count_eviction():
    c = tbatch.LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert "b" not in c and "a" in c and "c" in c and len(c) == 2
    assert tbatch.round_batch(5, 8) == jbatch.round_batch(5, 8) == 8


def test_host_pipeline_keeps_order():
    stages = [lambda x: x * 2, lambda x: x + 1]
    items = list(range(40))
    assert HostPipeline(stages, maxsize=2).run(items) == \
        JHostPipeline(stages, maxsize=2).run(items) == \
        [x * 2 + 1 for x in items]


def test_host_pipeline_propagates_errors_and_unwinds():
    before = threading.active_count()

    def boom(x):
        if x == 3:
            raise RuntimeError("stage on fire")
        return x

    with pytest.raises(RuntimeError, match="stage on fire"):
        HostPipeline([lambda x: x, boom, lambda x: x], maxsize=2).run(
            list(range(50)))
    deadline = time.monotonic() + WAIT
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before
    with pytest.raises(ValueError):
        HostPipeline([])


# ---------------------------------------------------------------------------
# STDService against the JAX service, same weights
# ---------------------------------------------------------------------------

KW = dict(width=0.125, buckets=(64,), max_batch=2)


def _keys(out):
    return [[(b["label"], b["box"], b["area"]) for b in r] for r in out]


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(0)
    return [rng.uniform(0, 1, (int(rng.integers(48, 65)),
                               int(rng.integers(48, 65)), 3)
                        ).astype(np.float32) for _ in range(6)]


@pytest.fixture(scope="module")
def ref():
    """The JAX service (device route) and its sequential boxes."""
    svc = JSTDService(**KW, postprocess="device")
    return svc


@pytest.fixture(scope="module")
def ref_boxes(ref, images):
    return [ref(img) for img in images]


def _port(ref, **kw):
    tree = jax.tree_util.tree_map(
        np.asarray, ref.factory.params((64, 64), "f32", "pixellink"))
    return STDService(**KW, device="cpu", params=params_from_numpy(tree),
                      **kw)


@pytest.mark.parametrize("postprocess", ["host", "device"])
def test_service_sequential_pipelined_batched_equal_reference(
        postprocess, ref, ref_boxes, images):
    port = _port(ref, postprocess=postprocess, max_wait_ms=20)
    want = _keys(ref_boxes)
    assert _keys([port(img) for img in images]) == want
    assert _keys(port.serve_pipelined(images)) == want
    assert _keys(port.serve_batched(images)) == want
    sizes = [b["n"] for b in port.stats["batching"]["batches"]]
    assert max(sizes) == 2 and port.stats["batched_tps"] > 0
    assert port.stats["pp_overflow"] == ref.stats["pp_overflow"] == 0
    assert port.stats["nonconverged"] == ref.stats["nonconverged"]
    kinds = {k[2] for k in port.book.step_keys(stage="postprocess")}
    assert kinds == {postprocess}
    assert port.book.step_count((64, 64), 1, "single_device") > 0


def test_reference_batched_equals_port_batched(ref, ref_boxes, images):
    port = _port(ref, postprocess="device", max_wait_ms=20)
    assert _keys(ref.serve_batched(images)) == _keys(ref_boxes) == \
        _keys(port.serve_batched(images))


def test_overflow_fallback_counts_equal_reference(ref, ref_boxes, images):
    """boxes_capacity=1: every multi-component image falls back to its
    label map; the boxes stay equal and both services count the same
    overflows.  (The reference service shares the module's compiled
    engines.)"""
    jover = JSTDService(**KW, postprocess="device", boxes_capacity=1)
    jover.factory = ref.factory
    port = _port(ref, postprocess="device", boxes_capacity=1)
    got = [port(img) for img in images]
    assert _keys(got) == _keys([jover(img) for img in images]) == \
        _keys(ref_boxes)
    assert port.stats["pp_overflow"] == jover.stats["pp_overflow"] > 0
    assert port.book.counter("pp_overflow") == port.stats["pp_overflow"]
    port._count_nonconverged(np.array([True, False, True, False]))
    jover._count_nonconverged(np.array([True, False, True, False]))
    assert port.stats["nonconverged"] == jover.stats["nonconverged"] == 2
    assert port.book.counter("pp_nonconverged") == \
        jover.book.counter("pp_nonconverged") == 2


def test_metrics_snapshot_and_prometheus(ref, images):
    port = _port(ref, postprocess="device", max_wait_ms=20,
                 activation_budget_bytes=1 << 20, engine_cache_bytes=1 << 20)
    for img in images[:3]:
        port(img)
    port.serve_batched(images)
    row = port.measure_engine_memory((64, 64), 2)
    assert set(row) == {"hw", "batch", "plan", "precision", "model",
                        "planned_peak_bytes"}
    assert row["planned_peak_bytes"] == \
        port.factory.engine_weight_bytes((64, 64), 2) == \
        ref.factory.engine_weight_bytes((64, 64), 2, "f32", "pixellink")
    assert port.factory.deepest_stride((64, 64)) == \
        ref.factory.deepest_stride((64, 64), "f32", "pixellink")
    snap = port.metrics_snapshot()
    assert snap["std_requests_total"] == 3.0
    assert snap["std_request_latency_p99_ms"] >= \
        snap["std_request_latency_p50_ms"] > 0
    assert snap["std_mb_submitted"] == len(images)
    cap = port._bucket_cap((64, 64))
    assert snap['std_bucket_batch_cap{bucket="64x64"}'] == cap >= 1
    assert any(k.startswith("std_engine_planned_peak_bytes{") for k in snap)
    assert any(k.startswith("std_step_ewma_s{") for k in snap)
    lines = port.metrics_prometheus().splitlines()
    assert len(lines) == len(snap)
    assert port.queue_gauges() == {"queue_depth": 0.0, "inflight": 0.0}
    assert port.factory.engines.weight_bytes <= max(
        1 << 20, max(port.factory.engine_weight_bytes((64, 64), b)
                     for b in (1, 2, 4, cap)))


def test_submit_api_and_admission_options(ref, images):
    port = _port(ref, postprocess="device", max_pending=2,
                 admission="reject", inflight=0)
    port.start_batched()
    try:
        fut = port.submit(images[0])
        boxes = fut.result(timeout=60)
    finally:
        port.stop_batched()
    assert boxes == port(images[0])
    with pytest.raises(RuntimeError, match="start_batched"):
        port.submit(images[0])
    assert port.stats["batching_snapshot"]["submitted"] == 1.0
