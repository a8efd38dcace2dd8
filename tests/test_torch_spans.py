"""The port's span log (``runtime/telemetry.SPANS``) on the CPU: the span
tree of micro-batched requests through ``STDService``, how its spans tile
a request, the gate (nothing recorded without a profile), the shared
clock with the profiler's events, the CC round and sync counts, the
engine LRU's build and eviction counters, and the benchmark's readers of
the log (``perfbench/metrics``) on hand-built logs.
"""
import importlib.util
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig

from repro_torch.launch.serve import STDService
from repro_torch.models.fcn import postprocess as pp
from repro_torch.runtime import telemetry
from repro_torch.runtime.telemetry import SPANS, SpanLog

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
WAIT = 120                   # seconds any single wait may take
STAGES = ("std.preprocess", "mb.form", "mb.handoff", "mb.dispatch",
          "mb.inflight", "mb.complete", "mb.post")


def profiled(all_threads: bool = True):
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU],
        experimental_config=_ExperimentalConfig(
            profile_all_threads=all_threads))


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0, 1, (240, 240, 3)).astype(np.float32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def svc():
    """A narrow service on the micro-batched path, its engines built and
    the profiler's ranges warmed once."""
    s = STDService(width=0.125, buckets=(256,), max_batch=2,
                   max_wait_ms=50, postprocess="device", device="cpu")
    s.start_batched()
    with profiled():
        for f in [s.submit(im) for im in _images(2, seed=9)]:
            f.result(timeout=WAIT)
    yield s
    s.stop_batched()


@pytest.fixture(scope="module")
def traced(svc):
    """Two requests served under a profile of every thread, started after
    the batcher's threads: (the log's spans, the profiler)."""
    SPANS.clear()
    with profiled() as prof:
        for f in [svc.submit(im) for im in _images(2)]:
            f.result(timeout=WAIT)
    return SPANS.records(), prof


def _by(spans, name):
    return [s for s in spans if s.name == name]


def _ancestor(spans, s, name):
    by_id = {r.id: r for r in spans}
    p = by_id.get(s.parent)
    while p is not None and p.name != name:
        p = by_id.get(p.parent)
    return p


def test_span_tree_links_two_requests(traced):
    spans, _ = traced
    roots = _by(spans, "std.request")
    assert len(roots) == 2 and all(r.req == r.id for r in roots)
    batches = {s.batch for s in _by(spans, "mb.handoff")}
    for root in roots:
        kids = {s.name for s in spans if s.parent == root.id}
        assert kids == {"std.preprocess", "mb.form", "mb.post"}
        assert root.batch in batches
        for name in ("mb.handoff", "mb.dispatch", "mb.inflight",
                     "mb.complete"):
            (one,) = [s for s in _by(spans, name) if s.batch == root.batch]
            assert root.req in one.reqs
        (dispatch,) = [s for s in _by(spans, "mb.dispatch")
                       if s.batch == root.batch]
        (run,) = [s for s in _by(spans, "engine.run")
                  if s.parent == dispatch.id]
        assert run.batch == root.batch
        syncs = [s for s in _by(spans, "cc.sync")
                 if _ancestor(spans, s, "engine.run") == run]
        assert len(syncs) == run.counts["cc.syncs"] >= 1
        for name in ("engine.forward", "cc.merge"):
            assert [s for s in _by(spans, name) if s.parent == run.id]
        (post,) = [s for s in _by(spans, "mb.post") if s.req == root.req]
        assert post.batch == root.batch
    assert all(s.start <= s.end for s in spans)


def test_child_spans_tile_the_request(traced):
    spans, _ = traced
    for root in _by(spans, "std.request"):
        covered = 0
        for s in spans:
            if s.name in STAGES and (s.req == root.req
                                     or root.req in s.reqs):
                assert root.start <= s.start <= s.end <= root.end, s
                covered += s.end - s.start
        length = root.end - root.start
        assert abs(covered - length) <= 0.05 * length, (covered, length)


def test_nothing_recorded_without_a_profile(svc):
    SPANS.clear()
    assert not SPANS.on()
    for f in [svc.submit(im) for im in _images(2, seed=1)]:
        f.result(timeout=WAIT)
    assert SPANS.records() == []


def test_dispatch_spans_on_the_trace_clock(traced):
    spans, prof = traced
    events = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "mb.dispatch"]
    dispatch = _by(spans, "mb.dispatch")
    assert dispatch and len(events) == len(dispatch)
    for s in dispatch:
        assert min(abs(t - s.start) for t in events) < 1_000_000


@pytest.mark.parametrize("seed,shape", [(0, (2, 24, 24)), (1, (3, 40, 16)),
                                        (2, (1, 8, 64))])
def test_cc_counts_equal_merge_rounds(seed, shape):
    g = torch.Generator().manual_seed(seed)
    score = torch.rand(shape, generator=g)
    links = torch.rand(shape + (8,), generator=g)
    SPANS.take()
    _, iters, _ = pp.cc_label_batched(score, links, 0.3, 0.3,
                                      return_stats=True)
    rounds = int(iters.max())
    assert SPANS.take() == {"cc.rounds": rounds, "cc.syncs": rounds + 1}
    SPANS.clear()
    with profiled(all_threads=False):
        with SPANS.span("outer"):
            pp.cc_label_batched(score, links, 0.3, 0.3)
    spans = SPANS.records()
    (merge,) = _by(spans, "cc.merge")
    syncs = _by(spans, "cc.sync")
    assert len(syncs) == rounds + 1 and {s.parent for s in syncs} == \
        {merge.id}
    assert SPANS.take() == {"cc.rounds": rounds, "cc.syncs": rounds + 1}


def test_engine_call_counts_reach_the_book(svc):
    x, valid, _ = svc.preprocess(_images(1, seed=3)[0])
    before = svc.book.counter("cc_rounds"), svc.book.counter("cc_syncs")
    SPANS.clear()
    with profiled(all_threads=False):
        svc.infer_labels(x[None], [valid])
    (run,) = _by(SPANS.records(), "engine.run")
    rounds = run.counts["cc.rounds"]
    assert run.counts["cc.syncs"] == rounds + 1
    assert (svc.book.counter("cc_rounds") - before[0],
            svc.book.counter("cc_syncs") - before[1]) == (rounds, rounds + 1)
    assert svc.metrics_snapshot()["std_cc_rounds_total"] == \
        svc.book.counter("cc_rounds")


def test_lru_of_one_counts_a_build_and_an_eviction():
    s = STDService(width=0.125, buckets=(64, 128), device="cpu",
                   engine_cache_capacity=1)
    fac = s.factory
    SPANS.clear()
    with profiled(all_threads=False):
        fac.plan_fn((64, 64), 1)
        fac.plan_fn((64, 64), 1)             # a hit: no build
        fac.plan_fn((128, 64), 1)            # evicts the first bucket's
    builds = _by(SPANS.records(), "engine.build")
    assert [b.counts for b in builds] == [
        {"engine.builds": 1, "engine.evictions": 0},
        {"engine.builds": 1, "engine.evictions": 1}]
    assert s.book.counter("engine_builds") == 2
    assert s.book.counter("engine_evictions") == 1
    assert fac.engines.evictions == 1 and len(fac.engines) == 1
    snap = s.metrics_snapshot()
    assert snap["std_engine_builds_total"] == 2.0
    assert snap["std_engine_evictions_total"] == 1.0


def test_span_log_ring_is_bounded_and_gated():
    log = SpanLog(capacity=4)
    assert log.begin("x") is None and log.span("x").__enter__() is None
    with profiled(all_threads=False):
        for i in range(6):
            with log.span(f"s{i}"):
                pass
        root = log.request("r")
        t = threading.Thread(target=log.end, args=(root,))
        t.start()
        t.join(timeout=WAIT)
    assert not t.is_alive()
    got = log.records()
    assert [s.name for s in got] == ["s3", "s4", "s5", "r"]
    assert got[-1].req == got[-1].id and got[-1].parent is None


# ---------------------------------------------------------------------------
# The benchmark's readers of the log
# ---------------------------------------------------------------------------

MS = 1_000_000


def _hand_built_log():
    """Requests' ``mb.form`` of 1..20 ms, batches' ``mb.handoff`` of 2, 4
    and 9 ms and ``mb.complete`` of 1 and 3 ms, and two engine calls:
    10 ms with 3 ms of ``cc.sync`` (1 round), 20 ms with 5 ms (3)."""
    log = SpanLog()
    with profiled(all_threads=False):
        for i in range(1, 21):
            log.end(log.begin("mb.form", 0, scoped=False), i * MS)
        for d in (2, 4, 9):
            log.end(log.begin("mb.handoff", 0, scoped=False), d * MS)
        for d in (1, 3):
            log.end(log.begin("mb.complete", 0, scoped=False), d * MS)
        for t0, wall, syncs, rounds in ((0, 10, (1, 2), 1),
                                        (50, 20, (5,), 3)):
            run = log.begin("engine.run", t0 * MS)
            merge = log.begin("cc.merge", t0 * MS)
            for d in syncs:
                log.end(log.begin("cc.sync", t0 * MS), (t0 + d) * MS)
            log.end(merge, (t0 + sum(syncs)) * MS)
            log.end(run, (t0 + wall) * MS,
                    {"cc.rounds": rounds, "cc.syncs": rounds + 1})
    return log


READINGS = {
    "batcher.form_ms_p95.serve": float(np.percentile(range(1, 21), 95)),
    "batcher.handoff_ms_p95.serve": float(np.percentile([2, 4, 9], 95)),
    "complete.ms.serve": 2.0,
    "engine.launch_ms.serve": 11.0,
    "engine.launch_ms.bulk": 11.0,
    "cc.sync_ms.serve": 4.0,
    "cc.sync_ms.bulk": 4.0,
    "cc.rounds.serve": 2.0,
    "cc.rounds.bulk": 2.0,
}


def _reader(name):
    for p in (str(REPO), str(REPO / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    path = REPO / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "span_reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("name", sorted(READINGS))
def test_metric_reads_the_log(name, monkeypatch):
    read = _reader(name)
    card = {"ctx": SimpleNamespace(device="cuda")}
    monkeypatch.setattr(telemetry, "SPANS", SpanLog())
    assert read(card) is None
    monkeypatch.setattr(telemetry, "SPANS", _hand_built_log())
    assert read(card) == pytest.approx(READINGS[name])
    assert read({"ctx": SimpleNamespace(device="cpu")}) is None
    monkeypatch.delattr(telemetry, "SPANS")       # a program without it
    assert read(card) is None
