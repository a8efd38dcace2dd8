"""Drive ``STDService`` (``repro_torch.launch.serve``) as its users do.

``loop: "open"``: requests due at the mix's Poisson schedule
(``traffic.arrivals``) go through ``start_batched()`` / ``submit()``, the
micro-batched path, whether or not earlier ones are done; each is timed
from the moment it was due to the moment its boxes are on the host (its
future resolves).  How late the sender ran is noted on stderr.

``loop: "closed"``: one client calls ``svc(image)`` (the sequential
path, no batcher) back to back; each request is timed from its send.

Set-up warms every (bucket, batch) shape the mix's images reach: each
bucket at batch 1, and at every power of two up to ``max_batch`` when
batched, through the same dispatch and box tail, with pool images; when
batched, bursts of whole batches through the batcher besides.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import traffic
from perfbench.harness import BenchError, Window
from perfbench.taps import Tap

MODEL = "pixellink"
BURSTS = 4


def bucket(n: int, buckets) -> int:
    """The serving rule for one side at most the largest bucket."""
    return min(b for b in buckets if b >= n)


def _boxes(result) -> List[Tuple[int, ...]]:
    return [(b["label"], *b["box"], b["area"]) for b in result]


class Driver:
    def __init__(self, ctx, params, pool):
        from repro_torch.launch.serve import STDService

        cfg, mix = ctx.config, ctx.traffic
        if cfg["backbone"] != "vgg16" or cfg["head"] != MODEL:
            raise BenchError("STDService serves PixelLink VGG-16 only")
        if cfg["bfp"] != {"block_size": 32, "mantissa_bits": 10,
                          "rounding": "trunc", "wide_accum": True} \
                or not cfg["storage_fp16"] or not cfg["use_kernels"]:
            raise BenchError("STDService's bfp precision fixes the "
                             "default BFPConfig, FP16 storage and kernels")
        self.ctx, self.mix, self.pool = ctx, mix, pool
        self.batched = mix["loop"] == "open"
        self.svc = STDService(
            width=cfg["width"], mode=cfg["mode"],
            buckets=tuple(mix["buckets"]), score_thr=cfg["score_thr"],
            link_thr=cfg["link_thr"], max_batch=int(mix["max_batch"]),
            max_wait_ms=float(mix["max_wait_ms"]),
            inflight=int(mix["inflight"]), precision="bfp",
            postprocess=mix["postprocess"],
            boxes_capacity=int(mix["boxes_capacity"]),
            merge_ch=tuple(cfg["merge_ch"]), memplan=cfg["memplan"],
            device=ctx.device, params=params)
        bks = tuple(mix["buckets"])
        shapes = sorted({(bucket(im.shape[0], bks), bucket(im.shape[1], bks))
                         for im in pool})
        self.tap = Tap(self.svc.factory,
                       [self.svc.factory.model(hw, "bfp", MODEL)
                        for hw in shapes], int(ctx.cell["sample_calls"]),
                       ctx.seed)
        self._warm(shapes)

    def _sync(self):
        if self.svc.device.type == "cuda":
            torch.cuda.synchronize(self.svc.device)

    def _warm(self, shapes) -> None:
        by_hw: Dict[Tuple[int, int], List[np.ndarray]] = {}
        bks = tuple(self.mix["buckets"])
        for im in self.pool:
            hw = (bucket(im.shape[0], bks), bucket(im.shape[1], bks))
            by_hw.setdefault(hw, []).append(im)
        sizes = [1]
        while self.batched and sizes[-1] * 2 <= int(self.mix["max_batch"]):
            sizes.append(sizes[-1] * 2)
        for hw in shapes:
            ims = by_hw[hw]
            for b in sizes:
                pick = [ims[i % len(ims)] for i in range(b)]
                pre = [self.svc.preprocess(im) for im in pick]
                self.svc.dispatch_labels(np.stack([p[0] for p in pre]),
                                         [p[1] for p in pre])
                self._sync()
            self.svc(ims[0])
        if self.batched:
            self.svc.start_batched()
            # bursts of whole batches, as many as the batcher holds alive
            # (one dispatching, ``inflight`` queued, one completing), so that
            # set-up holds what overlapping batches of ``max_batch`` take;
            # one burst overlaps them in most runs, not all
            n = (int(self.mix["inflight"]) + 2) * int(self.mix["max_batch"])
            for _ in range(BURSTS):
                futs = [self.svc.submit(ims[i % len(ims)])
                        for ims in by_hw.values() for i in range(n)]
                for f in futs:
                    f.result(timeout=300)
        self._sync()

    # -- the window -----------------------------------------------------------
    def _book(self) -> Dict[str, Tuple[float, int]]:
        """(total s, count) of the book's step and postprocess walls."""
        book = self.svc.book
        out = {}
        for stage, prec in (("step", "bfp"), ("postprocess", "f32")):
            keys = book.step_keys(stage=stage, precision=prec, model=MODEL)
            out[stage] = (
                sum(book.step_total(*k, stage=stage, precision=prec,
                                    model=MODEL) for k in keys),
                sum(book.step_count(*k, stage=stage, precision=prec,
                                    model=MODEL) for k in keys))
        return out

    def _n_batches(self) -> int:
        snap = self.svc.metrics_snapshot()
        return int(sum(snap.get(f"std_mb_flush_{r}", 0.0)
                       for r in ("full", "timeout", "drain")))

    def window(self, seconds: float, tracer) -> Window:
        book0 = self._book()
        over0 = self.svc.stats["pp_overflow"]
        n0 = self._n_batches() if self.batched else 0
        self.tap.arm()
        if self.batched:
            win = self._open(seconds, tracer)
            n1 = self._n_batches()
            self.svc.stop_batched()
            batches = self.svc.stats["batching"]["batches"][n0:n1]
            win.batches = len(batches)
            win.stats["batches"] = [(b["n"], b["queued_ms"])
                                    for b in batches]
        else:
            win = self._closed(seconds, tracer)
        self.tap.disarm()
        win.notes["overflow"] = (f"{self.svc.stats['pp_overflow'] - over0}"
                                 f" images overflowed "
                                 f"{self.mix['boxes_capacity']} boxes")
        book1 = self._book()
        win.stats["book"] = {k: (book1[k][0] - book0[k][0],
                                 book1[k][1] - book0[k][1]) for k in book1}
        return win

    def _open(self, seconds: float, tracer) -> Window:
        due = traffic.arrivals(self.mix, self.ctx.seed, seconds)
        order = traffic.request_order(self.mix, self.ctx.seed, len(due))
        n = len(due)
        done = [None] * n
        served: List = [None] * n
        left = threading.Semaphore(0)

        def finish(i, fut):
            done[i] = time.perf_counter()
            if fut.exception() is None:
                served[i] = _boxes(fut.result())
            else:
                errors.append(repr(fut.exception()))
            left.release()

        late, errors = [], []
        tracer.start_quiet()
        t0 = time.perf_counter() + 0.05
        tracer.plan(t0, seconds)
        for i in range(n):
            t_due = t0 + due[i]
            now = time.perf_counter()
            if now < t_due:
                # one sleep: polling would take the GIL from the service
                time.sleep(t_due - now)
                now = time.perf_counter()
            tracer.tick(now)
            late.append(now - t_due)
            try:
                fut = self.svc.submit(self.pool[order[i]])
            except Exception as e:  # a refused request counts as failed
                errors.append(repr(e))
                left.release()
                continue
            fut.add_done_callback(lambda f, i=i: finish(i, f))
        end = t0 + seconds
        deadline = end + 60.0
        tracer.mark_end()
        for _ in range(n):
            if not left.acquire(timeout=max(deadline - time.perf_counter(),
                                            0.0)):
                break
        tracer.finish()
        lat = [done[i] - (t0 + due[i]) for i in range(n)
               if done[i] is not None and served[i] is not None]
        failed = n - len(lat)
        last = max((d for d in done if d is not None), default=end)
        notes = {"open_loop": f"{n} requests due in {seconds:.3f} s; "
                              f"sender late p50 {np.median(late) * 1e3:.3f}"
                              f" ms, max {max(late) * 1e3:.3f} ms; last "
                              f"result {last - end:.3f} s after the window"}
        if lat:
            # the tail, unjudged: between runs it spreads past any bound
            notes["latency_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
        if errors:
            notes["errors"] = f"{len(errors)}, first: {errors[0]}"
        return Window(attempted=n, failed=failed,
                      served=[(int(order[i]), served[i]) for i in range(n)],
                      seconds=seconds, latencies_s=lat, images=len(lat),
                      notes=notes)

    def _closed(self, seconds: float, tracer) -> Window:
        order = traffic.request_order(self.mix, self.ctx.seed,
                                      int(seconds * 1000) + 1)
        lat, served, errors = [], [], []
        t0 = time.perf_counter()
        tracer.plan(t0, seconds)
        i = 0
        while True:
            t = time.perf_counter()
            tracer.tick(t)
            if t >= t0 + seconds:
                break
            j = int(order[i])
            i += 1
            try:
                boxes = _boxes(self.svc(self.pool[j]))
            except Exception as e:  # a request that errors counts as failed
                errors.append(repr(e))
                served.append((j, None))
                continue
            lat.append(time.perf_counter() - t)
            served.append((j, boxes))
        tracer.finish()
        notes = {"errors": f"{len(errors)}, first: {errors[0]}"} \
            if errors else {}
        return Window(attempted=i, failed=len(errors), served=served,
                      seconds=time.perf_counter() - t0, latencies_s=lat,
                      images=len(lat), notes=notes)

    def close(self) -> None:
        self.svc.stop_batched()
        del self.svc
