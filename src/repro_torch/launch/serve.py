"""STD serving: bucketed scene-text detection requests through the
microcode FCN engine, image to boxes, on one device.

A request goes through :meth:`STDService.preprocess` (transpose trick for
over-wide images, padding to a resolution bucket), :meth:`_dispatch`
(batch rounding, the bucket's engine from ``EngineFactory``: FCN forward
and CC labelling on the service's device, and with
``postprocess="device"`` the compact box tail on the same labels),
:meth:`_finalize` (the results to the host) and :meth:`postprocess` (the
boxes).  Three serving modes, as in the JAX package:

  * sequential: ``svc(image)``;
  * pipelined (paper C4): :meth:`serve_pipelined` overlaps preprocess,
    device inference and box postprocess of consecutive images on host
    threads (``runtime/pipeline.HostPipeline``);
  * micro-batched: :meth:`start_batched` / :meth:`submit` /
    :meth:`serve_batched` group requests by bucket in
    ``launch/batching.MicroBatcher``, which flushes on ``max_batch`` or
    ``max_wait_ms``, applies admission control (``max_pending``,
    ``admission``) and keeps up to ``inflight`` dispatched batches
    between its dispatch and completion threads.

Boxes come from either tail: ``postprocess="host"`` copies each label map
to the host and extracts boxes there; ``"device"`` compacts each map into
``(boxes_capacity + 1, 6)`` rows on the device, so only a few hundred
bytes per image cross to the host, and an image with more components than
the capacity falls back to its label map (counted in
``stats["pp_overflow"]``, never wrong).

On the card, the dispatch adds no host sync of its own: images cross in
pinned memory, the box tail is torch ops, and an event recorded after the
batch's work lets the completion thread copy the results on a side stream
as soon as that batch is done.  The engine's CC stitching still reads one
convergence flag per round (``postprocess.merge_rounds``).

Every layer writes into one ``runtime/telemetry.CostBook``: engine call
walls (``stage="dispatch"``), dispatch-through-copy walls (``"step"``),
per-image box walls (``"postprocess"``), the scheduler's series and the
engine counters; :meth:`metrics_snapshot` and :meth:`metrics_prometheus`
export it.  While a profile is active, :meth:`submit` opens each
request's ``std.request`` span in ``runtime/telemetry.SPANS`` (with
``std.preprocess``); the batcher's and engine's spans carry its id, and
the step and box walls are ``std.step`` and ``std.postprocess`` spans
read off the same clocks.  With
``activation_budget_bytes`` each bucket's batch cap is how many planned
per-image activation peaks (``core.memplan``) fit the budget, and
``engine_cache_bytes`` makes the engine LRU evict by planned bytes.

``model=`` picks the detection head from ``MODEL_ZOO``: ``"pixellink"``
(the default), ``"east"`` (host box tail only: its payload is a score
and a geometry map, no label map) or ``"db"``.

Plan routing (``runtime/executor.py``): either fixed rules, the service
``plan`` for every bucket and ``tall_plan`` for images taller than the
largest bucket, or a cost-model ``planner`` (``runtime/planner.Planner``)
that picks a plan per bucket from FLOPs, halo bytes and batch-split
occupancy (``stats["plan_choices"]``), over-tall buckets restricted to
the row-banded plans.  With ``measured_routing`` the planner reads this
service's measured step walls from the book (``MeasuredCost``).  With a
row-banded route configured, over-tall heights are padded to the band
unit and over-wide images are transposed onto it (paper §IV.B).  A plan
that splits the batch pads each batch to its data-axis multiple, which
``max_batch`` must be a multiple of.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --width 0.125 --batched --postprocess device
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --width 0.125 --batched --model east
"""
from __future__ import annotations

import argparse
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.batching import (LatencyRecorder, MicroBatcher,
                                         round_batch)
from repro_torch.runtime.executor import (
    EngineFactory,
    ExecutionPlan,
    SingleDevice,
    band_height_unit,
    check_precision,
    describe_plan,
    plan_batch_multiple,
    plan_kind,
)
from repro_torch.runtime.pipeline import HostPipeline
from repro_torch.runtime.planner import Planner, features_for_program
from repro_torch.runtime.telemetry import SPANS, CostBook, prometheus_text

MAX_WIDTH = 4096          # the paper's width limit


def bucket_hw(h: int, w: int, buckets: Tuple[int, ...]) -> Tuple[int, int]:
    """Padded bucket shape for an (h, w) image.  Oversize dimensions round
    up to the next multiple of the largest bucket; beyond MAX_WIDTH they
    fail fast."""
    top = max(buckets)

    def one(v: int) -> int:
        if v <= top:
            return min(b for b in buckets if b >= v)
        if v > MAX_WIDTH:
            raise ValueError(
                f"image dimension {v} exceeds the serving limit {MAX_WIDTH} "
                f"(paper §IV.B width bound)")
        return -(-v // top) * top

    return one(h), one(w)


class STDService:
    """Bucketed STD serving (on ``"cuda"`` by default, and on a mesh with
    a multi-device plan): sequential, pipelined and micro-batched."""

    def __init__(self, width: float = 0.25, mode: str = "optimized",
                 buckets: Tuple[int, ...] = (64, 128, 256),
                 score_thr: float = 0.5, link_thr: float = 0.5,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 batch_round: str = "pow2",
                 engine_cache_capacity: int = 16,
                 plan: Optional[ExecutionPlan] = None,
                 tall_plan: Optional[ExecutionPlan] = None,
                 planner: Optional[Planner] = None,
                 max_pending: int = 0, admission: str = "block",
                 inflight: int = 1, book: Optional[CostBook] = None,
                 measured_routing: bool = True,
                 precision: str = "f32", postprocess: str = "host",
                 boxes_capacity: int = 256, model: str = "pixellink",
                 memplan: bool = True,
                 activation_budget_bytes: Optional[int] = None,
                 engine_cache_bytes: int = 0,
                 merge_ch: Tuple[int, int, int] = (16, 16, 8),
                 device="cuda",
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
        from repro_torch.core import BFPConfig
        from repro_torch.models.fcn.heads import (
            DetectionModel, build_head, check_model)
        from repro_torch.models.fcn.pixellink import STDConfig

        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if postprocess not in ("host", "device"):
            raise ValueError(
                f"postprocess must be 'host' or 'device', got {postprocess!r}")
        if boxes_capacity < 1:
            raise ValueError("boxes_capacity must be >= 1")
        if inflight < 0:
            raise ValueError("inflight must be >= 0")
        self.plan: ExecutionPlan = plan if plan is not None else SingleDevice()
        plan_kind(self.plan)
        if tall_plan is not None:
            plan_kind(tall_plan)
        if planner is not None and not isinstance(planner, Planner):
            raise TypeError(f"planner must be a Planner, got {planner!r}")
        self.tall_plan = tall_plan
        self.planner = planner
        m = plan_batch_multiple(self.plan)
        if tall_plan is not None:
            m = max(m, plan_batch_multiple(tall_plan))
        if planner is not None:
            # the planner may route any bucket to a data-parallel or grid
            # plan, whose padded batches must stay within max_batch
            m = max(m, planner.data_n)
        if max_batch % m:
            raise ValueError(
                f"max_batch={max_batch} must be a multiple of the plan's "
                f"data-parallel width {m}, or padded batches would exceed "
                f"the configured maximum")
        self._batch_multiple = m
        self._mode = mode
        self.model_name = check_model(model)
        self.head = build_head(model, score_thr=score_thr, link_thr=link_thr)
        if postprocess == "device" and \
                not self.head.supports_device_postprocess:
            raise ValueError(
                f"model {model!r} has no label-map payload, so the "
                f"device-compact box tail does not apply; use "
                f"postprocess='host'")
        self.postprocess_mode = postprocess
        self.boxes_capacity = boxes_capacity
        self.precision = check_precision(precision)
        self.buckets = buckets
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.batch_round = batch_round
        self.max_pending = max_pending
        self.admission = admission
        self.inflight = inflight
        self.memplan_enabled = bool(memplan)
        self.activation_budget_bytes = activation_budget_bytes
        self._bucket_caps: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()
        self._batcher: Optional[MicroBatcher] = None
        self.book = book if book is not None else CostBook()

        def make_model(hw, precision="f32", model="pixellink"):
            # "bfp" is the paper's quantized datapath: BFP convs, FP16
            # storage, and the CUDA kernels (their plain versions on CPU)
            bfp = precision == "bfp"
            return DetectionModel(STDConfig(
                backbone="vgg16", width=width, image_size=hw,
                merge_ch=tuple(merge_ch), mode=mode,
                bfp=BFPConfig() if bfp else None, storage_fp16=bfp,
                use_kernels=bfp, memplan=memplan,
            ), build_head(model, score_thr=score_thr, link_thr=link_thr),
                device)

        self.factory = EngineFactory(
            make_model, score_thr=score_thr, link_thr=link_thr,
            capacity=engine_cache_capacity, device=device, book=self.book,
            engine_bytes_budget=engine_cache_bytes)
        self.device = self.factory.device
        # the completion thread copies results on its own stream, after
        # the dispatch's event, so a copy need not wait for later batches
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        if params is not None:
            self.factory.set_params(params, self.model_name)
        if planner is not None:
            planner.bind_features(self._plan_features,
                                  model=self.model_name)
            if measured_routing:
                # combos this service has run route by their measured
                # step walls, read from its own precision's and model's
                # series
                planner.use_measurements(self.book,
                                         precision=self.precision,
                                         model=self.model_name)
        self.stats: Dict[str, Any] = {"n": 0, "latency_s": [],
                                      "transposed": 0, "plan_choices": {},
                                      "nonconverged": 0, "pp_overflow": 0}

    @property
    def _engines(self):
        """The factory's engine LRU."""
        return self.factory.engines

    def _bucket_cap(self, hw: Tuple[int, int]) -> int:
        """Effective max batch for one bucket: with an activation budget,
        how many planned per-image peaks (``core.memplan``) fit it;
        without one, ``max_batch``.  Cached: the scheduler calls this
        under its lock."""
        if self.activation_budget_bytes is None or not self.memplan_enabled:
            return self.max_batch
        hw = tuple(hw)
        cap = self._bucket_caps.get(hw)
        if cap is None:
            from repro_torch.core.memplan import admissible_batch

            per_image = self.factory.memplan(
                hw, self.precision, self.model_name).peak_bytes
            cap = admissible_batch(per_image, self.activation_budget_bytes,
                                   multiple=self._batch_multiple)
            self._bucket_caps[hw] = cap
        return cap

    # -- plan routing ---------------------------------------------------------
    def _plan_features(self, hw: Tuple[int, int]):
        """Cost-model features of one bucket, from the program its engine
        runs (this service's model and precision)."""
        model = self.factory.model(tuple(hw), self.precision,
                                   self.model_name)
        return features_for_program(
            model.program,
            self.factory.deepest_stride(tuple(hw), self.precision,
                                        self.model_name),
            mode=self._mode)

    def _plan_for(self, hw: Tuple[int, int], batch: int = 1
                  ) -> ExecutionPlan:
        """With a planner, every bucket routes by estimated (or measured)
        step cost, over-tall ones (taller than the largest bucket) to the
        row-banded kinds where the mesh has them.  Without one, over-tall
        buckets go to ``tall_plan`` when set, the rest to ``plan``."""
        over_tall = hw[0] > max(self.buckets)
        if self.planner is not None:
            plan = self.planner.choose(hw, batch, force_banded=over_tall,
                                       model=self.model_name)
            with self._lock:
                self.stats["plan_choices"][tuple(hw)] = describe_plan(plan)
            return plan
        if self.tall_plan is not None and over_tall:
            return self.tall_plan
        return self.plan

    def _routes_banded(self) -> bool:
        """Whether over-tall and over-wide images can ride a row-banded
        plan (the fixed tall_plan rule or planner routing)."""
        return self.tall_plan is not None or self.planner is not None

    def _tall_height(self, bh: int) -> int:
        """Padded height of an over-tall image headed for a row-banded
        plan: rounded up to bands x deepest cumulative stride, so that
        every band divides evenly through the stride pyramid."""
        top = max(self.buckets)
        deepest = self.factory.deepest_stride((top, top), self.precision,
                                              self.model_name)
        if self.planner is not None:
            unit = self.planner.height_unit(deepest)
        else:
            unit = band_height_unit(self.tall_plan, deepest)
        return -(-bh // unit) * unit

    # -- stages ---------------------------------------------------------------
    def preprocess(self, img: np.ndarray):
        """Random-size handling: transpose trick + bucket padding."""
        h, w = img.shape[:2]
        transposed = False
        # paper §IV.B over-wide rule; with a row-banded route configured
        # any image wider than the largest bucket turns over-tall and
        # rides that route
        if w > MAX_WIDTH >= h or (
                self._routes_banded() and w > max(self.buckets) >= h):
            img = np.transpose(img, (1, 0, 2))
            h, w = w, h
            transposed = True
            with self._lock:
                self.stats["transposed"] += 1
        bh, bw = bucket_hw(h, w, self.buckets)
        if self._routes_banded() and bh > max(self.buckets):
            bh = self._tall_height(bh)
        pad = np.zeros((bh, bw, 3), np.float32)
        pad[:h, :w] = img
        return pad, (h, w), transposed

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @torch.no_grad()
    def _dispatch(self, stack: np.ndarray,
                  valid_hws: List[Tuple[int, int]]):
        """Route and pad the batch and queue its work: returns the pending
        device tuple ``(*payload, converged)`` of the head (``(labels,
        converged)`` for the CC heads), with the compact ``(rows,
        counts)`` boxes appended on the device route, and the meta ``(hw,
        batch, kind, t0, event, step)`` the completion path takes
        (``event`` is None off the card, ``step`` the open ``std.step``
        span or None)."""
        hw = tuple(stack.shape[1:3])
        n_live = len(valid_hws)
        b = round_batch(n_live, self._bucket_cap(hw), self.batch_round)
        plan = self._plan_for(hw, b)
        m = plan_batch_multiple(plan)
        b = -(-b // m) * m
        if b > n_live:
            stack = np.concatenate(
                [stack, np.zeros((b - n_live,) + stack.shape[1:],
                                 stack.dtype)])
        valid_q = np.zeros((b, 2), np.int32)
        for i, (vh, vw) in enumerate(valid_hws):
            valid_q[i] = (vh // 4, vw // 4)
        fn = self.factory.plan_fn(hw, b, plan, self.precision,
                                  self.model_name)
        params = self.factory.params(hw, self.precision, self.model_name)
        t0 = time.perf_counter_ns()
        step = SPANS.begin("std.step", t0, scoped=False)
        pending = fn(params, self._to_device(stack), self._to_device(valid_q))
        if self.postprocess_mode == "device":
            # labels are already valid-masked, so padding adds no
            # components; coordinates are label-map (quarter) pixels
            rows, counts = self.factory.boxes_fn(
                hw, b, self.boxes_capacity)(pending[0])
            pending = (*pending, rows, counts)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return pending, (hw, b, plan_kind(plan), t0, event, step)

    def _to_host(self, tensors, event) -> List[np.ndarray]:
        """Copy device tensors to the host once the batch's event has
        passed, on the copy stream."""
        if event is None:
            return [t.numpy() for t in tensors]
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(event)
            return [t.cpu().numpy() for t in tensors]

    def _record_step(self, meta) -> None:
        """One batch's dispatch-through-copy wall into the book, and its
        ``std.step`` span."""
        hw, b, kind, t0, _, step = meta
        t1 = time.perf_counter_ns()
        SPANS.end(step, t1)
        self.book.record_step(hw, b, kind, (t1 - t0) * 1e-9,
                              precision=self.precision,
                              model=self.model_name)

    def _count_nonconverged(self, converged: np.ndarray) -> None:
        """Count label maps whose CC loop hit max_iters still changing
        (padded slots are zero images and converge at once)."""
        k = int(np.size(converged) - np.count_nonzero(converged))
        if k:
            with self._lock:
                self.stats["nonconverged"] += k
            self.book.incr("pp_nonconverged", k)

    def dispatch_labels(self, stack: np.ndarray,
                        valid_hws: List[Tuple[int, int]]):
        """(B, bh, bw, 3) padded batch -> the pending device tuple
        ``(*payload, converged)`` (plus ``(rows, counts)`` on the device
        route), without waiting for it.  The batch axis may be padded past
        ``len(valid_hws)``."""
        return self._dispatch(stack, valid_hws)[0]

    def infer_labels(self, stack: np.ndarray,
                     valid_hws: List[Tuple[int, int]]) -> np.ndarray:
        """Padded batch (B, bh, bw, 3) -> the head's first payload on the
        host: label maps (B, bh/4, bw/4) for the CC heads, the masked
        score maps for EAST."""
        pending, meta = self._dispatch(stack, valid_hws)
        n = self.head.n_payload
        first, converged = self._to_host((pending[0], pending[n]), meta[4])
        self._record_step(meta)
        self._count_nonconverged(converged)
        return first

    def _finalize(self, raw) -> List[Any]:
        """One dispatched batch to the host, as one payload per batch slot:
        a ``(rows, count)`` tuple on the device route (the label map when
        the count overflows ``boxes_capacity``); on the host route the
        head's payload, the label map for the CC heads and a ``(score,
        geo)`` tuple for EAST.  Every tensor crosses on the copy stream
        after the batch's event.  Records the ``stage="step"`` wall."""
        pending, meta = raw
        event = meta[4]
        n = self.head.n_payload
        if self.postprocess_mode == "device":
            labels = pending[0]
            converged, rows, counts = self._to_host(pending[n:], event)
            self._record_step(meta)
            self._count_nonconverged(converged)
            out: List[Any] = []
            for i in range(rows.shape[0]):
                if counts[i] > self.boxes_capacity:
                    with self._lock:
                        self.stats["pp_overflow"] += 1
                    self.book.incr("pp_overflow")
                    out.append(self._to_host([labels[i]], event)[0])
                else:
                    out.append((rows[i], int(counts[i])))
            return out
        *arrs, converged = self._to_host(pending[:n + 1], event)
        self._record_step(meta)
        self._count_nonconverged(converged)
        if n == 1:
            return list(arrs[0])
        return [tuple(a[i] for a in arrs) for i in range(arrs[0].shape[0])]

    def postprocess(self, payload, valid_hw: Tuple[int, int],
                    transposed: bool,
                    bucket_hw: Optional[Tuple[int, int]] = None
                    ) -> List[Dict]:
        """One image's payload -> boxes (quarter-resolution pixels).  The
        wall lands in the book under ``stage="postprocess"``, keyed by the
        bucket (from the payload's plane when ``bucket_hw`` is not given;
        device-compact rows carry none) and the decode kind."""
        t0 = time.perf_counter_ns()
        span = SPANS.begin("std.postprocess", t0)
        try:
            boxes, kind = self.head.decode(payload, valid_hw)
        finally:
            t1 = time.perf_counter_ns()
            SPANS.end(span, t1)
        if bucket_hw is None:
            plane = self.head.payload_plane(payload)
            if plane is None:
                raise ValueError("device-compact payloads carry no plane "
                                 "shape; pass bucket_hw")
            bucket_hw = (plane[0] * 4, plane[1] * 4)
        self.book.record_step(tuple(bucket_hw), 1, kind, (t1 - t0) * 1e-9,
                              stage="postprocess", model=self.model_name)
        if transposed:
            for b in boxes:
                x0, y0, x1, y1 = b["box"]
                b["box"] = (y0, x0, y1, x1)
        return boxes

    def _record_request(self, dt: float) -> None:
        with self._lock:
            self.stats["n"] += 1
            self.stats["latency_s"].append(dt)

    # -- scrapeable metrics ---------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, float]:
        """Flat ``{metric_name: value}`` (labels embedded Prometheus-style):
        request counts and latency percentiles, the scheduler's stats (the
        live batcher's, else the last stopped one's), engine memory
        gauges, bucket batch caps and the whole book.  Safe from any
        thread."""
        out: Dict[str, float] = {}
        with self._lock:
            n = self.stats["n"]
            lat = list(self.stats["latency_s"])
            transposed = self.stats["transposed"]
            choices = dict(self.stats["plan_choices"])
            mb_snap = self.stats.get("batching_snapshot")
            batcher = self._batcher
        out["std_requests_total"] = float(n)
        out["std_transposed_total"] = float(transposed)
        if lat:
            out["std_request_latency_p50_ms"] = float(
                np.percentile(lat, 50) * 1e3)
            out["std_request_latency_p99_ms"] = float(
                np.percentile(lat, 99) * 1e3)
        for hw, desc in sorted(choices.items()):
            out[f'std_plan_choice{{bucket="{hw[0]}x{hw[1]}",'
                f'plan="{desc}"}}'] = 1.0
        if batcher is not None:
            mb_snap = batcher.stats_snapshot()
        for k, v in (mb_snap or {}).items():
            out[f"std_mb_{k}"] = float(v)
        for row in list(self.factory.stats["engine_memory"]):
            lbl = (f'bucket="{row["hw"][0]}x{row["hw"][1]}",'
                   f'batch="{row["batch"]}",plan="{row["plan"]}",'
                   f'model="{row["model"]}"')
            out[f"std_engine_planned_peak_bytes{{{lbl}}}"] = float(
                row["planned_peak_bytes"])
            for k in ("temp_bytes", "peak_bytes"):
                if k in row:
                    out[f"std_engine_{k}{{{lbl}}}"] = float(row[k])
        for hw, cap in sorted(self._bucket_caps.items()):
            out[f'std_bucket_batch_cap{{bucket="{hw[0]}x{hw[1]}"}}'] = \
                float(cap)
        out.update(self.book.snapshot())
        return out

    def metrics_prometheus(self) -> str:
        """:meth:`metrics_snapshot` in Prometheus text-exposition form."""
        return prometheus_text(self.metrics_snapshot())

    def queue_gauges(self) -> Dict[str, float]:
        """Queued requests and in-flight batches (zeros without a running
        batcher)."""
        batcher = self._batcher
        if batcher is None:
            return {"queue_depth": 0.0, "inflight": 0.0}
        snap = batcher.stats_snapshot()
        return {"queue_depth": snap.get("queue_depth", 0.0),
                "inflight": snap.get("inflight", 0.0)}

    def measure_engine_memory(self, hw: Tuple[int, int],
                              batch: Optional[int] = None) -> Dict[str, Any]:
        """Measure one bucket engine's memory at ``batch`` (default: the
        bucket's cap), rounded to the batch multiple, under the plan
        routing picks; see ``EngineFactory.measure_engine_memory``.  The
        row lands in the ``std_engine_*_bytes`` gauges."""
        hw = tuple(hw)
        b = int(batch) if batch is not None else self._bucket_cap(hw)
        m = self._batch_multiple
        b = -(-b // m) * m
        return self.factory.measure_engine_memory(
            hw, b, self._plan_for(hw, b), self.precision, self.model_name)

    def __call__(self, img: np.ndarray) -> List[Dict]:
        t0 = time.perf_counter()
        x, valid, tr = self.preprocess(img)
        out = self._finalize(self._dispatch(x[None], [valid]))[0]
        boxes = self.postprocess(out, valid, tr, bucket_hw=tuple(x.shape[:2]))
        self._record_request(time.perf_counter() - t0)
        return boxes

    # -- pipelined server (C4 module-level multithreading) --------------------
    def serve_pipelined(self, images: List[np.ndarray]) -> List[List[Dict]]:
        def infer(item):
            x, valid, tr = item
            out = self._finalize(self._dispatch(x[None], [valid]))[0]
            return out, valid, tr, tuple(x.shape[:2])

        def post(item):
            out, valid, tr, bhw = item
            return self.postprocess(out, valid, tr, bucket_hw=bhw)

        pipe = HostPipeline([self.preprocess, infer, post], maxsize=4)
        t0 = time.perf_counter()
        results = pipe.run(images)
        with self._lock:
            self.stats["pipelined_tps"] = len(images) / (
                time.perf_counter() - t0)
        return results

    # -- micro-batched server -------------------------------------------------
    def _mb_infer(self, key, payloads):
        """Dispatch stage: queue one batch and return it pending."""
        stack = np.stack([p[0] for p in payloads])
        return self._dispatch(stack, [p[1] for p in payloads])

    def _mb_finalize(self, key, raw):
        """Completion stage: the batch to the host, one payload per slot
        (the batch axis may be padded; the scheduler zips live items)."""
        return self._finalize(raw)

    def _mb_post(self, payload, out):
        x, valid, tr = payload
        return self.postprocess(out, valid, tr, bucket_hw=tuple(x.shape[:2]))

    def start_batched(self) -> "STDService":
        """Start the micro-batching scheduler (idempotent)."""
        if self._batcher is None:
            self._batcher = MicroBatcher(
                self._mb_infer, self._mb_post,
                finalize_fn=self._mb_finalize,
                max_batch=self.max_batch, max_wait_ms=self.max_wait_ms,
                max_pending=self.max_pending, admission=self.admission,
                inflight=self.inflight, book=self.book,
                max_batch_for=(self._bucket_cap
                               if self.activation_budget_bytes is not None
                               else None))
            self._batcher.start()
        return self

    def stop_batched(self) -> None:
        if self._batcher is not None:
            self._batcher.stop()
            with self._lock:
                self.stats["batching"] = self._batcher.stats
                self.stats["batching_snapshot"] = \
                    self._batcher.stats_snapshot()
            self._batcher = None

    def submit(self, img: np.ndarray) -> Future:
        """Async request: preprocess on the caller's thread, then enqueue
        on the bucket's micro-batch."""
        if self._batcher is None:
            raise RuntimeError("call start_batched() first")
        root = SPANS.request("std.request")
        with SPANS.span("std.preprocess", root):
            x, valid, tr = self.preprocess(img)
        return self._batcher.submit(x.shape[:2], (x, valid, tr), span=root)

    def serve_batched(self, images: List[np.ndarray], *,
                      pre_workers: int = 4) -> List[List[Dict]]:
        """Closed-loop batched serving: preprocess and submit from a small
        thread pool (so buckets fill), gather the futures in order."""
        started_here = self._batcher is None
        self.start_batched()
        rec = LatencyRecorder()
        t0 = time.perf_counter()

        def one(img):
            t = time.perf_counter()
            return rec.track(self.submit(img), t0=t)

        try:
            with ThreadPoolExecutor(pre_workers) as ex:
                futs = list(ex.map(one, images))
            results = [f.result(timeout=600) for f in futs]
            dt = time.perf_counter() - t0
            rec.wait(600)
            with self._lock:
                self.stats["batched_tps"] = len(images) / dt
                self.stats["batched_latency_s"] = rec.samples
            return results
        finally:
            if started_here:
                self.stop_batched()


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve random-size STD requests sequentially, pipelined "
                    "and (with --batched) micro-batched.")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--width", type=float, default=0.25)
    ap.add_argument("--mode", default="optimized")
    ap.add_argument("--batched", action="store_true",
                    help="also run the micro-batched scheduler path")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--precision", default="f32", choices=["f32", "bfp"])
    ap.add_argument("--postprocess", default="host",
                    choices=["host", "device"],
                    help="box extraction: host label-map decode or "
                         "compact rows on the device")
    ap.add_argument("--model", default="pixellink",
                    choices=["pixellink", "east", "db"],
                    help="detection head to serve (models/fcn/heads.py "
                         "MODEL_ZOO)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.data.images import RequestStream

    svc = STDService(width=args.width, mode=args.mode,
                     max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                     precision=args.precision, postprocess=args.postprocess,
                     model=args.model, device=args.device)
    images = RequestStream(
        args.requests, seed=0, hw_range=((48, 120), (48, 120))).images()
    t0 = time.perf_counter()        # includes each bucket's first build
    for img in images:
        svc(img)
    seq_dt = time.perf_counter() - t0
    out = svc.serve_pipelined(images)
    msg = (f"[serve] {args.requests} reqs on {svc.device}  "
           f"sequential {args.requests / seq_dt:.2f} TPS  "
           f"pipelined {svc.stats['pipelined_tps']:.2f} TPS")
    if args.batched:
        out_b = svc.serve_batched(images)
        if [[b["box"] for b in r] for r in out] != \
                [[b["box"] for b in r] for r in out_b]:
            raise SystemExit("batched boxes differ from pipelined boxes")
        msg += f"  batched {svc.stats['batched_tps']:.2f} TPS"
        sizes = [b["n"] for b in svc.stats["batching"]["batches"]]
        msg += f"  mean batch {np.mean(sizes):.2f}"
    msg += (f"  median latency {np.median(svc.stats['latency_s']) * 1e3:.1f}"
            f" ms  boxes[0]={len(out[0])}")
    print(msg)
    return svc.stats


if __name__ == "__main__":
    main()
