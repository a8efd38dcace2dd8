"""STD serving: bucketed scene-text detection requests through the
microcode FCN engine, image to boxes.

A request goes through :meth:`STDService.preprocess` (transpose trick for
over-wide images, padding to a resolution bucket), :meth:`_dispatch`
(batch rounding, the engine of ``EngineFactory`` for the bucket: FCN
forward + CC labelling on the service's device), :meth:`_finalize` (the
label maps to the host) and :meth:`postprocess` (host box extraction).

This slice ports the single-device, sequential path.  Micro-batched and
pipelined serving, the cost-model planner, multi-device plans, the
device-side box tail, telemetry and memory-budget batch caps are not
ported yet: asking for any of them raises ``NotImplementedError``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.batching import round_batch
from repro_torch.runtime.executor import (
    EngineFactory,
    SingleDevice,
    check_plan,
    check_precision,
)

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


def _not_ported(**options) -> None:
    for name, value in options.items():
        if value:
            raise NotImplementedError(
                f"STDService option {name}={value!r} is not ported to "
                f"repro_torch yet")


class STDService:
    """Bucketed STD serving on one device (``"cuda"`` by default)."""

    def __init__(self, width: float = 0.25, mode: str = "optimized",
                 buckets: Tuple[int, ...] = (64, 128, 256),
                 score_thr: float = 0.5, link_thr: float = 0.5,
                 max_batch: int = 8, batch_round: str = "pow2",
                 engine_cache_capacity: int = 16,
                 precision: str = "f32", postprocess: str = "host",
                 model: str = "pixellink", memplan: bool = True,
                 merge_ch: Tuple[int, int, int] = (16, 16, 8),
                 device="cuda",
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 plan=None, tall_plan=None, planner=None, book=None,
                 activation_budget_bytes: Optional[int] = None):
        from repro_torch.core import BFPConfig
        from repro_torch.models.fcn.heads import (
            DetectionModel, build_head, check_model)
        from repro_torch.models.fcn.pixellink import STDConfig

        if postprocess not in ("host", "device"):
            raise ValueError(
                f"postprocess must be 'host' or 'device', got {postprocess!r}")
        _not_ported(postprocess_device=postprocess == "device",
                    tall_plan=tall_plan, planner=planner, book=book,
                    activation_budget_bytes=activation_budget_bytes)
        if plan is not None:
            check_plan(plan)
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.model_name = check_model(model)
        self.head = build_head(model, score_thr=score_thr, link_thr=link_thr)
        self.precision = check_precision(precision)
        self.plan = SingleDevice()
        self.buckets = buckets
        self.max_batch = max_batch
        self.batch_round = batch_round
        self._lock = threading.Lock()

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
            capacity=engine_cache_capacity, device=device)
        self.device = self.factory.device
        if params is not None:
            self.factory.set_params(params, self.model_name)
        self.stats: Dict[str, Any] = {"n": 0, "latency_s": [],
                                      "transposed": 0, "nonconverged": 0}

    # -- stages ---------------------------------------------------------------
    def preprocess(self, img: np.ndarray):
        """Random-size handling: transpose trick + bucket padding."""
        h, w = img.shape[:2]
        transposed = False
        if w > MAX_WIDTH >= h:
            img = np.transpose(img, (1, 0, 2))
            h, w = w, h
            transposed = True
            with self._lock:
                self.stats["transposed"] += 1
        bh, bw = bucket_hw(h, w, self.buckets)
        pad = np.zeros((bh, bw, 3), np.float32)
        pad[:h, :w] = img
        return pad, (h, w), transposed

    def _dispatch(self, stack: np.ndarray,
                  valid_hws: List[Tuple[int, int]]):
        """Pad the batch, run the bucket's engine; returns the device
        tuple ``(labels, converged)`` and ``(hw, batch, t0)``."""
        hw = tuple(stack.shape[1:3])
        n_live = len(valid_hws)
        b = round_batch(n_live, self.max_batch, self.batch_round)
        if b > n_live:
            stack = np.concatenate(
                [stack, np.zeros((b - n_live,) + stack.shape[1:],
                                 stack.dtype)])
        valid_q = np.zeros((b, 2), np.int32)
        for i, (vh, vw) in enumerate(valid_hws):
            valid_q[i] = (vh // 4, vw // 4)
        fn = self.factory.plan_fn(hw, b, self.plan, self.precision,
                                  self.model_name)
        params = self.factory.params(hw, self.precision, self.model_name)
        t0 = time.perf_counter()
        pending = fn(params, torch.from_numpy(stack).to(self.device),
                     torch.from_numpy(valid_q).to(self.device))
        return pending, (hw, b, t0)

    def _count_nonconverged(self, converged: np.ndarray) -> None:
        k = int(np.size(converged) - np.count_nonzero(converged))
        if k:
            with self._lock:
                self.stats["nonconverged"] += k

    def _finalize(self, raw) -> List[np.ndarray]:
        """The label maps to the host, one per batch slot."""
        (labels, converged), _ = raw
        labels = labels.cpu().numpy()
        self._count_nonconverged(converged.cpu().numpy())
        return [labels[i] for i in range(labels.shape[0])]

    def infer_labels(self, stack: np.ndarray,
                     valid_hws: List[Tuple[int, int]]) -> np.ndarray:
        """Padded batch (B, bh, bw, 3) -> label maps (B, bh/4, bw/4)."""
        return np.stack(self._finalize(self._dispatch(stack, valid_hws)))

    def postprocess(self, payload, valid_hw: Tuple[int, int],
                    transposed: bool) -> List[Dict]:
        """One image's label map -> boxes (quarter-resolution pixels)."""
        boxes, _ = self.head.decode(payload, valid_hw)
        if transposed:
            for b in boxes:
                x0, y0, x1, y1 = b["box"]
                b["box"] = (y0, x0, y1, x1)
        return boxes

    def __call__(self, img: np.ndarray) -> List[Dict]:
        t0 = time.perf_counter()
        x, valid, tr = self.preprocess(img)
        out = self._finalize(self._dispatch(x[None], [valid]))[0]
        boxes = self.postprocess(out, valid, tr)
        with self._lock:
            self.stats["n"] += 1
            self.stats["latency_s"].append(time.perf_counter() - t0)
        return boxes

    # -- serving modes of the reference that are not ported yet ----------------
    def serve_pipelined(self, images):
        raise NotImplementedError("HostPipeline serving is not ported yet")

    def start_batched(self):
        raise NotImplementedError("MicroBatcher serving is not ported yet")

    def submit(self, img):
        raise NotImplementedError("MicroBatcher serving is not ported yet")

    def serve_batched(self, images, **kw):
        raise NotImplementedError("MicroBatcher serving is not ported yet")

    def metrics_snapshot(self):
        raise NotImplementedError("CostBook telemetry is not ported yet")
