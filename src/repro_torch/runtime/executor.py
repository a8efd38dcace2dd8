"""Engine factory: one seam from an assembled model to a serving engine.

:class:`EngineFactory` builds, per ``(bucket_hw, precision, model)``, the
:class:`~repro_torch.models.fcn.heads.DetectionModel` and its parameters,
and per ``(bucket_hw, batch, plan, precision, model)`` the engine
callable ``fn(params, x, valid_q) -> (*payload, converged)``: the FCN
forward pass and the head's tail, per-image valid-region masking and,
for the CC heads (PixelLink, DB), batched CC labelling to ``(labels,
converged)``; EAST returns ``(score, geo, converged)``.

Parameters are per precision without being independent: the f32 entry
holds the seeded He init (or weights the caller handed over with
:meth:`EngineFactory.set_params`), and the bfp entry holds the SAME
weights run through the bfp model's ``normalize_weights`` (paper Fig. 4:
BN fold + BFP weight roundtrip), so both precisions share one weight set.

On the card the CC tail runs K3 (``kernels/cc_label``), on the CPU the
plain ``postprocess.cc_label_batched``.  :meth:`EngineFactory.boxes_fn`
is the device box tail (``postprocess.boxes_from_labels_batched_torch``)
that ``postprocess="device"`` serving runs on the engine's labels.

With a telemetry ``book`` (``runtime/telemetry.CostBook``) every engine is
wrapped once to record its call wall under ``stage="dispatch"``.  The
engine LRU can also evict by planned bytes (``engine_bytes_budget``): each
engine is put with the weight :meth:`engine_weight_bytes`, its
``core.memplan`` activation peak times its batch.  Only the single-device
plan is ported; the reference's DataParallel, RowBand and GridPlan are
not.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import resolve_device
from repro_torch.launch.batching import LRUCache
from repro_torch.models.fcn.heads import (DEFAULT_MODEL, _valid_mask,
                                          check_model)

PRECISIONS = ("f32", "bfp")
SEED = 0            # torch.Generator seed of the He init


@dataclasses.dataclass(frozen=True)
class SingleDevice:
    """Run the whole (bucket, batch) shape on the factory's device."""


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return precision


def check_plan(plan) -> None:
    if not isinstance(plan, SingleDevice):
        raise NotImplementedError(
            f"execution plan {plan!r} is not ported; only SingleDevice is")


def plan_kind(plan) -> str:
    """The telemetry kind string of a plan (the CostBook's ``plan`` key)."""
    check_plan(plan)
    return "single_device"


def _tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


class EngineFactory:
    """``make_model(hw, precision, model)`` builds the model for one input
    plane on ``device``; the factory caches models, parameters and
    engines in LRUs of ``capacity`` entries."""

    def __init__(self, make_model: Callable[..., Any], *,
                 score_thr: float = 0.5, link_thr: float = 0.5,
                 capacity: int = 16, device="cuda", book: Any = None,
                 engine_bytes_budget: int = 0):
        self.make_model = make_model
        self.device = resolve_device(device)
        self.score_thr = score_thr
        self.link_thr = link_thr
        self.book = book
        self._weights: Dict[str, Dict] = {}
        self._models = LRUCache(capacity)
        self._params = LRUCache(capacity)
        self._engines = LRUCache(capacity, byte_budget=engine_bytes_budget)
        self._memplans = LRUCache(capacity)
        # the scheduler thread plans memory while the dispatch thread
        # builds engines: model and parameter builds hold this lock
        self._lock = threading.RLock()
        self.stats: Dict[str, Any] = {"compiled": [], "engine_memory": []}
        self._mem_measured: Dict[Any, Dict[str, Any]] = {}

    def _key(self, hw, precision, model):
        check_precision(precision)
        check_model(model)
        return (tuple(hw), precision, model)

    # -- model / param caches -------------------------------------------------
    def model(self, hw: Tuple[int, int], precision: str = "f32",
              model: str = DEFAULT_MODEL):
        key = self._key(hw, precision, model)
        with self._lock:
            m = self._models.get(key)
            if m is None:
                m = self.make_model(tuple(hw), precision, model)
                self._models.put(key, m)
            return m

    def set_params(self, params: Dict[str, Dict[str, torch.Tensor]],
                   model: str = DEFAULT_MODEL) -> None:
        """Use ``params`` (the f32 weights, e.g. from
        ``models.fcn.params_from_numpy``) for every bucket of ``model``:
        the network is fully convolutional, so one set fits every plane."""
        check_model(model)
        self._weights[model] = {
            name: {k: v.to(self.device) for k, v in leaves.items()}
            for name, leaves in params.items()
        }
        self._params = LRUCache(self._params.capacity)

    def params(self, hw: Tuple[int, int], precision: str = "f32",
               model: str = DEFAULT_MODEL):
        key = self._key(hw, precision, model)
        with self._lock:
            p = self._params.get(key)
            if p is not None:
                return p
            model_obj = self.model(hw, precision, model)
            if precision != "f32":
                p = model_obj.normalize_weights(
                    self.params(hw, "f32", model))
            elif model in self._weights:
                p = self._weights[model]
            else:
                p = model_obj.init_params(
                    torch.Generator().manual_seed(SEED))
            self._params.put(key, p)
            return p

    # -- memory plan ----------------------------------------------------------
    def memplan(self, hw: Tuple[int, int], precision: str = "f32",
                model: str = DEFAULT_MODEL):
        """The static memory plan (``core.memplan.MemPlan``) of the program
        assembled at ``hw``, cached per (hw, precision, model).  Bytes
        follow the precision's storage: f32 activations take 4 bytes, bfp
        serving stores fp16 between layers (2)."""
        from repro_torch.core.memplan import plan_program

        key = self._key(hw, precision, model)
        plan = self._memplans.get(key)
        if plan is None:
            prog = self.model(hw, precision, model).program
            plan = plan_program(prog,
                                dtype_bytes=2 if precision == "bfp" else 4)
            self._memplans.put(key, plan)
        return plan

    def engine_weight_bytes(self, hw: Tuple[int, int], batch: int,
                            precision: str = "f32",
                            model: str = DEFAULT_MODEL) -> int:
        """Planned activation footprint of one engine: the byte weight its
        LRU entry carries."""
        return int(self.memplan(hw, precision, model).peak_bytes) * int(batch)

    def deepest_stride(self, hw: Tuple[int, int], precision: str = "f32",
                       model: str = DEFAULT_MODEL) -> int:
        """Deepest cumulative stride of the program assembled at ``hw``."""
        prog = self.model(tuple(hw), precision, model).program
        return max(hw[0] // max(h, 1) for h, _, _ in prog.addr_shapes.values())

    def measure_engine_memory(self, hw: Tuple[int, int], batch: int,
                              plan=None, precision: str = "f32",
                              model: str = DEFAULT_MODEL) -> Dict[str, Any]:
        """Measure one engine shape's memory and append the row to
        ``stats["engine_memory"]`` (memoized per shape).

        The JAX package reads XLA's buffer assignment; PyTorch has none.
        On the card, one engine call on zero images runs between
        ``torch.cuda.reset_peak_memory_stats()`` and
        ``torch.cuda.max_memory_allocated()``: ``temp_bytes`` is the most
        the call allocated above what was resident when it began (its
        scratch and its outputs), ``argument_bytes`` the parameters,
        images and valid sizes it reads, and ``peak_bytes`` their sum.
        On the CPU nothing is measured and the row carries only
        ``planned_peak_bytes`` (:meth:`engine_weight_bytes`)."""
        plan = SingleDevice() if plan is None else plan
        hw = tuple(hw)
        key = (hw, int(batch), plan, precision, model)
        got = self._mem_measured.get(key)
        if got is not None:
            return got
        row = {"hw": hw, "batch": int(batch), "plan": plan_kind(plan),
               "precision": precision, "model": model,
               "planned_peak_bytes": self.engine_weight_bytes(
                   hw, batch, precision, model)}
        if self.device.type == "cuda":
            params = self.params(hw, precision, model)
            fn = self._compile_single(hw, precision, model)
            x = torch.zeros((int(batch), hw[0], hw[1], 3),
                            dtype=torch.float32, device=self.device)
            vq = torch.full((int(batch), 2), hw[0] // 4, dtype=torch.int32,
                            device=self.device)
            vq[:, 1] = hw[1] // 4
            torch.cuda.synchronize(self.device)
            before = torch.cuda.memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
            out = fn(params, x, vq)
            torch.cuda.synchronize(self.device)
            temp = torch.cuda.max_memory_allocated(self.device) - before
            del out
            args = _tensor_bytes(params) + _tensor_bytes((x, vq))
            row.update(temp_bytes=int(temp), argument_bytes=int(args),
                       peak_bytes=int(temp + args))
        self._mem_measured[key] = row
        self.stats["engine_memory"].append(row)
        return row

    # -- engines --------------------------------------------------------------
    @property
    def engines(self) -> LRUCache:
        return self._engines

    def plan_fn(self, hw: Tuple[int, int], batch: int, plan=None,
                precision: str = "f32", model: str = DEFAULT_MODEL
                ) -> Callable:
        """The engine for one (bucket, batch, plan, precision, model) key,
        built on a miss and put in the LRU with its planned bytes."""
        plan = SingleDevice() if plan is None else plan
        check_plan(plan)
        key = (tuple(hw), int(batch), plan, precision, model)
        fn = self._engines.get(key)
        if fn is not None:
            return fn
        fn = self._compile_single(tuple(hw), precision, model)
        if self.book is not None:
            fn = self._timed(fn, tuple(hw), int(batch), plan_kind(plan),
                             precision, model)
        self.stats["compiled"].append(
            {"hw": tuple(hw), "batch": int(batch), "plan": plan_kind(plan),
             "precision": precision, "model": model})
        self._engines.put(key, fn, weight=self.engine_weight_bytes(
            hw, batch, precision, model))
        return fn

    def _timed(self, fn: Callable, hw, batch: int, kind: str,
               precision: str, model: str) -> Callable:
        """Record each engine call's wall into the book (the DISPATCH
        side: the wall ends when the call returns, not when the card is
        done)."""
        def timed(params, x, valid_q):
            t0 = time.perf_counter()
            out = fn(params, x, valid_q)
            self.book.record_step(hw, batch, kind, time.perf_counter() - t0,
                                  stage="dispatch", precision=precision,
                                  model=model)
            return out

        return timed

    def boxes_fn(self, hw: Tuple[int, int], batch: int,
                 capacity: int) -> Callable:
        """The device box tail for one (bucket, batch) shape:
        ``fn(labels (N, h, w) int32) -> (rows (N, capacity + 1, 6),
        counts (N,))`` in torch ops on the labels' device, with no host
        sync.  Cached in the engine LRU under its own key."""
        from repro_torch.models.fcn import postprocess as pp

        key = ("boxes", tuple(hw), int(batch), int(capacity))
        fn = self._engines.get(key)
        if fn is not None:
            return fn
        fn = functools.partial(pp.boxes_from_labels_batched_torch,
                               capacity=int(capacity))
        self._engines.put(key, fn)
        return fn

    def _compile_single(self, hw, precision: str, model: str) -> Callable:
        """The engine of one shape: forward pass and the head's tail, with
        whatever arity the tail returns (``n_payload`` tensors and the
        convergence flags)."""
        model_obj = self.model(hw, precision, model)

        def run(params, x, valid_q):
            out = model_obj.apply(params, x)
            return model_obj.head.tail(self, out, valid_q)

        return run

    def label_tail(self, score: torch.Tensor, links: torch.Tensor,
                   valid_q: torch.Tensor):
        """Batched CC labelling -> ``(labels, converged)``: K3 on the card,
        the plain log-hop labelling on the CPU."""
        from repro_torch.kernels.cc_label import cc_label_tiled
        from repro_torch.models.fcn import postprocess as pp

        cc = (cc_label_tiled if score.device.type == "cuda"
              else pp.cc_label_batched)
        labels, _, converged = cc(score, links, self.score_thr,
                                  self.link_thr,
                                  valid_mask=_valid_mask(score, valid_q),
                                  return_stats=True)
        return labels, converged
