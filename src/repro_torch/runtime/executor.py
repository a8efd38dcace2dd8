"""Engine factory: one seam from an assembled model to a serving engine.

:class:`EngineFactory` builds, per ``(bucket_hw, precision, model)``, the
:class:`~repro_torch.models.fcn.heads.DetectionModel` and its parameters,
and per ``(bucket_hw, batch, plan, precision, model)`` the engine
callable ``fn(params, x, valid_q) -> (labels, converged)``: the FCN
forward pass, per-image valid-region masking and batched CC labelling.

Parameters are per precision without being independent: the f32 entry
holds the seeded He init (or weights the caller handed over with
:meth:`EngineFactory.set_params`), and the bfp entry holds the SAME
weights run through the bfp model's ``normalize_weights`` (paper Fig. 4:
BN fold + BFP weight roundtrip), so both precisions share one weight set.

On the card the CC tail runs K3 (``kernels/cc_label``), on the CPU the
plain ``postprocess.cc_label_batched``.  Only the single-device plan is
ported; the reference's DataParallel, RowBand and GridPlan are not.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import resolve_device
from repro_torch.launch.batching import LRUCache
from repro_torch.models.fcn.heads import DEFAULT_MODEL, check_model

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


class EngineFactory:
    """``make_model(hw, precision, model)`` builds the model for one input
    plane on ``device``; the factory caches models, parameters and
    engines in LRUs of ``capacity`` entries."""

    def __init__(self, make_model: Callable[..., Any], *,
                 score_thr: float = 0.5, link_thr: float = 0.5,
                 capacity: int = 16, device="cuda"):
        self.make_model = make_model
        self.device = resolve_device(device)
        self.score_thr = score_thr
        self.link_thr = link_thr
        self._weights: Dict[str, Dict] = {}
        self._models = LRUCache(capacity)
        self._params = LRUCache(capacity)
        self._engines = LRUCache(capacity)

    def _key(self, hw, precision, model):
        check_precision(precision)
        check_model(model)
        return (tuple(hw), precision, model)

    # -- model / param caches -------------------------------------------------
    def model(self, hw: Tuple[int, int], precision: str = "f32",
              model: str = DEFAULT_MODEL):
        key = self._key(hw, precision, model)
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
        p = self._params.get(key)
        if p is not None:
            return p
        model_obj = self.model(hw, precision, model)
        if precision != "f32":
            p = model_obj.normalize_weights(self.params(hw, "f32", model))
        elif model in self._weights:
            p = self._weights[model]
        else:
            p = model_obj.init_params(
                torch.Generator().manual_seed(SEED))
        self._params.put(key, p)
        return p

    # -- engines --------------------------------------------------------------
    def plan_fn(self, hw: Tuple[int, int], batch: int, plan=None,
                precision: str = "f32", model: str = DEFAULT_MODEL
                ) -> Callable:
        plan = SingleDevice() if plan is None else plan
        check_plan(plan)
        key = (tuple(hw), int(batch), plan, precision, model)
        fn = self._engines.get(key)
        if fn is None:
            fn = self._compile_single(tuple(hw), precision, model)
            self._engines.put(key, fn)
        return fn

    def _compile_single(self, hw, precision: str, model: str) -> Callable:
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

        h, w = score.shape[1:]
        dev = score.device
        mask = ((torch.arange(h, device=dev)[None, :, None]
                 < valid_q[:, 0, None, None])
                & (torch.arange(w, device=dev)[None, None, :]
                   < valid_q[:, 1, None, None]))
        cc = cc_label_tiled if dev.type == "cuda" else pp.cc_label_batched
        labels, _, converged = cc(score, links, self.score_thr,
                                  self.link_thr, valid_mask=mask,
                                  return_stats=True)
        return labels, converged
