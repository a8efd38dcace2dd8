"""Cost-model plan routing: buckets of different shapes in one service
route to different execution plans (``runtime/executor.py``).

A small bucket stays on :class:`SingleDevice` (splitting costs more than
it saves), a batch-heavy bucket spreads over the mesh's "data" axis, a
tall plane row-bands over "model", and a tall, batch-heavy bucket takes
the composed :class:`GridPlan`.  The step cost of a plan is

  compute   per-slot FLOPs (the plan's slot grid divides the work) over
            achievable FLOP/s, plus the planned activation bytes over the
            memory rate,
  halo      the bytes a band exchanges per step (``core.rowband.
            program_band_costs``, the engine's per-layer halo rule) over
            the interconnect rate, plus one launch cost per exchanging
            layer,
  overhead  a fixed dispatch cost plus one cost per split mesh axis, the
            term that keeps small planes on one device,

with batch-split occupancy: a data-parallel plan pads the batch to a
multiple of the axis size, so a batch of 1 on a 4-wide axis pays full
single-device compute and the splitting overhead.

The default constants (:class:`CostParams`) are napkin numbers: the rates
are one NVIDIA H100 SXM's datasheet figures at a 700 W power limit
(``launch/mesh.py``; 35% of the bf16 peak achievable, NVLink as the
interconnect), the three overheads are round guesses, not measurements.
What routing needs is the ORDER of the per-plan costs and where the
crossovers sit, both monotone in the right directions: a taller plane
can only move toward row-banded plans (compute grows with H, halo bytes
do not).  ``runtime/telemetry.fit_cost_params`` fits the constants to
measured steps.

Costs reach the router through the :class:`CostProvider` seam:
:class:`AnalyticCost` is the closed-form model above;
:class:`MeasuredCost` overlays a telemetry ``CostBook``: once a (bucket,
batch, plan kind) has ``min_observations`` measured steps, routing uses
their EWMA, and unmeasured combinations fall back to the analytic model.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Protocol, Tuple

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.runtime.executor import (
    DEFAULT_MODEL,
    DataParallel,
    ExecutionPlan,
    GridPlan,
    RowBand,
    SingleDevice,
)
from repro_torch.runtime.sharding import mesh_axis_sizes

PLAN_KINDS = ("single_device", "data_parallel", "row_band", "grid")
_BANDED = ("row_band", "grid")


@dataclasses.dataclass(frozen=True)
class PlanFeatures:
    """Per-bucket cost-model inputs, one image at the bucket plane."""

    flops: float                 # forward FLOPs per image
    halo_bytes: float            # bytes one band exchanges per image
    deepest_stride: int = 32     # cumulative stride of the deepest layer
    halo_layers: int = 0         # spatial layers that halo-exchange
                                 # (one exchange each per step)
    act_bytes: float = 0.0       # planned peak activation bytes per image
                                 # (core.memplan drop-at-last-use peak);
                                 # 0 = unknown, the memory term vanishes


def features_for_program(program, deepest_stride: int,
                         *, dtype_bytes: int = 4,
                         mode: str = "optimized") -> PlanFeatures:
    """PlanFeatures from an assembled microcode program (shape walk,
    no device work).  ``mode`` must match the engine's execution mode so
    the upsample FLOPs count the path that actually runs (9-tap fused in
    "optimized", naive in "reference" — core.rowband)."""
    from repro_torch.core.memplan import plan_program
    from repro_torch.core.rowband import program_band_costs

    c = program_band_costs(program, dtype_bytes=dtype_bytes, mode=mode)
    plan = plan_program(program, dtype_bytes=dtype_bytes)
    return PlanFeatures(flops=c["flops"], halo_bytes=c["halo_bytes"],
                        deepest_stride=deepest_stride,
                        halo_layers=c["halo_layers"],
                        act_bytes=float(plan.peak_bytes))


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Hardware/runtime constants of the step-cost estimate, with the
    JAX package's field names (a JSON file either package writes loads
    in the other).  ``ici_bw`` is the interconnect rate between slots:
    NVLink on the H100.  Defaults: the H100 SXM datasheet rates of
    ``launch/mesh.py`` (35% of the bf16 peak achievable), round guesses
    for the overheads."""

    peak_flops: float = 0.35 * PEAK_FLOPS_BF16
    ici_bw: float = NVLINK_BW
    dispatch_overhead_s: float = 50e-6      # per-step launch cost
    collective_overhead_s: float = 20e-6    # extra per sharded mesh axis
    halo_launch_s: float = 2e-6             # per halo-exchanging layer
                                            # (one exchange's copies)
    hbm_bw: float = HBM_BW                  # activation traffic bandwidth
                                            # (memory term; act_bytes=0
                                            # features pay nothing)


def padded_batch(batch: int, data_n: int) -> int:
    """Batch after rounding up to the data-parallel divisibility rule."""
    return -(-batch // data_n) * data_n


def step_cost(features: PlanFeatures, kind: str, batch: int, *,
              data_n: int = 1, model_n: int = 1,
              params: Optional[CostParams] = None) -> float:
    """Estimated seconds for one engine step of ``batch`` images under
    plan ``kind`` on a (data_n, model_n) mesh (the analytic model —
    :class:`AnalyticCost` is its CostProvider wrapper)."""
    if kind not in PLAN_KINDS:
        raise ValueError(f"unknown plan kind {kind!r}")
    params = params if params is not None else CostParams()
    dn = data_n if kind in ("data_parallel", "grid") else 1
    mn = model_n if kind in _BANDED else 1
    local_b = padded_batch(batch, dn) // dn   # occupancy: padding runs too
    compute = features.flops * local_b / (mn * params.peak_flops)
    # memory term: the planned peak activation bytes stream through HBM
    # at least once per step (row-banding divides the plane, so a band
    # holds 1/mn of the footprint); small next to compute on these FCNs
    # but it keeps memory-heavy buckets honest in the ordering
    compute += features.act_bytes * local_b / (mn * params.hbm_bw)
    # wire bytes plus one exchange launch per halo-exchanging layer:
    # dozens of per-layer exchanges per banded step, not one
    halo = ((features.halo_bytes * local_b / params.ici_bw
             + features.halo_layers * params.halo_launch_s)
            if mn > 1 else 0.0)
    overhead = (params.dispatch_overhead_s
                + params.collective_overhead_s * ((dn > 1) + (mn > 1)))
    return compute + halo + overhead


class CostProvider(Protocol):
    """The one seam routing reads costs through: estimated (or
    measured) seconds for one step of ``batch`` images of bucket ``hw``
    under plan ``kind`` on a (data_n, model_n) mesh.  ``hw`` rides
    along so measured providers can key their lookups; the analytic
    provider ignores it (features already encode the plane)."""

    def step_cost(self, features: PlanFeatures, hw: Tuple[int, int],
                  kind: str, batch: int, *, data_n: int,
                  model_n: int) -> float: ...


@dataclasses.dataclass(frozen=True)
class AnalyticCost:
    """Today's closed-form model as a CostProvider — the fallback for
    every combo nothing has measured yet.  ``params`` may be the napkin
    defaults or constants fitted by ``telemetry.fit_cost_params``."""

    params: CostParams = dataclasses.field(default_factory=CostParams)

    def step_cost(self, features: PlanFeatures, hw: Tuple[int, int],
                  kind: str, batch: int, *, data_n: int,
                  model_n: int) -> float:
        return step_cost(features, kind, batch, data_n=data_n,
                         model_n=model_n, params=self.params)


class MeasuredCost:
    """Measured-step overlay: once ``book`` (a duck-typed
    runtime/telemetry.CostBook) holds at least ``min_observations``
    samples for an exact (hw, batch, kind) combo, its EWMA wall time IS
    the cost; anything unmeasured falls back to ``fallback`` (the
    analytic model).  Mixing is sound because both sides are plain
    seconds per step — the overlay just replaces an estimate with an
    observation, so routing adapts online without recompiles."""

    #: default observation floor before a measurement overrides the
    #: analytic estimate (one-off warmup/compile walls must not route)
    MIN_OBSERVATIONS = 3

    def __init__(self, book, fallback: Optional[CostProvider] = None, *,
                 min_observations: int = MIN_OBSERVATIONS,
                 stage: str = "step", precision: str = "f32",
                 model: str = DEFAULT_MODEL):
        if min_observations < 1:
            raise ValueError("min_observations must be >= 1")
        self.book = book
        self.fallback: CostProvider = (
            fallback if fallback is not None else AnalyticCost())
        self.min_observations = min_observations
        self.stage = stage
        # which numerics' walls this overlay reads — a bfp service must
        # route on bfp step times, never the f32 series — and which
        # detection model's (the heads' FLOP profiles differ)
        self.precision = precision
        self.model = model

    def step_cost(self, features: PlanFeatures, hw: Tuple[int, int],
                  kind: str, batch: int, *, data_n: int,
                  model_n: int) -> float:
        if self.book.step_count(
                hw, batch, kind, stage=self.stage,
                precision=self.precision,
                model=self.model) >= self.min_observations:
            measured = self.book.step_ewma(hw, batch, kind,
                                           stage=self.stage,
                                           precision=self.precision,
                                           model=self.model)
            if measured is not None:
                return measured
        return self.fallback.step_cost(features, hw, kind, batch,
                                       data_n=data_n, model_n=model_n)


def eligible_kinds(hw: Tuple[int, int], *, data_n: int, model_n: int,
                   deepest_stride: int) -> List[str]:
    """Plan kinds the mesh and bucket shape admit.  Row-banded kinds
    require real model-axis capacity AND the band-height invariant
    ``H % (bands * deepest_stride) == 0`` (runtime/executor.py enforces
    the same rule at compile time)."""
    kinds = ["single_device"]
    if data_n > 1:
        kinds.append("data_parallel")
    if model_n > 1 and hw[0] % (model_n * deepest_stride) == 0:
        kinds.append("row_band")
        if data_n > 1:
            kinds.append("grid")
    return kinds


def choose_kind(features: PlanFeatures, hw: Tuple[int, int], batch: int, *,
                data_n: int, model_n: int,
                params: Optional[CostParams] = None,
                cost: Optional[CostProvider] = None,
                force_banded: bool = False) -> str:
    """Cheapest eligible plan kind; exact ties break toward the simpler
    plan (PLAN_KINDS order).  Costs come from ``cost`` (any
    CostProvider — measured overlay, fitted analytic...); ``params``
    is the analytic shorthand (``cost=AnalyticCost(params)``), and
    passing both is a contradiction.  ``force_banded`` restricts to
    row-banded kinds when any is eligible — the over-tall/transposed
    routing rule (launch/serve.py pads such heights to the band unit
    first)."""
    if cost is not None and params is not None:
        raise ValueError("pass either cost= or params=, not both")
    provider: CostProvider = (cost if cost is not None
                              else AnalyticCost(params or CostParams()))
    kinds = eligible_kinds(hw, data_n=data_n, model_n=model_n,
                           deepest_stride=features.deepest_stride)
    if force_banded:
        banded = [k for k in kinds if k in _BANDED]
        kinds = banded or kinds
    return min(
        kinds,
        key=lambda k: (provider.step_cost(features, hw, k, batch,
                                          data_n=data_n, model_n=model_n),
                       PLAN_KINDS.index(k)),
    )


class Planner:
    """Routes (bucket_hw, batch) to an ExecutionPlan on one mesh.

    ``features_fn(hw) -> PlanFeatures`` supplies the per-bucket cost
    features (the service wires it to the EngineFactory's assembled
    program — see launch/serve.py); results are memoized per bucket so
    routing a request is dict-lookup cheap after first sight.  It may be
    left None at construction (``Planner(mesh)``) and bound later with
    :meth:`bind_features` — STDService does exactly that, so callers can
    hand the service a bare mesh-shaped planner.

    Costs flow through ``self.cost`` (a :class:`CostProvider`):
    ``params=`` is the analytic shorthand, ``cost=`` injects any
    provider, and :meth:`use_measurements` overlays a telemetry
    CostBook over whatever provider is current — STDService wires its
    book in so routing tracks measured step times online.
    """

    def __init__(self, mesh,
                 features_fn: Optional[
                     Callable[[Tuple[int, int]], PlanFeatures]] = None, *,
                 data_axis: str = "data", model_axis: str = "model",
                 params: Optional[CostParams] = None,
                 cost: Optional[CostProvider] = None):
        if cost is not None and params is not None:
            raise ValueError("pass either cost= or params=, not both")
        sizes = mesh_axis_sizes(mesh)
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.data_n = sizes.get(data_axis, 1)
        self.model_n = sizes.get(model_axis, 1)
        self.cost: CostProvider = (
            cost if cost is not None
            else AnalyticCost(params or CostParams()))
        # feature sources and memos are PER MODEL: the zoo's heads have
        # very different FLOP/channel profiles, so each model's features
        # are re-derived from its own assembled microcode
        self._features_fns: Dict[str, Callable[[Tuple[int, int]],
                                               PlanFeatures]] = {}
        if features_fn is not None:
            self._features_fns[DEFAULT_MODEL] = features_fn
        self._features: Dict[Tuple[Tuple[int, int], str],
                             PlanFeatures] = {}

    @property
    def params(self) -> CostParams:
        """The analytic constants routing currently falls back to (the
        provider itself for AnalyticCost, its fallback chain's params
        for overlays) — introspection/back-compat."""
        c: Any = self.cost
        while not isinstance(c, AnalyticCost):
            nxt = getattr(c, "fallback", None)
            if nxt is None:
                return CostParams()
            c = nxt
        return c.params

    def set_params(self, params: CostParams) -> "Planner":
        """Swap the analytic constants at the bottom of the provider
        chain, preserving any MeasuredCost overlays above them: the
        online-refit seam.  A control loop that fits CostParams from a
        live book calls this, so unmeasured combos route on the fitted
        constants from the next ``choose()`` on, with no service restart
        and no engine rebuilds."""

        def rebuilt(c: Any) -> CostProvider:
            if isinstance(c, MeasuredCost):
                c.fallback = rebuilt(c.fallback)
                return c
            return AnalyticCost(params)

        self.cost = rebuilt(self.cost)
        return self

    def use_measurements(self, book, *,
                         min_observations: int =
                         MeasuredCost.MIN_OBSERVATIONS,
                         precision: str = "f32",
                         model: str = DEFAULT_MODEL) -> "Planner":
        """Overlay a telemetry CostBook over the current provider:
        combos with >= min_observations measured steps route by their
        EWMA wall time, the rest keep the current (analytic) costs.
        ``precision`` selects which numerics' step series the overlay
        reads (a bfp service routes on bfp walls) and ``model`` which
        head's.  Idempotent per (book, precision, model) — re-wiring
        the same triple is a no-op."""
        if (isinstance(self.cost, MeasuredCost) and self.cost.book is book
                and self.cost.precision == precision
                and self.cost.model == model):
            return self
        self.cost = MeasuredCost(book, fallback=self.cost,
                                 min_observations=min_observations,
                                 precision=precision, model=model)
        return self

    def bind_features(
        self, features_fn: Callable[[Tuple[int, int]], PlanFeatures],
        model: str = DEFAULT_MODEL,
    ) -> "Planner":
        """Late-bind one model's feature source (idempotent per model:
        the first binding — incl. a constructor-time features_fn for the
        default model — wins)."""
        if model not in self._features_fns:
            self._features_fns[model] = features_fn
        return self

    def features(self, hw: Tuple[int, int],
                 model: str = DEFAULT_MODEL) -> PlanFeatures:
        hw = tuple(hw)
        f = self._features.get((hw, model))
        if f is None:
            fn = self._features_fns.get(model)
            if fn is None:
                raise RuntimeError(
                    f"Planner has no features_fn for model {model!r}; "
                    f"pass one at construction or call bind_features()"
                )
            f = fn(hw)
            self._features[(hw, model)] = f
        return f

    def height_unit(self, deepest_stride: int) -> int:
        """Heights routed to this planner's row-banded plans must be a
        multiple of this (bands x deepest stride)."""
        return max(self.model_n, 1) * deepest_stride

    def costs(self, hw: Tuple[int, int], batch: int,
              model: str = DEFAULT_MODEL) -> Dict[str, float]:
        """The per-kind cost table for one bucket (bench introspection)."""
        f = self.features(hw, model)
        return {
            k: self.cost.step_cost(f, hw, k, batch, data_n=self.data_n,
                                   model_n=self.model_n)
            for k in eligible_kinds(hw, data_n=self.data_n,
                                    model_n=self.model_n,
                                    deepest_stride=f.deepest_stride)
        }

    def choose(self, hw: Tuple[int, int], batch: int, *,
               force_banded: bool = False,
               model: str = DEFAULT_MODEL) -> ExecutionPlan:
        kind = choose_kind(self.features(hw, model), hw, batch,
                           data_n=self.data_n, model_n=self.model_n,
                           cost=self.cost, force_banded=force_banded)
        return self.plan_for_kind(kind)

    def plan_for_kind(self, kind: str) -> ExecutionPlan:
        if kind == "single_device":
            return SingleDevice()
        if kind == "data_parallel":
            return DataParallel(self.mesh, self.data_axis)
        if kind == "row_band":
            return RowBand(self.mesh, axis=self.model_axis)
        if kind == "grid":
            return GridPlan(self.mesh, self.data_axis, self.model_axis)
        raise ValueError(f"unknown plan kind {kind!r}")
