"""Execution plans and the engine factory: one seam from an assembled
model to a serving engine on one device or a mesh of them.

The paper stacks its levels of parallelism over one fixed FCN datapath;
each level is a plan here, and every serving engine comes from
:class:`EngineFactory`, so the scheduler (``launch/serve.py``,
``launch/batching.py``) never handles devices itself:

  * :class:`SingleDevice`: one device runs a (bucket, batch) shape end to
    end (the paper's batch level only).
  * :class:`DataParallel`: the batch level over a mesh's "data" axis;
    each shard runs the whole program and the head's tail on its slot's
    device, and the results are gathered on the first slot's device.
  * :class:`RowBand`: the paper's §IV.B row-wise segmentation over the
    "model" axis.  Each slot runs the SAME program assembled at the band
    plane (``DetectionModel.for_plane``), and every spatial layer first
    trades its own boundary rows with the neighbouring bands
    (``FCNEngine.walk`` yields, ``runtime/collectives.halo_exchange``
    answers).  The band maps are concatenated and the tail (CC
    labelling) runs once on the full plane.  This is the route for
    images taller than the largest bucket.
  * :class:`GridPlan`: both at once on a 2-D mesh, the batch over
    "data" and the rows over "model"; rows move along "model" only.

One process drives every slot (``launch/mesh.py``): the bands of a plane
walk the program in lockstep, one generator each, and
:func:`drive_bands` exchanges rows between their yields, in a fixed
order.  A mesh may put several slots on one device, which is how the CPU
tests and a one-card machine run 2- and 4-band plans.  On the card each
slot's work is issued under its device, and copies between cards follow
PyTorch's stream rules (``runtime/collectives``).  Band outputs equal the
full plane mathematically, and the walk keeps each word's sum order the
full plane's, so they match its bits at any band offset:
before a 3x3 stride-1 conv a band extends to plane rows at multiples of
4, so K1 tiles it as it tiles the full plane (and sums each tile in one
order whatever its block shape); K2 takes its K split from the whole
plane's rows (``FCNEngine.plane_bands``); the fused upsample's tap
products run as GEMMs of one fixed shape (``core/fuse``).  A plan that
cannot run raises; nothing falls back to another plan or device.

Plans are frozen, hashable dataclasses: the engine LRU keys on
``(bucket_hw, batch, plan, precision, model)``.  The factory builds, per
``(bucket_hw, precision, model)``, the
:class:`~repro_torch.models.fcn.heads.DetectionModel` and its
parameters, and per engine key the callable ``fn(params, x, valid_q) ->
(*payload, converged)``: the FCN forward pass and the head's tail
(batched CC labelling to ``(labels, converged)`` for PixelLink and DB,
``(score, geo, converged)`` for EAST); ``fn.forward(params, x)`` returns
the forward pass's named maps alone.  Parameters are per precision
without being independent: the f32 entry holds the seeded He init (or
weights handed over with :meth:`EngineFactory.set_params`), the bfp entry
the SAME weights through ``normalize_weights`` (paper Fig. 4); a plan
copies them to each slot's device once per parameter set.

On the card the CC tail runs K3 (``kernels/cc_label``), on the CPU the
plain ``postprocess.cc_label_batched``.  :meth:`EngineFactory.boxes_fn`
is the device box tail that ``postprocess="device"`` serving runs on the
engine's labels.  Every engine call is an ``engine.run`` span of
``runtime/telemetry.SPANS`` (``engine.forward``, ``cc.local``,
``cc.merge`` and its ``cc.sync`` reads inside), and a miss's build an
``engine.build`` span; with a telemetry ``book`` the call wall lands
under ``stage="dispatch"`` and the CC rounds and syncs, builds and engine
evictions as counters.  The engine LRU can evict by planned bytes
(``engine_bytes_budget``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import Any, Callable, Dict, List, Tuple, Union

import torch

from repro_torch.core import resolve_device
from repro_torch.launch.batching import LRUCache
from repro_torch.launch.mesh import Mesh, canonical_device
from repro_torch.models.fcn.heads import (DEFAULT_MODEL, _valid_mask,
                                          check_model)
from repro_torch.runtime.collectives import halo_bounds, halo_exchange
from repro_torch.runtime.sharding import (fcn_activation_specs,
                                          mesh_axis_sizes, split_dims)
from repro_torch.runtime.telemetry import SPANS

PRECISIONS = ("f32", "bfp")
SEED = 0            # torch.Generator seed of the He init


@dataclasses.dataclass(frozen=True)
class SingleDevice:
    """Run the whole (bucket, batch) shape on the factory's device."""


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """Split the batch over ``mesh`` axis ``axis`` (paper batch level)."""

    mesh: Mesh
    axis: str = "data"


@dataclasses.dataclass(frozen=True)
class RowBand:
    """Split image rows into bands over ``mesh`` axis ``axis`` (paper
    §IV.B).  ``bands`` must equal the axis size (0 = take it from the
    mesh); each layer's halo follows from its kernel."""

    mesh: Mesh
    axis: str = "model"
    bands: int = 0


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Batch over ``data_axis`` x rows over ``model_axis`` at once (paper
    §IV batch level + row-wise segmentation).  ``bands`` must equal the
    model-axis size (0 = take it from the mesh); batch sizes must be a
    multiple of the data-axis size."""

    mesh: Mesh
    data_axis: str = "data"
    model_axis: str = "model"
    bands: int = 0


ExecutionPlan = Union[SingleDevice, DataParallel, RowBand, GridPlan]


def check_precision(precision: str) -> str:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return precision


def plan_batch_multiple(plan: ExecutionPlan) -> int:
    """Batch sizes built for ``plan`` must be a multiple of this."""
    if isinstance(plan, DataParallel):
        return mesh_axis_sizes(plan.mesh).get(plan.axis, 1)
    if isinstance(plan, GridPlan):
        return mesh_axis_sizes(plan.mesh).get(plan.data_axis, 1)
    return 1


def plan_bands(plan: ExecutionPlan) -> int:
    """Number of row bands a plan splits the image plane into (1 for the
    plans that do not band)."""
    if isinstance(plan, RowBand):
        return plan.bands or mesh_axis_sizes(plan.mesh).get(plan.axis, 1)
    if isinstance(plan, GridPlan):
        return plan.bands or mesh_axis_sizes(plan.mesh).get(
            plan.model_axis, 1)
    return 1


def band_height_unit(plan: ExecutionPlan, deepest_stride: int) -> int:
    """Heights built for a row-banded plan (RowBand or GridPlan) must be a
    multiple of this: every band must divide evenly through the whole
    stride pyramid (``H % (bands * deepest_stride) == 0``)."""
    return plan_bands(plan) * deepest_stride


def row_band_height_unit(plan: RowBand, deepest_stride: int) -> int:
    """Alias of :func:`band_height_unit`."""
    return band_height_unit(plan, deepest_stride)


def plan_kind(plan: ExecutionPlan) -> str:
    """The planner-side kind of a plan: the key the telemetry CostBook
    and ``runtime/planner.PLAN_KINDS`` share."""
    if isinstance(plan, DataParallel):
        return "data_parallel"
    if isinstance(plan, RowBand):
        return "row_band"
    if isinstance(plan, GridPlan):
        return "grid"
    if isinstance(plan, SingleDevice):
        return "single_device"
    raise TypeError(f"unknown execution plan {plan!r}")


def describe_plan(plan: ExecutionPlan) -> str:
    if isinstance(plan, DataParallel):
        n = mesh_axis_sizes(plan.mesh).get(plan.axis, 1)
        return f"data_parallel[{plan.axis}={n}]"
    if isinstance(plan, RowBand):
        n = plan.bands or mesh_axis_sizes(plan.mesh).get(plan.axis, 1)
        return f"row_band[{plan.axis}={n}]"
    if isinstance(plan, GridPlan):
        sizes = mesh_axis_sizes(plan.mesh)
        dn = sizes.get(plan.data_axis, 1)
        mn = plan.bands or sizes.get(plan.model_axis, 1)
        return f"grid[{plan.data_axis}={dn},{plan.model_axis}={mn}]"
    return plan_kind(plan)


def _on(device: torch.device):
    """Issue work under ``device`` on the card: the kernels' wrappers
    launch on the current device's stream."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@torch.no_grad()
def drive_bands(groups: List[List[Tuple[torch.device, Any]]]
                ) -> List[List[Any]]:
    """Run band walks in lockstep.  ``groups``: per plane, its bands'
    ``(device, walk)`` in band order (``DetectionModel.band_walk``).
    Every walk is advanced one step, under its device; then each plane's
    bands trade rows (``halo_exchange``) and the next step takes each
    band's rows with the index its own rows start at.  Returns each
    walk's value, grouped as given."""
    flat = [pair for group in groups for pair in group]
    values: List[Any] = [None] * len(flat)
    replies: List[Any] = [None] * len(flat)
    while True:
        asks = []
        for i, (dev, walk) in enumerate(flat):
            with _on(dev):
                try:
                    asks.append(walk.send(replies[i]))
                except StopIteration as stop:
                    values[i] = stop.value
                    asks.append(None)
        done = [a is None for a in asks]
        if all(done):
            break
        geometry = {a[1:] for a in asks if a is not None}
        if any(done) or len(geometry) != 1:
            raise RuntimeError(f"band walks fell out of lockstep: "
                               f"finished {done}, (halo, align) {geometry}")
        ((halo, align),) = geometry
        k = 0
        for group in groups:
            xs = [a[0] for a in asks[k:k + len(group)]]
            band = xs[0].shape[1]
            starts = [m * band - lo for m, (lo, _) in enumerate(
                halo_bounds(len(xs), band, halo, align))]
            planes = halo_exchange(xs, halo, align=align)
            replies[k:k + len(group)] = list(zip(planes, starts))
            k += len(group)
    out, k = [], 0
    for group in groups:
        out.append(values[k:k + len(group)])
        k += len(group)
    return out


class _Replicas:
    """One parameter set's copies on the slots' devices, made at first
    use and kept while the set is the one engines are called with."""

    def __init__(self):
        self._copies: Dict[torch.device, Tuple[Any, Any]] = {}

    def on(self, params, device: torch.device):
        leaves = [v for p in params.values() for v in p.values()]
        if not leaves or canonical_device(leaves[0].device) == device:
            return params
        hit = self._copies.get(device)
        if hit is None or hit[0] is not params:
            hit = (params, {n: {k: v.to(device) for k, v in p.items()}
                            for n, p in params.items()})
            self._copies[device] = hit
        return hit[1]


def _serving(fn: Callable) -> Callable:
    """An engine and its ``forward`` under ``torch.no_grad()``: serving
    builds no autograd graph, whatever the parameters require."""
    run = torch.no_grad()(fn)
    if hasattr(fn, "forward"):
        run.forward = torch.no_grad()(fn.forward)
    return run


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
        row = {"hw": hw, "batch": int(batch), "plan": describe_plan(plan),
               "precision": precision, "model": model,
               "planned_peak_bytes": self.engine_weight_bytes(
                   hw, batch, precision, model)}
        if self.device.type == "cuda":
            params = self.params(hw, precision, model)
            fn = _serving(self._compile(hw, int(batch), plan, precision,
                                        model))
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
        kind = plan_kind(plan)
        check_precision(precision)
        check_model(model)
        key = (tuple(hw), int(batch), plan, precision, model)
        fn = self._engines.get(key)
        if fn is not None:
            return fn
        build = SPANS.begin("engine.build")
        evicted = 0
        try:
            fn = self._timed(_serving(self._compile(
                tuple(hw), int(batch), plan, precision, model)),
                tuple(hw), int(batch), kind, precision, model)
            self.stats["compiled"].append(
                {"hw": tuple(hw), "batch": int(batch),
                 "plan": describe_plan(plan), "precision": precision,
                 "model": model})
            evicted = self._put_engine(key, fn, self.engine_weight_bytes(
                hw, batch, precision, model))
        finally:
            SPANS.end(build, counts={"engine.builds": 1,
                                     "engine.evictions": evicted})
        if self.book is not None:
            self.book.incr("engine_builds")
        return fn

    def _put_engine(self, key, fn, weight: int = 0) -> int:
        """Put one entry in the engine LRU; returns (and books) how many
        entries it evicted."""
        evicted = self._engines.put(key, fn, weight=weight)
        if evicted and self.book is not None:
            self.book.incr("engine_evictions", evicted)
        return evicted

    def _timed(self, fn: Callable, hw, batch: int, kind: str,
               precision: str, model: str) -> Callable:
        """Each engine call as an ``engine.run`` span carrying the CC
        rounds and syncs it counted (``SPANS`` tally), and, with a book,
        its wall under ``stage="dispatch"`` and the counts as counters.
        The wall is the host's: the launches, and the waits inside the
        call.  On the card the CC stitching reads one convergence flag a
        round (``postprocess.merge_rounds``), and the first read waits
        for the forward, so the wall ends once the labels have converged
        on the device, not once the launches are queued."""
        book = self.book

        def timed(params, x, valid_q):
            SPANS.take()
            t0 = time.perf_counter_ns()
            span = SPANS.begin("engine.run", t0)
            try:
                out = fn(params, x, valid_q)
            finally:
                t1 = time.perf_counter_ns()
                counts = SPANS.take()
                SPANS.end(span, t1, counts)
            if book is not None:
                book.record_step(hw, batch, kind, (t1 - t0) * 1e-9,
                                 stage="dispatch", precision=precision,
                                 model=model)
                for name, n in counts.items():
                    book.incr(name.replace(".", "_"), n)
            return out

        if hasattr(fn, "forward"):
            timed.forward = fn.forward
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
        tail = functools.partial(pp.boxes_from_labels_batched_torch,
                                 capacity=int(capacity))

        def fn(labels):
            with SPANS.span("boxes.launch"):
                return tail(labels)

        self._put_engine(key, fn)
        return fn

    def _compile(self, hw, batch: int, plan: ExecutionPlan, precision: str,
                 model: str) -> Callable:
        if isinstance(plan, SingleDevice):
            return self._compile_single(hw, precision, model)
        if isinstance(plan, DataParallel):
            return self._compile_data_parallel(hw, batch, plan, precision,
                                               model)
        if isinstance(plan, RowBand):
            return self._compile_row_band(hw, plan, precision, model)
        if isinstance(plan, GridPlan):
            return self._compile_grid(hw, batch, plan, precision, model)
        raise TypeError(f"unknown execution plan {plan!r}")

    def _compile_single(self, hw, precision: str, model: str) -> Callable:
        """The engine of one shape: forward pass and the head's tail, with
        whatever arity the tail returns (``n_payload`` tensors and the
        convergence flags)."""
        model_obj = self.model(hw, precision, model)

        def run(params, x, valid_q):
            with SPANS.span("engine.forward"):
                maps = model_obj.apply(params, x)
            return model_obj.head.tail(self, maps, valid_q)

        run.forward = model_obj.apply
        return run

    @staticmethod
    def _axis_size(mesh: Mesh, axis: str) -> int:
        n = mesh_axis_sizes(mesh).get(axis)
        if n is None:
            raise ValueError(f"mesh {mesh.axis_names} has no axis {axis!r}")
        return n

    def _compile_data_parallel(self, hw, batch: int, plan: DataParallel,
                               precision: str, model: str) -> Callable:
        """Each batch shard runs the whole program and the head's tail on
        its slot's device; the results are gathered on the first slot's
        device."""
        n = self._axis_size(plan.mesh, plan.axis)
        if batch % n:
            raise ValueError(
                f"batch {batch} not divisible by {plan.axis}={n}; round "
                f"with plan_batch_multiple()")
        model_obj = self.model(hw, precision, model)
        (dim,) = split_dims(fcn_activation_specs(batch_axis=plan.axis)
                            ["image"], plan.axis)
        devices = [plan.mesh.device_at(**{plan.axis: i}) for i in range(n)]
        models = {d: (model_obj
                      if canonical_device(model_obj.device) == d
                      else model_obj.for_plane(hw, d))
                  for d in dict.fromkeys(devices)}
        replicas = _Replicas()

        def shards(params, x):
            for dev, xs in zip(devices, x.chunk(n, dim=dim)):
                yield dev, models[dev], replicas.on(params, dev), \
                    xs.to(dev, non_blocking=True)

        def gather(parts):
            return [torch.cat([t.to(devices[0], non_blocking=True)
                               for t in ts], dim=dim) for ts in zip(*parts)]

        def forward(params, x):
            outs = []
            for dev, m, p, xs in shards(params, x):
                with _on(dev):
                    outs.append(m.apply(p, xs))
            return dict(zip(outs[0], gather([o.values() for o in outs])))

        def run(params, x, valid_q):
            outs = []
            for (dev, m, p, xs), vq in zip(shards(params, x),
                                           valid_q.chunk(n, dim=dim)):
                with _on(dev):
                    with SPANS.span("engine.forward"):
                        maps = m.apply(p, xs)
                    outs.append(m.head.tail(self, maps,
                                            vq.to(dev, non_blocking=True)))
            return tuple(gather(outs))

        run.forward = forward
        return run

    def _compile_row_band(self, hw, plan: RowBand, precision: str,
                          model: str) -> Callable:
        n = self._axis_size(plan.mesh, plan.axis)
        bands = plan.bands or n
        if bands != n:
            raise ValueError(
                f"bands={plan.bands} must equal mesh axis {plan.axis}={n}")
        return self._compile_banded(plan.mesh, hw, bands, plan.axis,
                                    precision=precision, model=model)

    def _compile_grid(self, hw, batch: int, plan: GridPlan, precision: str,
                      model: str) -> Callable:
        """DataParallel x RowBand at once: batch over ``data_axis``, rows
        over ``model_axis``, halo exchange along ``model_axis`` only."""
        dn = self._axis_size(plan.mesh, plan.data_axis)
        mn = self._axis_size(plan.mesh, plan.model_axis)
        if plan.data_axis == plan.model_axis:
            raise ValueError(
                f"grid axes must differ, got {plan.data_axis!r} twice")
        if batch % dn:
            raise ValueError(
                f"batch {batch} not divisible by {plan.data_axis}={dn}; "
                f"round with plan_batch_multiple()")
        bands = plan.bands or mn
        if bands != mn:
            raise ValueError(
                f"bands={plan.bands} must equal mesh axis "
                f"{plan.model_axis}={mn}")
        return self._compile_banded(plan.mesh, hw, bands, plan.model_axis,
                                    batch_axis=plan.data_axis,
                                    precision=precision, model=model)

    def _compile_banded(self, mesh: Mesh, hw, bands: int, model_axis: str,
                        batch_axis=None, *, precision: str,
                        model: str) -> Callable:
        """The row-banded engine: each slot runs the program assembled at
        the band plane, the bands of each batch shard walk it in lockstep
        and trade their boundary rows at every spatial layer
        (:func:`drive_bands`); the band maps are concatenated on the first
        slot's device and the head's tail runs once on the full plane.
        With ``batch_axis`` the batch splits too (GridPlan); rows still
        move along ``model_axis`` only."""
        band_h = self._band_height(hw, bands, precision, model)
        model_obj = self.model(hw, precision, model)
        specs = fcn_activation_specs(batch_axis=batch_axis,
                                     rows_axis=model_axis)
        (row_dim,) = split_dims(specs["image"], model_axis)
        dn = self._axis_size(mesh, batch_axis) if batch_axis else 1
        batch_dim = split_dims(specs["image"], batch_axis)[0] \
            if batch_axis else 0
        slots = [[mesh.device_at(**{model_axis: m,
                                    **({batch_axis: d} if batch_axis
                                       else {})})
                  for m in range(bands)] for d in range(dn)]
        first = slots[0][0]
        band_models = {dev: model_obj.for_plane((band_h, hw[1]), dev, bands)
                       for row in slots for dev in row}
        replicas = _Replicas()

        def forward(params, x):
            groups = []
            for row, xs in zip(slots, x.chunk(dn, dim=batch_dim)):
                groups.append([
                    (dev, band_models[dev].band_walk(
                        replicas.on(params, dev),
                        xs.narrow(row_dim, m * band_h, band_h)
                        .to(dev, non_blocking=True)))
                    for m, dev in enumerate(row)])
            outs = drive_bands(groups)
            return {k: torch.cat([torch.cat(
                [o[k].to(first, non_blocking=True) for o in group],
                dim=row_dim) for group in outs], dim=batch_dim)
                for k in outs[0][0]}

        def run(params, x, valid_q):
            with SPANS.span("engine.forward"):
                maps = forward(params, x)
            with _on(first):
                return model_obj.head.tail(
                    self, maps, valid_q.to(first, non_blocking=True))

        run.forward = forward
        return run

    def _band_height(self, hw, bands: int, precision: str,
                     model: str) -> int:
        """Validated per-band height for splitting plane ``hw`` into
        ``bands`` rows: every band must stay integral at the deepest
        scale (``H % (bands * deepest_stride) == 0``)."""
        H = hw[0]
        if H % bands:
            raise ValueError(f"H={H} not divisible into {bands} bands")
        band_h = H // bands
        deepest = self.deepest_stride(hw, precision, model)
        if band_h % deepest:
            raise ValueError(
                f"band height {band_h} must be a multiple of the deepest "
                f"cumulative stride {deepest} (H={H}, bands={bands})")
        return band_h

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

    def __len__(self) -> int:
        return len(self._engines)
