"""Pipelining: the paper's C4 module-level multithreading on the host
(:class:`HostPipeline`, which ``STDService.serve_pipelined`` runs as
preprocess / device inference / box postprocess stages), and pipeline
parallelism of a layer stack over a mesh axis (:func:`pipeline_apply`,
the GPipe schedule).

The paper's C4 modules, independent compute units working on different
inputs at once, are exactly a pipeline; over a mesh the stages map onto
one axis, so what crosses between stages is one microbatch's activation
per tick instead of whole gradients.

Schedule: M microbatches through S stages in M + S - 1 ticks; at tick t
stage s runs its layers on microbatch t - s, then hands the activation
to stage s + 1.  One controller drives every slot (``launch/mesh.py``),
as the execution plans do, so the reference's ``shard_map`` and ring
``ppermute`` become a loop and ``.to(next stage's device)``; autograd
through the loop replays it in reverse (the backward pipeline), and
per-layer remat keeps O(M) boundary activations per stage instead of
O(M * L/S) layers' worth.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tree as tree_lib


class HostPipeline:
    """The paper's C4 module-level multithreading on host: a chain of
    stages connected by bounded queues, one thread per stage, so stage i
    of item n overlaps stage i+1 of item n-1 (serve.py's preprocess /
    device-infer / CC-postprocess chain is the motivating instance).

    ``stages`` are ``fn(item) -> item``; ``run`` preserves input order.
    A stage exception propagates to the caller and stops the pipeline.
    """

    def __init__(self, stages: Sequence[Callable[[Any], Any]],
                 maxsize: int = 4):
        if not stages:
            raise ValueError("need at least one stage")
        self.stages = list(stages)
        self.maxsize = maxsize

    def run(self, items: Sequence[Any]) -> List[Any]:
        n_stages = len(self.stages)
        qs = [queue.Queue(maxsize=self.maxsize) for _ in range(n_stages + 1)]
        results: List[Any] = [None] * len(items)
        errors: List[BaseException] = []
        abort = threading.Event()        # a stage error must unwind EVERY
                                         # thread, not just downstream ones

        def _put(q, item) -> bool:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def _get(q):
            """Item, or None sentinel, or False once aborted+drained."""
            while True:
                try:
                    return q.get(timeout=0.05)
                except queue.Empty:
                    if abort.is_set():
                        return False

        def feeder():
            for i, item in enumerate(items):
                if not _put(qs[0], (i, item)):
                    return
            _put(qs[0], None)

        def worker(si: int):
            fn = self.stages[si]
            while True:
                got = _get(qs[si])
                if got is False:
                    return
                if got is None:
                    _put(qs[si + 1], None)
                    return
                i, item = got
                try:
                    out = fn(item)
                except Exception as e:
                    errors.append(e)
                    abort.set()
                    return
                if not _put(qs[si + 1], (i, out)):
                    return

        def sink():
            while True:
                got = _get(qs[n_stages])
                if got is False or got is None:
                    return
                i, item = got
                results[i] = item

        threads = [threading.Thread(target=feeder, daemon=True)]
        threads += [
            threading.Thread(target=worker, args=(si,), daemon=True)
            for si in range(n_stages)
        ]
        threads.append(threading.Thread(target=sink, daemon=True))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (S, L/S, ...), every leaf (a BFP
    leaf's mantissa and exponent alike; views, no copy)."""
    def f(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape(n_stages, L // n_stages, *a.shape[1:])
    return tree_lib.tree_map(f, stacked_params)


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (M, B/M, ...)."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])


def pipeline_apply(mesh, stage_axis: str,
                   layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   staged_params: Any, x: torch.Tensor, *,
                   remat: bool = True) -> torch.Tensor:
    """Run the stage-stacked layer stack as a pipeline; returns (M, mb,
    seq, d) on the mesh's first slot.

    ``layer_fn(params_one_layer, h) -> h`` runs over the local stage's
    layers in order; ``staged_params`` are (S, L/S, ...) leaves
    (:func:`split_stages`), S the size of ``stage_axis``; ``x`` is the
    (M, mb, seq, d) microbatched input (:func:`microbatch`).

      * Placement: stage s's (L/S, ...) slice lives on the slot at
        ``stage_axis`` = s (``.to()`` that slot's device, which copies
        nothing where the slice already lies there).  The slices come
        from one ``unbind`` per leaf, whose backward stacks the S stage
        gradients once; indexing each stage instead fills and adds a
        zero (S, L/S, ...) gradient per stage.
      * The other mesh axes: the reference replicates the params over
        them and every replica computes the same thing; here each stage
        runs once, on the slot at index 0 of the other axes.
      * The ring shift: the reference's ``ppermute`` is ``.to()`` the
        next stage's device; the last stage's outputs come back on the
        mesh's first slot, where the reference all-gathers them to
        every stage.
      * Bubble ticks (stage s before microbatch 0 reaches it, or after
        the last has left): the reference computes them on zeros and
        masks them out; here they are skipped, which changes neither
        outputs nor gradients.
      * Gradients reach ``staged_params`` and ``x`` through the loop.
        With ``remat`` (and grad enabled) each layer is recomputed in
        the backward (``torch.utils.checkpoint``, non-reentrant, the
        layer's params passed as inputs), as the reference's
        ``jax.checkpoint`` of the scan body.
    """
    sizes = mesh.axis_sizes()
    if stage_axis not in sizes:
        raise ValueError(f"mesh {mesh.axis_names} has no axis "
                         f"{stage_axis!r}")
    S = sizes[stage_axis]
    flat = tree_lib.leaves(staged_params)
    for a in flat:
        if a.shape[0] != S:
            raise ValueError(f"a staged leaf of shape {tuple(a.shape)} has "
                             f"{a.shape[0]} stages; axis {stage_axis!r} "
                             f"has {S}")
    M = x.shape[0]
    devs = [mesh.device_at(**{stage_axis: s}) for s in range(S)]
    parts = [a.unbind(0) for a in flat]
    local = [tree_lib.unflatten(staged_params,
                                [p[s].to(devs[s]) for p in parts])
             for s in range(S)]
    n_local = flat[0].shape[1] if flat else 0
    recompute = remat and torch.is_grad_enabled()

    def stage_fn(s: int, h: torch.Tensor) -> torch.Tensor:
        for i in range(n_local):
            lp = tree_lib.tree_map(lambda a: a[i], local[s])
            if recompute:
                h = checkpoint(layer_fn, lp, h, use_reentrant=False)
            else:
                h = layer_fn(lp, h)
        return h

    outs: List[Any] = [None] * M
    held: dict = {}          # stage -> the activation it takes next tick
    for t in range(M + S - 1):
        shifted = {}
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue                       # a bubble tick
            h = x[m].to(devs[0]) if s == 0 else held[s]
            h = stage_fn(s, h)
            if s == S - 1:
                outs[m] = h.to(mesh.devices.flat[0])
            else:
                shifted[s + 1] = h.to(devs[s + 1])      # the ring shift
        held = shifted
    return torch.stack(outs)
