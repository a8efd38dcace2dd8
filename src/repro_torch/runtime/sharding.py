"""Which tensor dims split over which mesh axis, and the pieces a split
tensor is stored in.

A spec (:data:`Spec`) has one entry per leading tensor dim: an axis name,
a tuple of axis names (the dim splits over their product, the first axis
major), or None (the dim stays whole); dims past its end stay whole.  It
is the counterpart of a JAX PartitionSpec, and a :class:`Sharding` (mesh
and spec) that of a NamedSharding.

  * FCN serving activations (NHWC image planes and the quarter-scale
    maps): batch over "data" for data-parallel plans, rows over "model"
    for row-band plans, or both for the 2-D GridPlan
    (:func:`fcn_activation_specs`, read by ``runtime/executor.py``);
  * LM inputs: the batch over ("pod", "data") as far as it divides, the
    sequence taking the data-parallel capacity the batch cannot use
    (:func:`batch_seq_spec`); logits keep the vocabulary on "model";
  * LM parameters carry their own axis preferences
    (``models/lm/params.best_spec``).

:func:`split` cuts a tensor into one piece per slot of the axes its spec
names and puts each on that slot's device; :func:`gather` puts the
pieces back together on one device, differentiably, so a gradient taken
through a gather comes back split the way the pieces are.  One process
drives every slot (``launch/mesh.py``), so nothing here needs
``torch.distributed``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.bfp import BFPTensor

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout over a mesh: tensor dims over its axes."""

    mesh: Any
    spec: Spec


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return mesh.axis_sizes()


def entry_axes(entry: Axes) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _entry(axes) -> Axes:
    """The spec entry naming ``axes``: None, one name, or a tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def fcn_batch_axis(mesh, batch: int, axis: str = "data") -> Optional[str]:
    """The mesh axis an FCN batch can split over, or None (whole)."""
    n = mesh_axis_sizes(mesh).get(axis, 1)
    return axis if n > 1 and batch % n == 0 else None


def fcn_activation_specs(batch_axis: Optional[str] = None,
                         rows_axis: Optional[str] = None
                         ) -> Dict[str, Spec]:
    """Per tensor, the mesh axis each dim splits over.  Keys: "image"
    (N, H, W, C), "score" (N, h, w), "links" (N, h, w, 8), "labels"
    (N, h, w)."""
    return {
        "image": (batch_axis, rows_axis, None, None),
        "score": (batch_axis, rows_axis, None),
        "links": (batch_axis, rows_axis, None, None),
        "labels": (batch_axis, rows_axis, None),
    }


def split_dims(spec: Spec, axis: str) -> Tuple[int, ...]:
    """The dims of a tensor with ``spec`` that split over ``axis``."""
    return tuple(d for d, a in enumerate(spec) if axis in entry_axes(a))


# ---------------------------------------------------------------------------
# LM inputs, logits and activations
# ---------------------------------------------------------------------------

def _batch_axes(sizes: Dict[str, int], batch: int) -> List[str]:
    axes, rem = [], batch
    for ax in ("pod", "data"):
        if ax in sizes and rem % sizes[ax] == 0 and rem >= sizes[ax]:
            axes.append(ax)
            rem //= sizes[ax]
    return axes


def batch_seq_spec(mesh, batch: int, seq: Optional[int] = None) -> Spec:
    """Spec of (batch, seq, ...) inputs: the batch over ("pod", "data")
    as far as it divides; an axis the batch cannot use goes to the
    sequence when it divides that."""
    sizes = mesh_axis_sizes(mesh)
    batch_axes, seq_axes = [], []
    remaining = batch
    for ax in ("pod", "data"):
        if ax not in sizes:
            continue
        if remaining % sizes[ax] == 0 and remaining >= sizes[ax]:
            batch_axes.append(ax)
            remaining //= sizes[ax]
        elif seq is not None and seq % sizes[ax] == 0:
            seq_axes.append(ax)
    if seq is None:
        return (_entry(batch_axes),)
    return (_entry(batch_axes), _entry(seq_axes))


def input_shardings(mesh, specs: Dict[str, torch.Tensor]
                    ) -> Dict[str, Sharding]:
    """Shardings of an ``input_specs`` dict (tensors or meta tensors)."""
    out = {}
    for name, t in specs.items():
        if t.dim() == 0:
            out[name] = Sharding(mesh, ())
        elif t.dim() == 1:
            out[name] = Sharding(mesh, batch_seq_spec(mesh, t.shape[0]))
        else:
            out[name] = Sharding(mesh, batch_seq_spec(mesh, t.shape[0],
                                                      t.shape[1]))
    return out


def logits_spec(mesh, batch: int, seq: int) -> Spec:
    parts = list(batch_seq_spec(mesh, batch, seq))
    parts += [None] * (3 - len(parts))
    if "model" in mesh_axis_sizes(mesh):
        parts[2] = "model"
    return tuple(parts)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def activation_constrainer(mesh, global_batch: int, seq_shard: bool = False):
    """``shard(x, kind)``: the layout an activation would take across
    the mesh, checked and not applied.  Kinds:

      "bld"      (B, L, D)     batch over pod/data
      "blhd"     (B, L, H, hd) and heads over "model" when they divide
      "ecd"      (E, cap, D)   experts over "model" when they divide
      "boundary" (B, L, D)     the residual stream between blocks; with
                 ``seq_shard`` L over "model" (sequence parallelism)

    One controller computes every data slot's share whole, so a layout
    changes no value (as a sharding constraint changes none in the
    reference): ``shard`` checks that each named dim divides (the batch
    dim against ``global_batch``, since a slot holds a share of it) and
    returns ``x``.  ``shard.spec(shape, kind)`` is the spec it checks."""
    sizes = mesh_axis_sizes(mesh)
    b = _entry(_batch_axes(sizes, global_batch))
    model_n = sizes.get("model", 1)

    def spec(shape, kind: str) -> Spec:
        if kind == "bld":
            return (b, None, None)
        if kind == "boundary":
            l_ok = seq_shard and shape[1] % model_n == 0 \
                and shape[1] >= model_n
            return (b, "model" if l_ok else None, None)
        if kind == "blhd":
            h_ok = shape[2] % model_n == 0 and shape[2] >= model_n
            return (b, None, "model" if h_ok else None, None)
        if kind == "ecd":
            e_ok = shape[0] % model_n == 0 and shape[0] >= model_n
            return ("model" if e_ok else None, None, None)
        raise ValueError(kind)

    def shard(x, kind: str):
        s = spec(tuple(x.shape), kind)
        for d, entry in enumerate(s):
            axes = entry_axes(entry)
            if not axes:
                continue
            n = math.prod(sizes[a] for a in axes)
            size = global_batch if kind != "ecd" and d == 0 else x.shape[d]
            if size % n:
                raise ValueError(f"activation {kind} {tuple(x.shape)}: dim "
                                 f"{d} ({size}) does not split over {axes}")
        return x

    shard.spec = spec
    return shard


# ---------------------------------------------------------------------------
# pieces of split tensors
# ---------------------------------------------------------------------------

def named_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` names, in dim order."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def slots(spec: Spec, mesh) -> List[Dict[str, int]]:
    """One ``{axis: index}`` per piece of a tensor with ``spec``, in the
    order :func:`split` returns the pieces (row-major over
    :func:`named_axes`)."""
    axes = named_axes(spec)
    sizes = mesh_axis_sizes(mesh)
    return [dict(zip(axes, idx))
            for idx in itertools.product(*(range(sizes[a]) for a in axes))]


def split(x: torch.Tensor, spec: Spec, mesh) -> List[torch.Tensor]:
    """The pieces of ``x`` under ``spec``, each a copy on its slot's
    device (axes the spec leaves out at index 0)."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for pos in slots(spec, mesh):
        piece = x
        for d, entry in enumerate(spec):
            axes = entry_axes(entry)
            if not axes:
                continue
            n = math.prod(sizes[a] for a in axes)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split over {axes}")
            k = 0
            for a in axes:
                k = k * sizes[a] + pos[a]
            w = x.shape[d] // n
            piece = piece.narrow(d, k * w, w)
        out.append(piece.to(mesh.device_at(**pos), copy=True))
    return out


def gather(pieces: List[torch.Tensor], spec: Spec, mesh,
           device) -> torch.Tensor:
    """The whole tensor from its :func:`split` pieces, on ``device``;
    differentiable.  A dim split over axes of size 1 is not copied: a
    one-piece tensor already on ``device`` comes back as it is."""
    sizes = mesh_axis_sizes(mesh)
    flat = [p.to(device) for p in pieces]
    # row-major pieces: the last split dim's pieces lie next to each other
    for d in reversed(range(len(spec))):
        axes = entry_axes(spec[d])
        n = math.prod(sizes[a] for a in axes)
        if n > 1:
            flat = [torch.cat(flat[i:i + n], dim=d)
                    for i in range(0, len(flat), n)]
    return flat[0]


def place_tree(tree, shardings):
    """Each leaf of a nested dict as its :func:`split` pieces, a list.
    ``shardings`` is the matching tree of :class:`Sharding`s (a
    BFPTensor of two for a BFP leaf, whose mantissa and exponent split
    alike); a leaf that is already a list of pieces stays as it is."""
    if isinstance(shardings, dict):
        return {k: place_tree(tree[k], shardings[k]) for k in shardings}
    if isinstance(tree, list):
        return tree
    if isinstance(shardings, BFPTensor):
        m, e = shardings.mantissa, shardings.exponent
        return [dataclasses.replace(tree, mantissa=pm, exponent=pe)
                for pm, pe in zip(split(tree.mantissa, m.spec, m.mesh),
                                  split(tree.exponent, e.spec, e.mesh),
                                  strict=True)]
    return split(tree, shardings.spec, shardings.mesh)


def gather_tree(tree, shardings, device):
    """The whole leaves of a :func:`place_tree` tree on ``device`` (a
    leaf that is not a list is moved there)."""
    if isinstance(shardings, dict):
        return {k: gather_tree(tree[k], shardings[k], device)
                for k in shardings}
    if not isinstance(tree, list):
        if isinstance(tree, BFPTensor):
            return dataclasses.replace(tree,
                                       mantissa=tree.mantissa.to(device),
                                       exponent=tree.exponent.to(device))
        return tree.to(device)
    if isinstance(shardings, BFPTensor):
        m, e = shardings.mantissa, shardings.exponent
        return dataclasses.replace(
            tree[0],
            mantissa=gather([p.mantissa for p in tree], m.spec, m.mesh,
                            device),
            exponent=gather([p.exponent for p in tree], e.spec, e.mesh,
                            device))
    return gather(tree, shardings.spec, shardings.mesh, device)
