"""Parameter metadata: shape, dtype, initialiser and sharding declared
together.

Modules declare :class:`ParamMeta` trees (nested dicts); :func:`materialize`
draws real tensors from a ``torch.Generator``, :func:`params_from_numpy`
carries a reference parameter tree across leaf for leaf (an optimizer
state too), :func:`abstract` gives meta-device stand-ins, and counts read
shapes only, so no large model is ever allocated to be counted.

Sharding is declared as axis preferences and resolved against a mesh
with divisibility checks (:func:`best_spec`): a weight (d_model, d_ff)
prefers d_ff on "model" (tensor parallel) and d_model on "data" (fully
sharded data parallel); a preference whose dim does not divide the axis
is dropped, never padded.  The training step (``launch/step_fns.py``)
stores each parameter in the pieces its spec gives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bfp as bfp_lib
from repro_torch.runtime.sharding import (Sharding, Spec, entry_axes,
                                          mesh_axis_sizes)

_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int8": torch.int8, "int32": torch.int32,
}


def as_dtype(d) -> torch.dtype:
    """A torch dtype from a dtype or its name ("bfloat16", "float32")."""
    if isinstance(d, torch.dtype):
        return d
    if d not in _DTYPES:
        raise ValueError(f"unknown dtype {d!r}")
    return _DTYPES[d]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    dtype: Any = torch.float32
    init: str = "normal"          # normal|zeros|ones|scaled
    scale: float = 0.02
    # axis preferences: (dim, mesh axis or tuple of axes), tried in order;
    # each mesh axis used at most once per param
    prefs: Tuple[Tuple[int, Any], ...] = ()


def tree_map_meta(fn, tree):
    """Apply ``fn`` to every ParamMeta leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map_meta(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves_with_path(tree, path: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    else:
        yield path, tree


_DRAW_WHOLE = 1 << 31     # values drawn in one f32 temporary at most


def _draw(m: ParamMeta, generator: torch.Generator) -> torch.Tensor:
    dt = as_dtype(m.dtype)
    if m.init == "zeros":
        return torch.zeros(m.shape, dtype=dt, device=generator.device)
    if m.init == "ones":
        return torch.ones(m.shape, dtype=dt, device=generator.device)
    if m.init == "normal":
        scale = m.scale
    elif m.init == "scaled":      # fan-in scaled
        fan_in = m.shape[-2] if len(m.shape) >= 2 else m.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(m.init)
    if int(np.prod(m.shape)) <= _DRAW_WHOLE or len(m.shape) < 3:
        v = torch.randn(m.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (v * scale).to(dt)
    # a large stacked leaf (kimi-k2's experts: 5.6 G values) is drawn one
    # matrix at a time, so no f32 temporary holds all of it
    out = torch.empty(m.shape, dtype=dt, device=generator.device)
    flat = out.view(-1, *m.shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = torch.randn(m.shape[-2:], generator=generator,
                              dtype=torch.float32,
                              device=generator.device) * scale
    return out


def materialize(tree, generator: Optional[torch.Generator] = None,
                device="cpu"):
    """Real tensors for a ParamMeta tree, drawn from ``generator`` on its
    own device and moved to ``device`` (zeros and ones need none)."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def one(m: ParamMeta) -> torch.Tensor:
        return _draw(m, generator).to(device)

    return tree_map_meta(one, tree)


def scale_attention_to_fan_in(tree):
    """Rescale the attention projections of a parameter tree, in place,
    to the fan-in of the axes they contract, and return the tree
    (``LMModel.init_params`` applies it to every draw).  The ``scaled``
    init (the reference's) takes shape[-2] as the fan-in: n_heads for
    wq, wk, wv (d, n, hd) and head_dim for wo (n, hd, d).  So q and k
    come out with elements of std about sqrt(hd) and scores of std about
    hd, every softmax is near one-hot, a relative move of a layer's
    input comes out many-fold larger (two f32 runs of Whisper's prefill
    end O(1) apart), and a deep stack's gradients explode.  At fan-ins d
    and n*hd the scores have std about 1."""
    with torch.no_grad():
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                scale_attention_to_fan_in(leaf)
            elif key in ("wq", "wk", "wv"):
                leaf.mul_((leaf.shape[-2] / leaf.shape[-3]) ** 0.5)
            elif key == "wo":
                leaf.mul_(leaf.shape[-3] ** -0.5)
    return tree


def abstract(tree):
    """Meta-device tensors of each leaf's shape and type (no storage)."""
    return tree_map_meta(
        lambda m: torch.empty(m.shape, dtype=as_dtype(m.dtype),
                              device="meta"), tree)


def best_spec(meta: ParamMeta, mesh_shape: Dict[str, int]) -> Spec:
    """The axis preferences resolved against a mesh of ``mesh_shape``
    (axis name -> size): a spec over the leading dims up to the last one
    assigned, () when none is."""
    assign: Dict[int, Any] = {}
    used: set = set()
    for dim, axes in meta.prefs:
        if dim in assign or dim >= len(meta.shape):
            continue
        axes_t = axes if isinstance(axes, tuple) else (axes,)
        # the whole tuple first, then its axes one at a time
        candidates = [axes_t] + [(a,) for a in axes_t if len(axes_t) > 1]
        for cand in candidates:
            if any(a in used or a not in mesh_shape for a in cand):
                continue
            total = math.prod(mesh_shape[a] for a in cand)
            if meta.shape[dim] % total == 0 and meta.shape[dim] >= total:
                assign[dim] = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
    if not assign:
        return ()
    return tuple(assign.get(d) for d in range(max(assign) + 1))


def specs(tree, mesh):
    """Each leaf's :func:`best_spec` on ``mesh``."""
    shape = mesh_axis_sizes(mesh)
    return tree_map_meta(lambda m: best_spec(m, shape), tree)


def shardings(tree, mesh):
    shape = mesh_axis_sizes(mesh)
    return tree_map_meta(lambda m: Sharding(mesh, best_spec(m, shape)),
                         tree)


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own; move the bits
        t = torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """A reference parameter tree (nested dicts of numpy arrays, bf16
    included; BFP leaves with numpy mantissa and exponent) -> the port's,
    leaf for leaf on ``device``.  bf16 values cross bit for bit.  An
    optimizer state (``OptState``: step, mu, nu, extra; BFP moments under
    bfp8) crosses as the port's ``optim.OptState``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, tuple) and getattr(tree, "_fields", None) == \
            ("step", "mu", "nu", "extra"):
        from repro_torch.optim import OptState

        return OptState(*(params_from_numpy(v, device) for v in tree))
    if hasattr(tree, "mantissa") and hasattr(tree, "exponent"):
        return bfp_lib.BFPTensor(
            _tensor_from_numpy(tree.mantissa, device),
            _tensor_from_numpy(tree.exponent, device),
            int(tree.mantissa_bits), int(tree.block_size), int(tree.axis))
    return _tensor_from_numpy(tree, device)


# ---------------------------------------------------------------------------
# BFP weight storage (paper C2 as a serving-bandwidth feature): the large
# matmul weights are kept as int8 shared-exponent mantissas (+1 exponent
# per 32 values) and dequantized at use by the stream interpreter.
# ---------------------------------------------------------------------------

BFP_WEIGHT_BITS = 7
BFP_WEIGHT_BLOCK = 32
_BFP_MIN_SIZE = 1 << 20       # only quantize big matmul weights


def _bfp_eligible(path: Tuple[str, ...], meta: ParamMeta,
                  min_size: int = _BFP_MIN_SIZE) -> bool:
    if any("embed" in k for k in path):   # gather path stays dense
        return False
    return len(meta.shape) >= 2 and int(np.prod(meta.shape)) >= min_size


def quantize_weights(params, meta_tree, *, min_size: int = _BFP_MIN_SIZE):
    """Materialized params -> BFP storage for every eligible leaf (int8
    mantissas, nearest rounding, blocked along the last axis)."""
    def walk(p, m, path):
        if isinstance(m, dict):
            return {k: walk(p[k], m[k], path + (k,)) for k in m}
        if not _bfp_eligible(path, m, min_size):
            return p
        q = bfp_lib.quantize(p.to(torch.float32), block_size=BFP_WEIGHT_BLOCK,
                             mantissa_bits=BFP_WEIGHT_BITS, axis=-1,
                             rounding="nearest")
        return dataclasses.replace(q, mantissa=q.mantissa.to(torch.int8))

    return walk(params, meta_tree, ())


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def bfp_abstract(tree):
    """:func:`abstract` with each eligible leaf a BFPTensor of meta
    tensors (int8 mantissas, int32 block exponents)."""
    def one(path, m: ParamMeta):
        if not _bfp_eligible(path, m):
            return torch.empty(m.shape, dtype=as_dtype(m.dtype),
                               device="meta")
        nb = -(-m.shape[-1] // BFP_WEIGHT_BLOCK)
        return bfp_lib.BFPTensor(
            torch.empty(m.shape, dtype=torch.int8, device="meta"),
            torch.empty(m.shape[:-1] + (nb,), dtype=torch.int32,
                        device="meta"),
            BFP_WEIGHT_BITS, BFP_WEIGHT_BLOCK, -1)

    return _map_with_path(one, tree)


def exponent_spec(spec: Spec, ndim: int, n_blocks: int, mesh) -> Spec:
    """The spec of a BFP leaf's block exponents: the mantissa's, except
    that the last dim keeps its axes only where they divide the block
    count."""
    parts = list(spec) + [None] * (ndim - len(spec))
    axes = entry_axes(parts[-1]) if parts else ()
    if axes:
        sizes = mesh_axis_sizes(mesh)
        if n_blocks % math.prod(sizes[a] for a in axes):
            parts[-1] = None
    return tuple(parts)


def bfp_shardings(tree, mesh):
    """Shardings matching :func:`bfp_abstract`: the mantissa takes the
    parameter's spec, the exponent :func:`exponent_spec`."""
    sizes = mesh_axis_sizes(mesh)

    def one(path, m: ParamMeta):
        spec = best_spec(m, sizes)
        if not _bfp_eligible(path, m):
            return Sharding(mesh, spec)
        parts = tuple(spec) + (None,) * (len(m.shape) - len(spec))
        nb = -(-m.shape[-1] // BFP_WEIGHT_BLOCK)
        return bfp_lib.BFPTensor(
            Sharding(mesh, parts),
            Sharding(mesh, exponent_spec(spec, len(m.shape), nb, mesh)),
            BFP_WEIGHT_BITS, BFP_WEIGHT_BLOCK, -1)

    return _map_with_path(one, tree)
