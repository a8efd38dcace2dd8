"""Parameter metadata: shape, dtype and initialiser declared together.

Modules declare :class:`ParamMeta` trees (nested dicts); :func:`materialize`
draws real tensors from a ``torch.Generator``, :func:`params_from_numpy`
carries a reference parameter tree across leaf for leaf, and counts read
shapes only, so no large model is ever allocated to be counted.  The
reference's sharding preferences wait for the multi-device plans
(ROADMAP Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bfp as bfp_lib

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
    leaf for leaf on ``device``.  bf16 values cross bit for bit."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
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
