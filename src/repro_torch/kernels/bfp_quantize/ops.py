"""BFP quantize: Algorithm 1 (``core/bfp.py``) as one kernel launch.

:func:`roundtrip` and :func:`quantize` give what ``core/bfp.py``'s
functions of the same names give, bit for bit.  For a CUDA tensor they
launch ``csrc/bfp_quantize.cu`` once (:func:`bfp_quantize`), which reads
the tensor once in its stored type, f32 or FP16, and writes the result
once; a CUDA tensor the kernel cannot take (another dtype, not
contiguous, more than 24 mantissa bits, or an operand autograd would
have to differentiate through) is refused, as K1 and K2 refuse theirs.
For a CPU tensor they run ``core/bfp.py``'s torch ops, the plain version
the tests compare with the reference package, under autograd too.

Counts: :func:`bfp_quantize` keeps its launches in ``launches``, as the
other kernels' wrappers do, and adds one ``bfp.fused`` to ``SPANS``'
tally a launch (an engine call hands it to its ``engine.run`` span).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core import bfp as bfp_lib
from repro_torch.kernels import build, refuse_autograd
from repro_torch.runtime.telemetry import SPANS

DTYPES = {torch.float32: 0, torch.float16: 1}
MAX_MANTISSA = 24           # the kernel's widest mantissa
MAX_LANES = 1 << 32         # (outer, block, inner) columns of one launch


def view_shape(shape, axis: int) -> Tuple[int, int, int]:
    """``(outer, K, inner)``: the sizes before, along and after ``axis``."""
    axis %= len(shape)
    return (math.prod(shape[:axis]), shape[axis],
            math.prod(shape[axis + 1:]))


def bfp_quantize(x: torch.Tensor, *, form: str, axis: int = -1,
                 block_size: int = bfp_lib.DEFAULT_BLOCK,
                 mantissa_bits: int = bfp_lib.DEFAULT_MANTISSA,
                 rounding: str = "trunc"):
    """One launch of the kernel on a contiguous f32 or FP16 CUDA tensor
    that needs no grad.
    ``form="roundtrip"``: ``(value,)``, f32 in ``x``'s shape;
    ``form="quantize"``: ``(mantissa, exponent)``, int16 in ``x``'s shape
    and int32 of shape ``movedim(x, axis, -1).shape[:-1] + (KB,)``."""
    if form not in ("roundtrip", "quantize"):
        raise ValueError(f"bfp_quantize: form {form!r}")
    if rounding not in ("trunc", "nearest"):
        raise ValueError(rounding)
    if x.device.type != "cuda":
        raise ValueError(f"bfp_quantize: unsupported device {x.device}")
    refuse_autograd("bfp_quantize", x)
    if x.dtype not in DTYPES or not x.is_contiguous() or x.dim() == 0:
        raise ValueError("bfp_quantize takes a contiguous f32 or FP16 "
                         "tensor")
    if not (block_size >= 1 and 0 <= mantissa_bits <= MAX_MANTISSA):
        raise ValueError(f"bfp_quantize: block_size {block_size}, "
                         f"mantissa_bits {mantissa_bits}")
    outer, k, inner = view_shape(tuple(x.shape), axis)
    kb = -(-k // block_size)
    if outer * kb * max(inner, 4) >= MAX_LANES:
        raise ValueError(f"bfp_quantize: {tuple(x.shape)} is too large for "
                         f"one launch")
    if form == "roundtrip":
        outs = (torch.empty(x.shape, device=x.device, dtype=torch.float32),)
        mant = expo = None
        val = outs[0].data_ptr()
    else:
        axis %= x.dim()
        eshape = tuple(x.shape[:axis]) + tuple(x.shape[axis + 1:]) + (kb,)
        outs = (torch.empty(x.shape, device=x.device, dtype=torch.int16),
                torch.empty(eshape, device=x.device, dtype=torch.int32))
        mant, expo = outs[0].data_ptr(), outs[1].data_ptr()
        val = None
    if x.numel():
        build.check(build.library().bfp_quantize(
            x.data_ptr(), DTYPES[x.dtype], mant, expo, val, outer, k, inner,
            block_size, mantissa_bits, int(rounding == "nearest"),
            build.stream_handle(x.device)), "bfp_quantize")
        bfp_quantize.launches += 1
        SPANS.count("bfp.fused")
    return outs


bfp_quantize.launches = 0


def roundtrip(x: torch.Tensor, *, block_size: int = bfp_lib.DEFAULT_BLOCK,
              mantissa_bits: int = bfp_lib.DEFAULT_MANTISSA, axis: int = -1,
              rounding: str = "trunc") -> torch.Tensor:
    """``core/bfp.roundtrip`` of ``x`` widened to f32 (exact, as the FCN
    engine and the reference's engine take it, whatever ``x``'s stored
    type), as a contiguous f32 tensor on either path: the layout decides
    which algorithm cuDNN runs on it next, and so its bits."""
    if x.device.type == "cuda":
        return bfp_quantize(
            x, form="roundtrip", axis=axis, block_size=block_size,
            mantissa_bits=mantissa_bits, rounding=rounding)[0]
    return bfp_lib.roundtrip(
        x.to(torch.float32), block_size=block_size,
        mantissa_bits=mantissa_bits, axis=axis, rounding=rounding,
    ).contiguous()


def quantize(x: torch.Tensor, *, block_size: int = bfp_lib.DEFAULT_BLOCK,
             mantissa_bits: int = bfp_lib.DEFAULT_MANTISSA, axis: int = -1,
             rounding: str = "trunc") -> Tuple[torch.Tensor, torch.Tensor]:
    """``core/bfp.quantize``'s mantissa, as contiguous int16, and its
    exponent, as contiguous int32."""
    if mantissa_bits > 15:
        raise ValueError("int16 mantissas hold at most 15 mantissa bits")
    if x.device.type == "cuda":
        return bfp_quantize(x, form="quantize", axis=axis,
                            block_size=block_size,
                            mantissa_bits=mantissa_bits, rounding=rounding)
    q = bfp_lib.quantize(x, block_size=block_size,
                         mantissa_bits=mantissa_bits, axis=axis,
                         rounding=rounding)
    return q.mantissa.to(torch.int16).contiguous(), q.exponent.contiguous()
