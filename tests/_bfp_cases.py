"""Inputs of the BFP quantize tests, on the CPU and on the card: values
that reach every edge case of Algorithm 1 (``core/bfp.py``)."""
import numpy as np
import torch

DTYPES = (torch.float16, torch.float32)
AXES = (-1, -2, 0)
KS = (3, 35, 64, 2048)


def bfp_values(seed: int, shape, dtype, axis: int) -> torch.Tensor:
    """Values over many binades in ``dtype``, with exact zeros, an
    all-zero block, a block of tiny values and values far below their
    block's largest.  In f32 the tiny block's exponent less 10 falls
    below -126 (``exp2i``'s clamp) and there are f32 subnormals; in FP16
    the tiny block's steps fall below FP16's range and there are FP16
    subnormals."""
    rng = np.random.default_rng(seed)
    mshape = np.moveaxis(np.empty(shape), axis, -1).shape
    lo, hi = (-20, 12) if dtype == torch.float16 else (-40, 40)
    xm = rng.standard_normal(mshape) * np.exp2(rng.integers(lo, hi, mshape))
    xm[rng.uniform(size=mshape) < 0.05] = 0.0
    flat = xm.reshape(-1)
    sub = 1e-40 if dtype == torch.float32 else 2.0 ** -23
    flat[2::97] = rng.standard_normal(flat[2::97].shape) * sub
    rows = xm.reshape(-1, mshape[-1])
    rows[0, :32] = 0.0                                  # an all-zero block
    tiny = 2.0 ** (-20 if dtype == torch.float16 else -118)
    rows[1, :32] = rng.standard_normal(rows[1, :32].shape) * tiny
    out = np.ascontiguousarray(np.moveaxis(xm, -1, axis))
    return torch.from_numpy(out.astype(np.float32)).to(dtype)


def shape_for(axis: int, k: int):
    return {-1: (3, 5, k), -2: (3, k, 40), 0: (k, 33)}[axis]
