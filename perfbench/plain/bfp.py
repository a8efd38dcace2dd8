"""Block floating point and the small conv helpers of the reference.

A frozen copy of the program's arithmetic, so that a later change to the
program cannot move its own yardstick:

* :func:`roundtrip` is paper Algorithm 1 (shared block exponent,
  mantissas truncated by the exponent difference) followed by its
  dequantisation, as ``src/repro_torch/core/bfp.py`` (``quantize``,
  ``dequantize``, ``roundtrip``) computes it;
* :func:`fold_batchnorm` is ``src/repro_torch/core/fuse.py``'s
  ``fold_batchnorm`` (paper Fig. 4's weight normalisation, before the
  BFP step);
* :func:`same_pads` is XLA's ``"SAME"`` rule, which the program follows
  for every window and stride (``core/fuse.py`` ``same_pads``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_MIN_NORMAL = 2.0 ** -126


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2**e for integer e, built in the f32 exponent field."""
    e = torch.clamp(e.to(torch.int32), -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def roundtrip(x: torch.Tensor, *, block_size: int, mantissa_bits: int,
              axis: int, rounding: str = "trunc") -> torch.Tensor:
    """f32 ``x`` through BFP along ``axis`` and back, in f32: each block of
    ``block_size`` values shares its largest exponent, each mantissa keeps
    ``mantissa_bits`` bits below it and is truncated (``"trunc"``) or
    rounded half up in magnitude (``"nearest"``)."""
    if rounding not in ("trunc", "nearest"):
        raise ValueError(rounding)
    x = x.to(torch.float32)
    x = torch.where(x.abs() < _MIN_NORMAL, torch.zeros_like(x), x)
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1)
    orig = tuple(x.shape)
    n = orig[-1]
    pad = (-n) % block_size
    if pad:
        x = F.pad(x, (0, pad))
    xb = x.reshape(*x.shape[:-1], (n + pad) // block_size, block_size)
    m, e = torch.frexp(xb)
    e = torch.where(xb == 0, torch.full_like(e, -(2 ** 30)), e)
    xi = torch.clamp(torch.amax(e, dim=-1, keepdim=True), min=-(2 ** 29))
    d = torch.clamp(xi - e, max=31)
    mi = torch.trunc(m * (1 << mantissa_bits)).to(torch.int32)
    if rounding == "nearest":
        one = torch.ones_like(d)
        half = torch.where(d > 0, one << torch.clamp(d - 1, min=0),
                           torch.zeros_like(d))
        mi = mi + torch.sign(mi) * half
    y = (mi >> d).to(torch.float32) * exp2i(xi - mantissa_bits)
    y = y.reshape(*y.shape[:-2], -1)[..., :n]
    return torch.movedim(y, -1, axis)


def fold_batchnorm(w, b, gamma, beta, mean, var, eps: float = 1e-5):
    """BN(conv(x, w) + b) as one conv (w', b'); ``w`` is HWIO."""
    s = gamma * torch.rsqrt(var + eps)
    b0 = torch.zeros_like(beta) if b is None else b
    return w * s[None, None, None, :], (b0 - mean) * s + beta


def same_pads(n: int, k: int, s: int):
    """XLA ``"SAME"`` padding (lo, hi) of one spatial dim."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """NHWC ``x`` padded for a k x k window at stride s."""
    h_lo, h_hi = same_pads(x.shape[1], k, s)
    w_lo, w_hi = same_pads(x.shape[2], k, s)
    return F.pad(x, (0, 0, w_lo, w_hi, h_lo, h_hi), value=value)


def conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """NHWC x HWIO convolution with SAME padding, in f32."""
    k = w.shape[0]
    y = F.conv2d(pad_same(x, k, stride).permute(0, 3, 1, 2),
                 w.permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    xp = pad_same(x, k, s, value=float("-inf"))
    return F.max_pool2d(xp.permute(0, 3, 1, 2), k, s).permute(0, 2, 3, 1)


def upsample2x_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 3x3 SAME conv over the 2x zero-inserted plane: the learned
    upsample, computed the direct way (the program splits it by phase)."""
    n, h, wd, c = x.shape
    z = x.new_zeros((n, 2 * h, 2 * wd, c))
    z[:, ::2, ::2, :] = x
    return conv_same(z, w, 1)
