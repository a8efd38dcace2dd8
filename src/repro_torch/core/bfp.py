"""Block floating-point (BFP), paper Algorithm 1 + §III.E / §IV.C.

Every block of ``block_size`` numbers along one axis shares the block's
maximum exponent; mantissas are integers right-shifted by the exponent
difference (arithmetic shift == hardware truncation), so the MAC array
runs fixed-point.  Accumulation stays wide (f32): the inputs are
quantized, the accumulator never is.

``quantize`` is bit-exact to the JAX package's ``core/bfp.py``, including
zeros, all-zero blocks (exponent ``-2**29``) and the zero-padded remainder
block.  Subnormal inputs are flushed to zero before ``frexp``: XLA on the
CPU treats them as zero, whereas ``torch.frexp`` decomposes them exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

DEFAULT_BLOCK = 32          # values per shared exponent (paper: norm block)
DEFAULT_MANTISSA = 10       # FP16 mantissa width used by the paper
WIDE_MANTISSA = 15          # paper's widened accumulator mantissa

_MIN_NORMAL = 2.0 ** -126


@dataclasses.dataclass
class BFPTensor:
    """``mantissa`` (int32, the original shape) and ``exponent`` (int32,
    one per block, laid out as ``movedim(x, axis, -1).shape[:-1] +
    (n_blocks,)``).  Value = ``mantissa * 2**(exponent - mantissa_bits)``.
    ``axis`` is stored negative."""

    mantissa: torch.Tensor
    exponent: torch.Tensor
    mantissa_bits: int
    block_size: int
    axis: int

    @property
    def shape(self):
        return self.mantissa.shape

    def nbytes_model(self) -> int:
        """Modelled storage: 1, 2 or 4 bytes a mantissa (up to 7, 15 or
        more bits) and 1 byte an exponent."""
        mbytes = 1 if self.mantissa_bits <= 7 else (
            2 if self.mantissa_bits <= 15 else 4)
        return int(self.mantissa.numel() * mbytes + self.exponent.numel())


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """EXACT 2**e for integer e, built in the f32 exponent field (never
    ``exp2``/``ldexp``); e is clamped to the normal range, which only
    matters for all-zero blocks, whose mantissas are 0."""
    e = torch.clamp(e.to(torch.int32), -126, 127)
    return ((e + 127) << 23).view(torch.float32)


def _blockify(x: torch.Tensor, block_size: int, axis: int
              ) -> Tuple[torch.Tensor, tuple]:
    """Move ``axis`` last, zero-pad it to a block multiple, and split it
    into ``(n_blocks, block_size)``."""
    axis = axis % x.ndim
    x = torch.movedim(x, axis, -1)
    orig = tuple(x.shape)
    n = orig[-1]
    pad = (-n) % block_size
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], (n + pad) // block_size, block_size), orig


def _unblockify(x: torch.Tensor, orig: tuple, axis: int, ndim: int
                ) -> torch.Tensor:
    x = x.reshape(*x.shape[:-2], -1)[..., : orig[-1]]
    return torch.movedim(x, -1, axis % ndim)


def quantize(x: torch.Tensor, *, block_size: int = DEFAULT_BLOCK,
             mantissa_bits: int = DEFAULT_MANTISSA, axis: int = -1,
             rounding: str = "trunc") -> BFPTensor:
    """Algorithm 1: xi = max_i e_i; d_i = xi - e_i; m_bi = m_i >> d_i.
    ``rounding='nearest'`` adds half an ulp before the shift."""
    if rounding not in ("trunc", "nearest"):
        raise ValueError(rounding)
    x32 = x.to(torch.float32)
    x32 = torch.where(x32.abs() < _MIN_NORMAL, torch.zeros_like(x32), x32)
    xb, orig = _blockify(x32, block_size, axis)
    m, e = torch.frexp(xb)                    # x = m * 2**e, |m| in [0.5, 1)
    e = torch.where(xb == 0, torch.full_like(e, -(2 ** 30)), e)
    xi = torch.amax(e, dim=-1, keepdim=True)  # block max exponent
    xi = torch.clamp(xi, min=-(2 ** 29))      # all-zero block
    d = torch.clamp(xi - e, max=31)
    mi = torch.trunc(m * (1 << mantissa_bits)).to(torch.int32)
    if rounding == "nearest":
        one = torch.ones_like(d)
        half = torch.where(d > 0, one << torch.clamp(d - 1, min=0),
                           torch.zeros_like(d))
        mi = mi + torch.sign(mi) * half
    mb = _unblockify(mi >> d, orig, axis, x.ndim)
    axis_store = axis if axis < 0 else axis - x.ndim
    return BFPTensor(mb, xi.squeeze(-1), mantissa_bits, block_size,
                     axis_store)


def dequantize(t: BFPTensor) -> torch.Tensor:
    mb, orig = _blockify(t.mantissa.to(torch.float32), t.block_size, t.axis)
    scale = exp2i(t.exponent - t.mantissa_bits)
    return _unblockify(mb * scale[..., None], orig, t.axis, t.mantissa.ndim)


def roundtrip(x: torch.Tensor, *, block_size: int = DEFAULT_BLOCK,
              mantissa_bits: int = DEFAULT_MANTISSA, axis: int = -1,
              rounding: str = "trunc") -> torch.Tensor:
    """Quantize-dequantize: the numerical effect of running through BFP."""
    return dequantize(quantize(
        x, block_size=block_size, mantissa_bits=mantissa_bits, axis=axis,
        rounding=rounding,
    )).to(x.dtype)


def quantization_error(x: torch.Tensor, **kw) -> torch.Tensor:
    """Mean relative error that the BFP roundtrip introduces."""
    y = roundtrip(x, **kw)
    denom = torch.clamp(x.abs(), min=1e-12)
    return torch.mean((x - y).abs() / denom)


def bfp_matmul_reference(a: torch.Tensor, b: torch.Tensor, *,
                         block_size: int = DEFAULT_BLOCK,
                         mantissa_bits: int = DEFAULT_MANTISSA,
                         rounding: str = "trunc",
                         wide_accum: bool = True) -> torch.Tensor:
    """C = A @ B with A (M, K) and B (K, N) quantized along K.  Within a
    block the mantissa dot is exact; across blocks the scaled partial sums
    accumulate in f32 (the wide accumulator of §IV.C).  With
    ``wide_accum=False`` every running partial sum is truncated back to
    ``mantissa_bits`` (one block per row of C), the failure mode the
    paper's Fig. 7 fixes."""
    qa = quantize(a, block_size=block_size, mantissa_bits=mantissa_bits,
                  axis=-1, rounding=rounding)
    qb = quantize(b, block_size=block_size, mantissa_bits=mantissa_bits,
                  axis=0, rounding=rounding)
    M, K = a.shape
    if b.shape[0] != K:
        raise ValueError(f"bfp_matmul_reference: shapes {tuple(a.shape)} "
                         f"{tuple(b.shape)}")
    N = b.shape[1]
    nb = -(-K // block_size)
    pad = nb * block_size - K
    ma = torch.nn.functional.pad(qa.mantissa, (0, pad)).reshape(
        M, nb, block_size)
    mb = torch.nn.functional.pad(qb.mantissa, (0, 0, 0, pad)).reshape(
        nb, block_size, N)
    partial = torch.einsum("mkb,kbn->kmn", ma.to(torch.float32),
                           mb.to(torch.float32))            # (nb, M, N)
    scale = exp2i(qa.exponent.t()[:, :, None] + qb.exponent.t()[:, None, :]
                  - 2 * mantissa_bits)                      # (nb, M, N)
    contrib = partial * scale
    if wide_accum:
        return contrib.sum(dim=0)
    out = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for c in contrib:
        out = roundtrip(out + c, block_size=N, mantissa_bits=mantissa_bits,
                        axis=-1, rounding="trunc")
    return out
