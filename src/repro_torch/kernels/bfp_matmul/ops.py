"""K2 wrapper: block floating-point matmul.

:func:`bfp_matmul` quantizes A and B along K (``axis=-1`` and
``axis=0``; Algorithm 1, ``core/bfp.py``, a ragged last block zero-padded
exactly as the reference's ``_blockify``): on the card one launch of
``kernels/bfp_quantize`` an operand, on the CPU torch ops.  Then
:func:`bfp_matmul_quantized` dequantizes and multiplies.  On a CUDA
tensor that launches ``csrc/bfp_matmul.cu``; on a CPU tensor it runs
:func:`bfp_matmul_quantized_plain`.  Mantissas travel as int16, which
holds any ``mantissa_bits`` up to 15.  The kernel multiplies on the
TF32 tensor cores: up to 10 bits each dequantized operand is exact in one
TF32 term, and 11-15 bits enter as hi + lo terms (three products each).
"""
from __future__ import annotations

import torch

from repro_torch.core import bfp as bfp_lib
from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.bfp_quantize import ops as fused_bfp

MIN_BLOCKS = 132            # one block per SM of an H100
MAX_SPLITS = 8              # K splits of one tile: a cluster of blocks
TK = 32                     # K per step of the kernel
STAGES = 2                  # mantissa tiles in flight
SMEM_MAX = 232448           # shared memory a block may use
MAX_MANTISSA = 15           # int16 mantissas


def launch_shape(M: int, N: int, K: int, split_rows: int = 0) -> tuple:
    """(tile rows, tile columns, K splits) of the kernel for an (M, K) x
    (K, N) product.  The tile is 64 x 64, or 64 x 32 for N <= 32, or
    128 x 16 for N <= 16, so that few columns are masked; the K range is
    split (a power of two up to 8, each split keeping at least one K
    step) until the grid has :data:`MIN_BLOCKS` blocks.

    The K split fixes the order of each output's f32 sum, and every row
    is summed alone, so a row's result depends on N, K and the split, not
    on M.  ``split_rows`` (0: M) counts the tiles for the split from that
    many rows instead: the engine passes one image's rows, so an image
    gets the same bits at every batch size."""
    tn = 64 if N > 32 else 32 if N > 16 else 16
    tm = 128 if tn == 16 else 64
    tiles = -(-(split_rows or M) // tm) * -(-N // tn)
    steps = -(-K // TK)
    splits = 1
    while (splits < MAX_SPLITS and tiles * splits < MIN_BLOCKS
           and 2 * splits <= steps):
        splits *= 2
    return tm, tn, splits


def smem_bytes(tm: int, tn: int, kb: int) -> int:
    """Dynamic shared memory of one block (csrc/bfp_matmul.cu:smem_bytes):
    the ring of int16 mantissa tiles, the f32 tiles, the block indices of
    each step in the ring and the tile's exponents."""
    return STAGES * TK * (tm + tn) * 2 + (tm + tn) * (TK + 4) * 4 \
        + STAGES * TK * 4 + (tm + tn) * kb * 4


def _dequantize(m: torch.Tensor, e: torch.Tensor, block_size: int,
                mantissa_bits: int) -> torch.Tensor:
    """(R, K) mantissas with (R, KB) exponents -> (R, K) f32, exactly."""
    scale = bfp_lib.exp2i(e - mantissa_bits)
    scale = scale.repeat_interleave(block_size, dim=1)[:, : m.shape[1]]
    return m.to(torch.float32) * scale


def bfp_matmul_quantized_plain(ma, ea, mb, eb, *, block_size: int,
                               mantissa_bits: int) -> torch.Tensor:
    """Plain torch version of the kernel, on the same operands."""
    a = _dequantize(ma, ea, block_size, mantissa_bits)
    b = _dequantize(mb.t(), eb, block_size, mantissa_bits).t()
    return a @ b


def bfp_matmul_quantized(ma: torch.Tensor, ea: torch.Tensor,
                         mb: torch.Tensor, eb: torch.Tensor, *,
                         block_size: int = bfp_lib.DEFAULT_BLOCK,
                         mantissa_bits: int = bfp_lib.DEFAULT_MANTISSA,
                         split_rows: int = 0) -> torch.Tensor:
    """mA (M, K) int16, eA (M, KB) int32, mB (K, N) int16, eB (N, KB)
    int32 -> (M, N) f32.  ``split_rows``: see :func:`launch_shape`."""
    M, K = ma.shape
    N = mb.shape[1]
    kb = -(-K // block_size)
    if (mb.shape[0] != K or tuple(ea.shape) != (M, kb)
            or tuple(eb.shape) != (N, kb)):
        raise ValueError(f"bfp_matmul_quantized: shapes {tuple(ma.shape)} "
                         f"{tuple(ea.shape)} {tuple(mb.shape)} "
                         f"{tuple(eb.shape)}")
    if ma.device.type == "cpu":
        return bfp_matmul_quantized_plain(
            ma, ea, mb, eb, block_size=block_size,
            mantissa_bits=mantissa_bits)
    if ma.device.type != "cuda":
        raise ValueError(f"bfp_matmul: unsupported device {ma.device}")
    if not 0 <= mantissa_bits <= MAX_MANTISSA:
        raise ValueError(
            f"bfp_matmul kernel takes mantissa_bits <= {MAX_MANTISSA} "
            f"(int16 mantissas), got {mantissa_bits}")
    tm, tn, splits = launch_shape(M, N, K, split_rows)
    if smem_bytes(tm, tn, kb) > SMEM_MAX:
        raise ValueError(f"bfp_matmul kernel: {kb} exponent blocks along K "
                         f"do not fit in shared memory (block_size "
                         f"{block_size}, K {K})")
    for t, dt in ((ma, torch.int16), (ea, torch.int32), (mb, torch.int16),
                  (eb, torch.int32)):
        if t.device != ma.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("bfp_matmul_quantized takes contiguous int16 "
                             "mantissas and int32 exponents on one device")
    out = torch.empty((M, N), device=ma.device, dtype=torch.float32)
    lib = build.library()
    build.check(lib.bfp_matmul_f32(
        ma.data_ptr(), ea.data_ptr(), mb.data_ptr(), eb.data_ptr(),
        out.data_ptr(), M, N, K, block_size, mantissa_bits, tm, tn, splits,
        build.stream_handle(ma.device)), "bfp_matmul_f32")
    bfp_matmul_quantized.launches += 1
    return out


bfp_matmul_quantized.launches = 0


def quantize_operands(a: torch.Tensor, b: torch.Tensor, *,
                      block_size: int = bfp_lib.DEFAULT_BLOCK,
                      mantissa_bits: int = bfp_lib.DEFAULT_MANTISSA,
                      rounding: str = "trunc"):
    """A (M, K) and B (K, N) -> (mA, eA, mB, eB) in the kernel's types,
    each operand in one launch of ``kernels/bfp_quantize`` on the card
    (in its stored type, f32 or FP16)."""
    geo = dict(block_size=block_size, mantissa_bits=mantissa_bits,
               rounding=rounding)
    return (*fused_bfp.quantize(a.contiguous(), axis=-1, **geo),
            *fused_bfp.quantize(b.contiguous(), axis=0, **geo))


def bfp_matmul(a: torch.Tensor, b: torch.Tensor, *,
               block_size: int = bfp_lib.DEFAULT_BLOCK,
               mantissa_bits: int = bfp_lib.DEFAULT_MANTISSA,
               rounding: str = "trunc", split_rows: int = 0) -> torch.Tensor:
    """C = A @ B through shared-exponent BFP (A: (M, K), B: (K, N))."""
    refuse_autograd("bfp_matmul", a, b)
    ma, ea, mb, eb = quantize_operands(
        a, b, block_size=block_size, mantissa_bits=mantissa_bits,
        rounding=rounding)
    return bfp_matmul_quantized(ma, ea, mb, eb, block_size=block_size,
                                mantissa_bits=mantissa_bits,
                                split_rows=split_rows)
