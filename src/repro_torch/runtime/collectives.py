"""Collectives between mesh slots, driven by one process: the halo
exchange of row bands, and the BFP-compressed gradient sum.

``compressed_psum``: the paper's C2 block quantizer applied to the
interconnect.  Each slot quantizes its tensor; the int8 (or int16)
mantissas and int32 block exponents are what cross to every other slot,
about a quarter of the f32 bytes; each slot then dequantizes the n
encodings and adds them in slot order, as the reference's loop does.

Halo exchange: the paper's §IV.B row-band overlap rows between mesh
slots.

Each slot along the band axis holds one horizontal band of an image
plane; before a spatial layer whose window crosses band edges, every band
takes ``halo`` boundary rows from its neighbours.  One process drives all
slots (``launch/mesh.py``), so the exchange is a list in, a list out: the
rows a band needs are sliced from the bands that hold them and copied to
its device with ``.to(device, non_blocking=True)``, a plain copy when the
two slots share a device and a peer copy across cards.  PyTorch runs a
copy between cards on the source's current stream after the work queued
there, and makes the destination's current stream wait for it, so a copy
follows its producer and precedes its consumer without a host sync.

When ``halo`` exceeds a band (four bands of a 128-row plane reach the
stride-32 map with one row each and a halo of 4), a band's rows come from
several neighbours, as in the reference's all-gather branch.  Rows beyond
the plane's edge are zeros, matching SAME padding (``core/rowband``).

With ``align`` a band's extension also reaches back to the plane row at
a multiple of ``align`` at or below its first row and on to the one at or
above its end: a tile grid of that period, laid from the extended band's
first row, then matches the full plane's.  The banded walk asks for it
before a Winograd F(4x4) conv (``align`` 4) so K1 sums every tile of a
band as it sums the full plane's, at any band offset; the reference
keeps the tiles aligned only where the offset is a multiple of 4.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.core import bfp as bfp_lib

F32 = torch.float32


def compressed_psum(xs: Sequence[torch.Tensor], *, mantissa_bits: int = 7,
                    block_size: int = 32) -> List[torch.Tensor]:
    """``xs``: one tensor per slot, each on its slot's device, all of one
    shape.  Returns each slot the sum over slots, in ``xs[i]``'s dtype
    on its device, computed from the moved BFP encodings."""
    xs = list(xs)
    if len({tuple(x.shape) for x in xs}) != 1:
        raise ValueError(f"compressed_psum: shapes differ: "
                         f"{[tuple(x.shape) for x in xs]}")
    wire = torch.int8 if mantissa_bits <= 7 else torch.int16
    sent = []
    for x in xs:
        q = bfp_lib.quantize(x.to(F32), block_size=block_size,
                             mantissa_bits=mantissa_bits, axis=-1,
                             rounding="nearest")
        sent.append((q.mantissa.to(wire), q.exponent.to(torch.int32)))
    ndim = xs[0].ndim
    out = []
    for x in xs:
        acc = torch.zeros(x.shape, dtype=F32, device=x.device)
        for m, e in sent:
            t = bfp_lib.BFPTensor(
                m.to(x.device, non_blocking=True).to(torch.int32),
                e.to(x.device, non_blocking=True), mantissa_bits,
                block_size, ndim - 1)
            acc = acc + bfp_lib.dequantize(t)
        out.append(acc.to(x.dtype))
    return out


def psum_bytes_model(nbytes_f32: int, n_devices: int, *, compressed: bool,
                     mantissa_bits: int = 7, block_size: int = 32
                     ) -> Tuple[int, int]:
    """(bytes of an f32 ring all-reduce, bytes of the compressed
    all-gather) per device for one tensor of ``nbytes_f32`` bytes."""
    ring = 2 * (n_devices - 1) * nbytes_f32 // n_devices
    mb = 1 if mantissa_bits <= 7 else 2
    q = nbytes_f32 // 4 * mb + nbytes_f32 // 4 // block_size
    gather = (n_devices - 1) * q // n_devices
    return ring, gather


def halo_bounds(n: int, band: int, halo: int, align: int = 1
                ) -> List[Tuple[int, int]]:
    """Plane rows ``[lo, hi)`` that each of ``n`` bands of ``band`` rows
    holds once extended by ``halo`` rows on both sides, and by up to
    ``align - 1`` more so that ``lo`` and ``hi`` are multiples of
    ``align``."""
    out = []
    for i in range(n):
        lo, hi = i * band - halo, (i + 1) * band + halo
        out.append((lo - lo % align, hi + -hi % align))
    return out


def halo_exchange(bands: Sequence[torch.Tensor], halo: int, *,
                  axis: int = 1, align: int = 1) -> List[torch.Tensor]:
    """``bands``: one band group's tensors in band order, equal extent
    along ``axis``, each on its own slot's device.  Returns each band
    extended along ``axis`` to its :func:`halo_bounds`, on the band's
    device; rows outside the plane are zeros."""
    bands = list(bands)
    if halo <= 0:
        return bands
    n, band = len(bands), bands[0].shape[axis]
    if any(b.shape[axis] != band for b in bands):
        raise ValueError("halo_exchange: bands differ in extent along axis "
                         f"{axis}: {[b.shape[axis] for b in bands]}")
    out = []
    for x, (lo, hi) in zip(bands, halo_bounds(n, band, halo, align)):
        parts = []
        if lo < 0:
            parts.append(_zeros(x, -lo, axis))
        for j, src in enumerate(bands):
            r0, r1 = max(lo, j * band), min(hi, (j + 1) * band)
            if r0 < r1:
                parts.append(src.narrow(axis, r0 - j * band, r1 - r0)
                             .to(x.device, non_blocking=True))
        if hi > n * band:
            parts.append(_zeros(x, hi - n * band, axis))
        out.append(torch.cat(parts, dim=axis))
    return out


def _zeros(like: torch.Tensor, rows: int, axis: int) -> torch.Tensor:
    shape = list(like.shape)
    shape[axis] = rows
    return torch.zeros(shape, dtype=like.dtype, device=like.device)
