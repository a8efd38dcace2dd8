"""Row-wise segmentation (paper §IV.B): layer execution in horizontal
bands.

The FPGA streams each feature map through the datapath in bands of rows,
sizing the band so the on-chip buffer is filled but not blown.  Across a
device mesh the same pattern splits an image plane into bands, one per
slot, each extended by the rows its windows reach into its neighbours.

``conv2d_banded`` equals the full-plane convolution: band b computes
output rows [r0, r1) from input rows [r0*s - p, (r1-1)*s + k - p]
clipped to the plane, zero-padded only at the true image border.

``band_schedule`` is the paper's sizing rule: rows per round so that
(rows x W x Cin x bytes) fits the buffer budget.

``program_halo_rows`` walks an assembled :class:`~repro_torch.core.
assembler.Program` and bounds the input-row receptive-field radius of its
outputs (how much context one end-to-end band would need);
``program_band_costs`` counts a program's FLOPs and the halo bytes a band
exchanges when every spatial layer swaps its own boundary rows, as
``FCNEngine``'s banded walk does: the cost model's inputs
(``runtime/planner.py``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def band_schedule(h: int, w: int, cin: int, *, buffer_bytes: int,
                  dtype_bytes: int = 2, halo: int = 1
                  ) -> List[Tuple[int, int]]:
    """Output-row ranges per round such that each round's input band fits
    the buffer (the paper's dynamic rows-per-round rule)."""
    row_bytes = max(w * cin * dtype_bytes, 1)
    rows = max(int(buffer_bytes // row_bytes) - 2 * halo, 1)
    return [(r0, min(r0 + rows, h)) for r0 in range(0, h, rows)]


def conv2d_banded(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  n_bands: int = 0,
                  bands: Optional[List[Tuple[int, int]]] = None
                  ) -> torch.Tensor:
    """x (N, H, W, Cin), w (k, k, Cin, Cout): the conv with (k-1)//2
    zero rows and columns of padding on every side, computed band by
    band; equals the full conv."""
    n, h, wd, cin = x.shape
    k = w.shape[0]
    pad = (k - 1) // 2
    out_h = -(-h // stride)
    if bands is None:
        n_bands = max(n_bands, 1)
        per = -(-out_h // n_bands)
        bands = [(r0, min(r0 + per, out_h)) for r0 in range(0, out_h, per)]
    w_oihw = w.permute(3, 2, 0, 1)
    outs = []
    for r0, r1 in bands:
        in_lo = r0 * stride - pad
        in_hi = (r1 - 1) * stride + k - pad          # exclusive
        lo, hi = max(in_lo, 0), min(in_hi, h)
        band = x[:, lo:hi].permute(0, 3, 1, 2)
        # zero rows only where the true image border was crossed; the W
        # dim keeps its padding
        band = F.pad(band, (pad, pad, lo - in_lo, in_hi - hi))
        y = F.conv2d(band, w_oihw, stride=stride)
        outs.append(y.permute(0, 2, 3, 1))
    return torch.cat(outs, dim=1)


def program_halo_rows(program) -> int:
    """Input-row receptive-field radius (upper bound) of a whole program.

    Tracks per-address (jump, radius) in input-row units: a conv/pool of
    kernel k grows the radius by (k-1)*jump, a strided layer multiplies
    the jump, an upsample halves it.  Concat reads follow the
    interpreter's adjacent-extent walk; the residual cache/add register
    and binary adds take the max over their inputs.  Unknown producers
    fall back to the worst (jump, radius) seen so far, so the result can
    only over-estimate."""
    from .assembler import STORAGE_BYTES
    from .microcode import ExtOp, LayerType, ResOp

    info = {program.input_addr: (1.0, 0.0)}     # addr -> (jump, radius)

    def worst():
        return (max(j for j, _ in info.values()),
                max(r for _, r in info.values()))

    def read(addr, want_ch):
        j = r = 0.0
        cur, got = addr, 0
        while got < want_ch:
            if cur not in info or cur not in program.addr_shapes:
                return worst()
            ji, ri = info[cur]
            j, r = max(j, ji), max(r, ri)
            h, w, c = program.addr_shapes[cur]
            got += c
            cur += h * w * c * STORAGE_BYTES
        return j, r

    cache = (1.0, 0.0)
    for idx, mc in enumerate(program.words):
        spec = program.layer_specs[idx]
        j, r = read(mc.in_addr, mc.in_ch)
        lt = LayerType(mc.layer_type)
        if lt == LayerType.CONV:
            r += (mc.kernel_size - 1) * j
            j *= mc.stride_n
        elif lt == LayerType.POOL:
            k = 2 if mc.kernel == 0 else 3
            r += (k - 1) * j
            j *= mc.stride_n
        elif lt == LayerType.UPSAMPLE:
            j /= 2.0
            if spec.upsample_mode == "fused":
                r += 2 * j                       # the fused 3x3 conv
        elif ExtOp(mc.ext_opcode) == ExtOp.ADD and mc.ext_addr2:
            j2, r2 = read(mc.ext_addr2, mc.in_ch)
            j, r = max(j, j2), max(r, r2)
        if mc.res_op == ResOp.CACHE:
            cache = (j, r)
        elif mc.res_op == ResOp.ADD:
            j, r = max(j, cache[0]), max(r, cache[1])
        info[mc.out_addr] = (j, r)

    return int(np.ceil(max(info[a][1] for a in program.outputs.values())))


def layer_halo(k: int, s: int) -> int:
    """Rows a band takes from each neighbour before a spatial layer of
    kernel ``k`` and stride ``s`` (0 when windows never cross a band
    edge, k <= s): the context rounded up to the stride phase, then to a
    multiple of 4 so the Winograd F(4x4) tile grid stays aligned with the
    full plane wherever the band offset is itself a multiple of 4."""
    if k <= s:
        return 0
    halo = s * (-(-(k - 1) // s))
    return -(-halo // 4) * 4


def program_band_costs(program, *, dtype_bytes: int = 4,
                       mode: str = "optimized") -> dict:
    """Per-image cost features of running an assembled program row-banded:

      ``flops``       forward FLOPs of one image at this plane (MACs x 2
                      for conv/upsample, one op per output element for
                      pool and ext words),
      ``halo_bytes``  bytes ONE band exchanges with its neighbours per
                      image when every spatial layer with k > s swaps its
                      own boundary rows (:func:`layer_halo`, two
                      directions per layer),
      ``halo_layers`` how many layers exchange at all.

    ``mode`` is the engine's: "optimized" counts the phase-decomposed
    fused upsample (one 3x3 MAC per input position), "reference" the
    naive upsample-then-conv (one per output position).  A pure shape
    walk: no parameters, no device work."""
    from .microcode import ExtOp, LayerType

    if mode not in ("reference", "optimized"):
        raise ValueError(mode)

    flops = 0.0
    halo_bytes = 0.0
    halo_layers = 0
    for idx, mc in enumerate(program.words):
        spec = program.layer_specs[idx]
        oh, ow, oc = program.addr_shapes[mc.out_addr]
        lt = LayerType(mc.layer_type)
        if lt == LayerType.CONV:
            k, s = mc.kernel_size, mc.stride_n
            flops += 2.0 * k * k * mc.in_ch * oc * oh * ow
        elif lt == LayerType.POOL:
            k, s = (2 if mc.kernel == 0 else 3), mc.stride_n
            flops += float(k * k * oh * ow * oc)
        elif lt == LayerType.UPSAMPLE:
            k, s = (1 if spec.upsample_mode == "nearest" else 3), 1
            if spec.upsample_mode != "nearest":
                pos = (oh // 2) * (ow // 2) if mode == "optimized" else oh * ow
                flops += 2.0 * k * k * mc.in_ch * oc * pos
        else:
            if ExtOp(mc.ext_opcode) != ExtOp.NONE:
                flops += float(oh * ow * oc)
            continue
        halo = layer_halo(k, s)
        if halo:
            iw = ow * s if lt != LayerType.UPSAMPLE else ow // 2
            halo_bytes += 2.0 * halo * iw * mc.in_ch * dtype_bytes
            halo_layers += 1
    return {"flops": flops, "halo_bytes": halo_bytes,
            "halo_layers": halo_layers}


def bytes_per_round(h0: int, h1: int, w: int, cin: int, k: int,
                    stride: int, dtype_bytes: int = 2) -> int:
    """Input bytes loaded for one round (halo included): the
    load-vs-compute balance term of the paper's §IV.B."""
    pad = (k - 1) // 2
    rows = (h1 - 1 - h0) * stride + k - 2 * pad + 2 * pad
    return rows * w * cin * dtype_bytes
