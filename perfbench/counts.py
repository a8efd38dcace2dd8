"""Operations, bytes and peaks: the arithmetic behind every roofline and
MFU the benchmark reports.

The count is of each layer's work, from the frozen layer lists
(``plain/layers.py``), never of how the program does it:

* FLOPs are 2 x the MACs of direct convolution at the plane's size.
  Winograd's saving, extra TF32 terms, batch and bucket padding are not
  counted.  The learned 2x upsample counts the taps that meet a pixel of
  its input (9 MACs per 2x2 output block per channel pair), not the
  zeros of the inserted plane.
* Bytes are each layer's input, weights and output counted once, at
  ``STORAGE_BYTES`` a value: the FP16 storage the configurations state.
* A layer's bound is max(bytes / HBM bandwidth, FLOPs / peak).  The
  peak is the dense FP16/BF16 tensor rate: BFP with 10-bit mantissas is
  exact in FP16, so no faithful implementation of the datapath has a
  higher rate to reach for.

Peaks: NVIDIA's H100 SXM data sheet, dense, at the 700 W limit (the
same numbers as ``src/repro_torch/launch/mesh.py`` and
``chip_smoke.py``'s bound).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench.plain.layers import Layer, shapes

PEAK_FLOPS = 989e12          # FP16 / BF16 dense tensor, FLOP/s
PEAK_BYTES = 3.35e12         # HBM3, bytes/s
STORAGE_BYTES = 2


def kernel_class(ly: Layer) -> str:
    """``"k1"`` for a 3x3 stride-1 conv, ``"k2"`` for a 1x1 stride-1
    conv, ``""`` for the rest: the layers each roofline holds."""
    if ly["op"] != "conv" or ly["stride"] != 1:
        return ""
    return {3: "k1", 1: "k2"}.get(ly["kernel"], "")


def layer_work(layers: List[Layer], hw: Tuple[int, int]
               ) -> List[Dict[str, object]]:
    """Per layer of one image at ``hw``: name, class, FLOPs, bytes and
    which bound binds."""
    shp = shapes(layers, hw)
    out = []
    for ly in layers:
        h, w = shp[ly["inputs"][0]][:2]
        cin = sum(shp[n][2] for n in ly["inputs"])
        ho, wo, cout = shp[ly["name"]]
        flops = 0
        weights = 0
        if ly["op"] == "conv":
            k = ly["kernel"]
            flops = 2 * ho * wo * k * k * cin * cout
            weights = k * k * cin * cout
        elif ly["op"] == "upsample":
            flops = 2 * h * w * 9 * cin * cout
            weights = 9 * cin * cout
        nbytes = STORAGE_BYTES * (h * w * cin + weights + ho * wo * cout)
        if ly["op"] == "identity":
            nbytes = 0
        out.append({"name": ly["name"], "class": kernel_class(ly),
                    "flops": flops, "bytes": nbytes,
                    "bound_s": bound_s(flops, nbytes),
                    "binds": ("flops" if flops / PEAK_FLOPS
                              >= nbytes / PEAK_BYTES else "bytes")})
    return out


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def total(work: List[Dict[str, object]], key: str, cls=None) -> float:
    """Sum of ``key`` over the layers (of one class when given)."""
    return float(sum(r[key] for r in work
                     if cls is None or r["class"] == cls))
