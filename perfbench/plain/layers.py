"""Frozen layer lists of the STD networks (trunk, merge and pixel head).

Copied from the program's spec emitters at the commit that added the
benchmark (``src/repro_torch/models/fcn/backbones.py`` ``vgg16`` and
``resnet50``, ``fusion.py`` ``east_merge`` and ``pixellink_head``), as
plain dicts.  The reference runs them, and the operation and byte counts
of the rooflines and of the MFU are taken from them, so that no change to
the program can change what its time is divided by.

A layer: ``name``, ``op`` (conv, pool, upsample, identity, sigmoid),
``inputs`` (several = a channel concat, in order), ``out_ch``,
``kernel``, ``stride``, ``relu``, ``bn``, ``bias`` and ``res`` (none,
cache, add: the residual register of paper Fig. 3; the ReLU of an
``add`` word follows the add).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

Layer = Dict[str, object]


def layer(name, op, inputs, out_ch=0, kernel=1, stride=1, relu=False,
          bn=False, bias=True, res="none") -> Layer:
    return {"name": name, "op": op, "inputs": list(inputs), "out_ch": out_ch,
            "kernel": kernel, "stride": stride, "relu": relu, "bn": bn,
            "bias": bias, "res": res}


def _c(ch: int, width: float) -> int:
    return max(int(ch * width), 8)


def vgg16(width: float = 1.0) -> Tuple[List[Layer], List[str]]:
    """VGG-16's 13 convs (arXiv:1409.1556, configuration D, no FC
    layers) with BN, and the taps at 1/4 to 1/32."""
    out: List[Layer] = []
    prev, taps = "input", []
    for si, (n, ch) in enumerate([(2, 64), (2, 128), (3, 256), (3, 512),
                                  (3, 512)]):
        for bi in range(n):
            name = f"conv{si + 1}_{bi + 1}"
            out.append(layer(name, "conv", [prev], _c(ch, width), 3,
                             relu=True, bn=True, bias=False))
            prev = name
        pool = f"pool{si + 1}"
        out.append(layer(pool, "pool", [prev], kernel=2, stride=2))
        prev = pool
        if si >= 1:
            taps.append(pool)
    return out, taps


def resnet50(width: float = 1.0, blocks=(3, 4, 6, 3)
             ) -> Tuple[List[Layer], List[str]]:
    """ResNet-50 v1.5 (arXiv:1512.03385; the stride on the 3x3)."""
    out: List[Layer] = []
    out.append(layer("stem", "conv", ["input"], _c(64, width), 7, 2,
                     relu=True, bn=True, bias=False))
    out.append(layer("stem_pool", "pool", ["stem"], kernel=3, stride=2))
    prev, taps = "stem_pool", []
    for si, (n, base) in enumerate(zip(blocks, (64, 128, 256, 512))):
        mid = _c(base, width)
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            name = f"s{si + 1}b{bi + 1}"
            if bi == 0:
                out.append(layer(f"{name}_proj", "conv", [prev], mid * 4, 1,
                                 stride, bn=True, bias=False, res="cache"))
            else:
                out.append(layer(f"{name}_id", "identity", [prev],
                                 res="cache"))
            out.append(layer(f"{name}_c1", "conv", [prev], mid, 1,
                             relu=True, bn=True, bias=False))
            out.append(layer(f"{name}_c2", "conv", [f"{name}_c1"], mid, 3,
                             stride, relu=True, bn=True, bias=False))
            out.append(layer(f"{name}_c3", "conv", [f"{name}_c2"], mid * 4,
                             1, relu=True, bn=True, bias=False, res="add"))
            prev = f"{name}_c3"
        taps.append(prev)
    return out, taps


def east_merge(taps: Sequence[str], merge_ch: Sequence[int]
               ) -> Tuple[List[Layer], str]:
    """The EAST-style U-merge: per level a 1x1 squeeze, the learned 2x
    upsample, a concat with the lateral tap, a 1x1 and a 3x3 conv; then
    ``fuse_out``."""
    out: List[Layer] = []
    h = taps[-1]
    for i, lateral in enumerate(reversed(list(taps[:-1]))):
        ch = merge_ch[i]
        out.append(layer(f"merge{i + 1}_sq", "conv", [h], ch, 1, relu=True,
                         bn=True, bias=False))
        out.append(layer(f"merge{i + 1}_up", "upsample",
                         [f"merge{i + 1}_sq"]))
        out.append(layer(f"merge{i + 1}_c1", "conv",
                         [f"merge{i + 1}_up", lateral], ch, 1, relu=True,
                         bn=True, bias=False))
        out.append(layer(f"merge{i + 1}_c3", "conv", [f"merge{i + 1}_c1"],
                         ch, 3, relu=True, bn=True, bias=False))
        h = f"merge{i + 1}_c3"
    out.append(layer("fuse_out", "conv", [h], merge_ch[-1], 3, relu=True,
                     bn=True, bias=False))
    return out, "fuse_out"


def pixellink_head(feat: str) -> List[Layer]:
    """1 score + 8 link logits (a biased 1x1 conv) and their sigmoid."""
    return [layer("head_logits", "conv", [feat], 9, 1),
            layer("head_prob", "sigmoid", ["head_logits"])]


def pixellink(trunk: Tuple[List[Layer], List[str]],
              merge_ch: Sequence[int]) -> List[Layer]:
    """A trunk's layers and taps, the U-merge and the PixelLink head."""
    layers, taps = trunk
    merge, feat = east_merge(taps, merge_ch)
    return layers + merge + pixellink_head(feat)


def shapes(layers: List[Layer], hw: Tuple[int, int]
           ) -> Dict[str, Tuple[int, int, int]]:
    """(H, W, C) of every layer's output for an (H, W, 3) input."""
    out = {"input": (hw[0], hw[1], 3)}
    for ly in layers:
        ins = [out[n] for n in ly["inputs"]]
        h, w = ins[0][:2]
        c = sum(s[2] for s in ins)
        s = ly["stride"]
        if ly["op"] == "conv":
            out[ly["name"]] = (-(-h // s), -(-w // s), ly["out_ch"])
        elif ly["op"] == "pool":
            out[ly["name"]] = (-(-h // s), -(-w // s), c)
        elif ly["op"] == "upsample":
            out[ly["name"]] = (2 * h, 2 * w, c)
        else:
            out[ly["name"]] = (h, w, c)
    return out
