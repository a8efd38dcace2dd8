"""Feature-extraction backbones as LayerSpec emitters (paper §III.A: "The
feature extraction network has several candidates such as ResNet, VGG, and
MobileNet... the developer can modify the microcode to compute different
networks").

Each emitter returns (specs, taps) where taps are the four feature levels
at 1/4, 1/8, 1/16, 1/32 of the input (paper Fig. 1).  Residual blocks use
the res_op cache/add mechanism exactly as the paper's Fig. 3; channel
widths may be scaled (``width``) for the reduced smoke configs.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.assembler import LayerSpec


def _c(ch: int, width: float) -> int:
    return max(int(ch * width), 8)


# ---------------------------------------------------------------------------
# ResNet-50 (v1.5: stride on the 3x3)
# ---------------------------------------------------------------------------

def resnet50(width: float = 1.0, blocks=(3, 4, 6, 3)) -> Tuple[List[LayerSpec], List[str]]:
    specs: List[LayerSpec] = []
    add = specs.append
    add(LayerSpec("stem", "conv", ["input"], out_ch=_c(64, width), kernel=7,
                  stride=2, relu=True, bn=True, bias=False))
    add(LayerSpec("stem_pool", "pool", ["stem"], kernel=3, stride=2))

    taps: List[str] = []
    prev = "stem_pool"
    in_ch = _c(64, width)
    for si, (n, base) in enumerate(zip(blocks, (64, 128, 256, 512))):
        mid = _c(base, width)
        out = mid * 4
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            name = f"s{si+1}b{bi+1}"
            if bi == 0:
                # projection shortcut: result cached (paper Fig. 3 pattern)
                add(LayerSpec(f"{name}_proj", "conv", [prev], out_ch=out,
                              kernel=1, stride=stride, bn=True, bias=False,
                              res="cache"))
                first_in = prev
            else:
                # identity shortcut: cache the block input
                add(LayerSpec(f"{name}_id", "identity", [prev], res="cache"))
                first_in = prev
            add(LayerSpec(f"{name}_c1", "conv", [first_in], out_ch=mid,
                          kernel=1, relu=True, bn=True, bias=False))
            add(LayerSpec(f"{name}_c2", "conv", [f"{name}_c1"], out_ch=mid,
                          kernel=3, stride=stride, relu=True, bn=True,
                          bias=False))
            add(LayerSpec(f"{name}_c3", "conv", [f"{name}_c2"], out_ch=out,
                          kernel=1, bn=True, bias=False, res="add",
                          relu=True))
            prev = f"{name}_c3"
        taps.append(prev)
        in_ch = out
    return specs, taps


# ---------------------------------------------------------------------------
# VGG-16 (without FC layers, as in the paper's Fig. 8b)
# ---------------------------------------------------------------------------

def vgg16(width: float = 1.0) -> Tuple[List[LayerSpec], List[str]]:
    cfg = [
        (2, 64), (2, 128), (3, 256), (3, 512), (3, 512),
    ]
    specs: List[LayerSpec] = []
    prev = "input"
    taps: List[str] = []
    for si, (n, ch) in enumerate(cfg):
        for bi in range(n):
            name = f"conv{si+1}_{bi+1}"
            specs.append(LayerSpec(name, "conv", [prev], out_ch=_c(ch, width),
                                   kernel=3, relu=True, bn=True, bias=False))
            prev = name
        pool = f"pool{si+1}"
        specs.append(LayerSpec(pool, "pool", [prev], kernel=2, stride=2))
        prev = pool
        if si >= 1:
            taps.append(pool)     # pool2 1/4, pool3 1/8, pool4 1/16, pool5 1/32
    return specs, taps


# ---------------------------------------------------------------------------
# MobileNet-v1 style (depthwise separable; ext_flags bit 0 = depthwise)
# ---------------------------------------------------------------------------

def mobilenet(width: float = 1.0) -> Tuple[List[LayerSpec], List[str]]:
    specs: List[LayerSpec] = []
    prev = "input"
    specs.append(LayerSpec("stem", "conv", [prev], out_ch=_c(32, width),
                           kernel=3, stride=2, relu=True, bn=True,
                           bias=False))
    prev = "stem"
    plan = [  # (stride, out_ch)
        (1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
        (2, 512), (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
        (2, 1024), (1, 1024),
    ]
    taps: List[str] = []
    cur_scale = 2
    tap_scales = {4, 8, 16, 32}
    in_ch = _c(32, width)
    for i, (s, ch) in enumerate(plan):
        if s == 2 and cur_scale in tap_scales:
            taps.append(prev)
        dw = f"dw{i+1}"
        pw = f"pw{i+1}"
        specs.append(LayerSpec(dw, "conv", [prev], out_ch=in_ch, kernel=3,
                               stride=s, relu=True, bn=True, bias=False,
                               table={"depthwise": True}))
        specs.append(LayerSpec(pw, "conv", [dw], out_ch=_c(ch, width),
                               kernel=1, relu=True, bn=True, bias=False))
        prev = pw
        in_ch = _c(ch, width)
        cur_scale *= s
    taps.append(prev)
    return specs, taps[-4:]


BACKBONES = {"resnet50": resnet50, "vgg16": vgg16, "mobilenet": mobilenet}
