"""Feature-fusion network (paper Fig. 1): EAST-style U-merge of the four
backbone taps + PixelLink pixel-wise heads.

The merge path per level: upsample the deeper feature x2, *concat* with
the lateral tap (concat = adjacent-address allocation in the assembler —
the paper's §III.B mechanism), then conv1x1 (channel squeeze) + conv3x3.
The head emits 1 score channel + 8 link channels through the fusion
module's sigmoid unit (which replaces maxpool in the fusion datapath —
paper §III.D).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.assembler import LayerSpec

N_LINKS = 8
HEAD_CH = 1 + N_LINKS        # score + 8 neighbor links


def east_merge(
    taps: Sequence[str],
    merge_ch: Sequence[int] = (128, 64, 32),
    upsample_mode: str = "fused",
) -> Tuple[List[LayerSpec], str]:
    """taps: [1/4, 1/8, 1/16, 1/32] feature names.  Returns (specs, out)."""
    assert len(taps) == 4
    specs: List[LayerSpec] = []
    h = taps[-1]                       # deepest (1/32)
    for i, lateral in enumerate(reversed(taps[:-1])):   # 1/16, 1/8, 1/4
        ch = merge_ch[i]
        # squeeze channels BEFORE upsampling so the fused (learnable
        # phase-decomposed) upsample kernel stays ch x ch
        sq = f"merge{i+1}_sq"
        specs.append(LayerSpec(sq, "conv", [h], out_ch=ch, kernel=1,
                               relu=True, bn=True, bias=False))
        up = f"merge{i+1}_up"
        specs.append(LayerSpec(up, "upsample", [sq],
                               upsample_mode=upsample_mode))
        cc = f"merge{i+1}_c1"
        specs.append(LayerSpec(cc, "conv", [up, lateral], out_ch=ch,
                               kernel=1, relu=True, bn=True, bias=False))
        cv = f"merge{i+1}_c3"
        specs.append(LayerSpec(cv, "conv", [cc], out_ch=ch, kernel=3,
                               relu=True, bn=True, bias=False))
        h = cv
    specs.append(LayerSpec("fuse_out", "conv", [h], out_ch=merge_ch[-1],
                           kernel=3, relu=True, bn=True, bias=False))
    return specs, "fuse_out"


def pixellink_head(feat: str) -> Tuple[List[LayerSpec], List[str]]:
    """1 score + 8 link channels, sigmoid'd (fusion-module sigmoid unit)."""
    specs = [
        LayerSpec("head_logits", "conv", [feat], out_ch=HEAD_CH, kernel=1),
        LayerSpec("head_prob", "sigmoid", ["head_logits"]),
    ]
    return specs, ["head_logits", "head_prob"]
