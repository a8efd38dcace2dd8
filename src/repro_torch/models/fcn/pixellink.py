"""PixelLink-style STD model: backbone + fusion assembled to ONE
microcode program (paper Fig. 1 + §III).  Outputs are pixel-wise at 1/4
input scale: score (1 ch) and 8 neighbour links."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core import BFPConfig

from .heads import DetectionModel, PixelLinkHead


@dataclasses.dataclass(frozen=True)
class STDConfig:
    name: str = "pixellink_resnet50"
    backbone: str = "resnet50"
    width: float = 1.0
    image_size: Tuple[int, int] = (512, 512)     # (H, W); W <= 4096 (paper)
    merge_ch: Tuple[int, int, int] = (128, 64, 32)
    upsample_mode: str = "fused"
    mode: str = "optimized"                      # reference|optimized
    bfp: Optional[BFPConfig] = None
    storage_fp16: bool = True                    # paper's data-pool format
    use_kernels: bool = True                     # CUDA kernels in the
                                                 # optimized datapath
    memplan: bool = True                         # static memory plan


class PixelLinkModel(DetectionModel):
    """The ``head=PixelLinkHead()`` case: apply() returns {score (N,h,w),
    links (N,h,w,8), logits}."""

    def __init__(self, cfg: STDConfig, device="cuda"):
        super().__init__(cfg, PixelLinkHead(), device)
