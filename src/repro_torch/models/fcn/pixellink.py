"""PixelLink-style STD model: backbone + fusion assembled to ONE
microcode program (paper Fig. 1 + §III), and its training loss.  Outputs
are pixel-wise at 1/4 input scale: score (1 ch) and 8 neighbour links."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

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


def _bce(logit: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on logits, in the stable form."""
    return (torch.clamp(logit, min=0) - logit * y
            + torch.log1p(torch.exp(-torch.abs(logit))))


class STDLoss:
    """Class-balanced BCE on the score plus link BCE masked to positive
    pixels (PixelLink's loss structure, without instance balancing)."""

    def __init__(self, neg_ratio: float = 3.0, link_weight: float = 1.0):
        self.neg_ratio = neg_ratio
        self.link_weight = link_weight

    def __call__(self, outputs, score_gt: torch.Tensor,
                 link_gt: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = outputs["logits"]
        s_logit = logits[..., 0]
        l_logit = logits[..., 1:]
        pos = (score_gt > 0.5).to(torch.float32)
        neg = 1.0 - pos
        s_l = _bce(s_logit, score_gt)
        n_pos = torch.clamp(torch.sum(pos), min=1.0)
        # the negatives weigh as a budget of neg_ratio x the positives,
        # spread over all of them
        n_neg = torch.minimum(self.neg_ratio * n_pos, torch.sum(neg))
        w = pos + neg * (n_neg / torch.clamp(torch.sum(neg), min=1.0))
        score_loss = torch.sum(s_l * w) / torch.clamp(torch.sum(w), min=1.0)

        l_l = _bce(l_logit, link_gt)
        link_mask = pos[..., None]
        # a mean over elements: all n_links channels of every positive
        # pixel, so the denominator is positive pixels x n_links
        link_loss = torch.sum(l_l * link_mask) / torch.clamp(
            torch.sum(link_mask) * l_logit.shape[-1], min=1.0)
        total = score_loss + self.link_weight * link_loss
        return {"loss": total, "score_loss": score_loss,
                "link_loss": link_loss}
