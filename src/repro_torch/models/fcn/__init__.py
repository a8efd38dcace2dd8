"""The paper's model family: PixelLink STD (VGG-16 / ResNet-50 / MobileNet
trunks + EAST-style U-merge) and the EAST and DB heads, assembled to
microcode and executed by repro_torch.core.FCNEngine."""
from . import backbones, fusion, heads, pixellink, postprocess
from .heads import (
    DEFAULT_MODEL,
    MODEL_ZOO,
    DBHead,
    DetectionHead,
    DetectionModel,
    EASTHead,
    PixelLinkHead,
    build_head,
    check_model,
    db_unclip_box,
    params_from_numpy,
)
from .pixellink import PixelLinkModel, STDConfig, STDLoss

__all__ = [
    "backbones", "fusion", "heads", "pixellink", "postprocess",
    "DEFAULT_MODEL", "MODEL_ZOO", "DBHead", "DetectionHead",
    "DetectionModel", "EASTHead", "PixelLinkHead", "build_head",
    "check_model", "db_unclip_box", "params_from_numpy",
    "PixelLinkModel", "STDConfig", "STDLoss",
]
