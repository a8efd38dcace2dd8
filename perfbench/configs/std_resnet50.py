"""The plain layer list of ``std_resnet50.json``."""
from perfbench.plain.layers import pixellink, resnet50


def layers(cfg):
    return pixellink(resnet50(cfg["width"]), cfg["merge_ch"])
