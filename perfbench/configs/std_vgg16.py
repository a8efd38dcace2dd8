"""The plain layer list of ``std_vgg16.json``."""
from perfbench.plain.layers import pixellink, vgg16


def layers(cfg):
    return pixellink(vgg16(cfg["width"]), cfg["merge_ch"])
