"""The plain description of ``zamba2_7b.json``: its widths."""
from perfbench.plain.zamba2 import dims


def layers(cfg):
    return dims(cfg)
