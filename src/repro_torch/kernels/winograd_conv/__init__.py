"""K1: Winograd F(4x4, 3x3) conv, CUDA kernel + plain torch version."""
from .ops import winograd_conv2d, winograd_tiles, winograd_tiles_plain

__all__ = ["winograd_conv2d", "winograd_tiles", "winograd_tiles_plain"]
