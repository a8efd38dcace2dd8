"""BFP quantize: Algorithm 1 in one CUDA kernel + ``core/bfp.py``'s ops."""
from .ops import bfp_quantize, quantize, roundtrip

__all__ = ["bfp_quantize", "quantize", "roundtrip"]
