"""K5: Mamba2 SSD intra-chunk block, CUDA kernel + plain torch version."""
from .ops import ssd_chunk, ssd_chunk_plain, ssd_decode_step, ssd_scan

__all__ = ["ssd_chunk", "ssd_chunk_plain", "ssd_decode_step", "ssd_scan"]
