"""K4: flash attention for prefill, CUDA kernel + plain torch version."""
from .ops import (decode_attention, flash_attention, flash_attention_padded,
                  flash_attention_plain)

__all__ = ["decode_attention", "flash_attention", "flash_attention_padded",
           "flash_attention_plain"]
