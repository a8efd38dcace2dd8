"""K2: block floating-point matmul, CUDA kernel + plain torch version."""
from .ops import (bfp_matmul, bfp_matmul_quantized,
                  bfp_matmul_quantized_plain, quantize_operands)

__all__ = ["bfp_matmul", "bfp_matmul_quantized",
           "bfp_matmul_quantized_plain", "quantize_operands"]
