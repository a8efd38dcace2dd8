"""Hand-written CUDA kernels for the port's main paths (Hopper, sm_90a).

Each package holds one kernel's wrapper beside a plain torch version of
the same function:

  winograd_conv/    K1, Winograd F(4x4, 3x3) conv: input transform,
                    tile products, output transform, bias and ReLU fused
  bfp_matmul/       K2, block floating-point matmul, f32 accumulation
  cc_label/         K3, tile-local connected-component spread
  flash_attention/  K4, blockwise online-softmax attention (LM prefill)
  ssd_scan/         K5, Mamba2 SSD intra-chunk block (LM prefill)
  bfp_quantize/     BFP encoding (Algorithm 1) of a conv's operands in
                    one pass: the FCN engine's roundtrips and K2's inputs

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel (built at first use by ``build.py``) or
raises.  Each wrapper counts its launches in a plain integer attribute,
``launches``, which :func:`launch_counts` reads and
:func:`reset_launch_counts` zeroes.

No kernel has a backward (nor has any Pallas kernel of the reference a
VJP): every wrapper raises, on any device, when grad mode is on and an
operand requires grad (:func:`refuse_autograd`), rather than return a
result that carries no gradient.  LM training therefore runs without
``use_flash`` and ``use_kernel``, as the reference's does.
``bfp_quantize``'s plain version on the CPU is ``core/bfp.py``'s ops,
which autograd can differentiate, so its wrappers refuse only on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def wrappers() -> Dict[str, object]:
    """Kernel name -> the wrapper function that launches it."""
    from .bfp_matmul.ops import bfp_matmul_quantized
    from .bfp_quantize.ops import bfp_quantize
    from .cc_label.ops import local_spread_converge
    from .flash_attention.ops import flash_attention_padded
    from .ssd_scan.ops import ssd_chunk
    from .winograd_conv.ops import winograd_tiles

    return {
        "winograd_tiles": winograd_tiles,
        "bfp_matmul_quantized": bfp_matmul_quantized,
        "local_spread_converge": local_spread_converge,
        "flash_attention_padded": flash_attention_padded,
        "ssd_chunk": ssd_chunk,
        "bfp_quantize": bfp_quantize,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would have to differentiate through kernel
    ``name``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an operand requires "
            f"grad; train in mode='reference' (as the reference does), or "
            f"call it under torch.no_grad()")
