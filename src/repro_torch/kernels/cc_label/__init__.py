"""K3: tile-local CC spread, CUDA kernel + plain torch version."""
from .ops import (cc_label_tiled, local_spread_converge,
                  local_spread_converge_plain, local_spread_jacobi)

__all__ = ["cc_label_tiled", "local_spread_converge",
           "local_spread_converge_plain", "local_spread_jacobi"]
