"""The port's LM stack: every family through the microcode streams, with
K4 (flash attention) and K5 (SSD chunk) at prefill, and training mode
(autograd, optional recomputation of each layer)."""
from .transformer import LMModel, count_params, cross_entropy, token_nll

__all__ = ["LMModel", "count_params", "cross_entropy", "token_nll"]
