"""The port's LM stack: dense, ssm and hybrid families through the
microcode streams, with K4 (flash attention) and K5 (SSD chunk) at
prefill."""
from .transformer import LMModel, count_params, cross_entropy

__all__ = ["LMModel", "count_params", "cross_entropy"]
