"""internvl2-76b — InternViT + LM backbone [arXiv:2404.16821; unverified].

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  The InternViT
frontend is a STUB: input_specs() provides patch embeddings
(B, 256, d_model) prepended to the token sequence — DESIGN.md §4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, rope_theta=500000.0,
    frontend="vision_stub", frontend_len=256,
)

SMOKE = ArchConfig(
    name="internvl2-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, frontend="vision_stub", frontend_len=8,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
