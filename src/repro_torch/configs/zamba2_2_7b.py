"""zamba2-2.7b — Mamba2 + shared attention blocks [arXiv:2411.15242; hf].

54L d_model=2560 32H (GQA kv=32 = MHA) d_ff=10240, ssm_state=64.
Weight sharing of the attention block across its 9 call sites is
microcode address reuse (same binding name at every site) — DESIGN.md §4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, ssm_state=64, ssm_headdim=64,
    ssm_expand=2, ssm_groups=1, attn_every=6, ssm_chunk=128,
)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16,
    attn_every=2, ssm_chunk=8,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
