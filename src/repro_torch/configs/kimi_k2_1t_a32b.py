"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840,
MoE 384e top-8.  head_dim 7168//64 = 112.
Memory note (DESIGN.md §6): single-pod train_4k cannot hold f32 Adam
moments; the launcher defaults this arch to BFP8 moments + bf16 params.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, n_experts=384, top_k=8,
    rope_theta=50000.0,
)

SMOKE = ArchConfig(
    name="kimi-k2-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=32, vocab=256, n_experts=8, top_k=2,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
