"""grok-1-314b — MoE 8e top-2 [hf:xai-org/grok-1; unverified].

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.
EP note (DESIGN.md §5): 8 experts < 16-way model axis -> expert-TP
(d_ff sharded over "model"), resolved automatically by ParamMeta prefs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, n_experts=8, top_k=2,
    rope_theta=10000.0,
)

SMOKE = ArchConfig(
    name="grok-1-314b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, n_experts=4, top_k=2,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
