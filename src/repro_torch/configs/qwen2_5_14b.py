"""qwen2.5-14b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
TP note: 40 heads do not divide the 16-way model axis; the sharding
resolver falls back to d_ff TP + FSDP attention (no silent padding).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1000000.0,
)

SMOKE = ArchConfig(
    name="qwen2.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=256, qkv_bias=True,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
