"""mamba2-370m — SSD, attention-free [arXiv:2405.21060; unverified].

48L d_model=1024, ssm_state=128, d_inner=2048, headdim=64 (-> 32 ssm
heads), vocab=50280.  Attention-sharding features are inapplicable
(attn-free) — noted in DESIGN.md §4; arch fully supported.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280, ssm_state=128, ssm_headdim=64,
    ssm_expand=2, ssm_groups=1, ssm_chunk=128,
)

SMOKE = ArchConfig(
    name="mamba2-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=256, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
