"""whisper-tiny — enc-dec audio backbone [arXiv:2212.04356; unverified].

4L (encoder) + 4L (decoder), d_model=384 6H (MHA kv=6) d_ff=1536
vocab=51865.  The conv frontend is a STUB: input_specs() provides
precomputed frame embeddings (B, 1500, d_model) — DESIGN.md §4.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, norm="layernorm", act="gelu",
    encoder_layers=4, cross_attn=True,
    frontend="audio_stub", frontend_len=1500,
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, norm="layernorm", act="gelu",
    encoder_layers=2, cross_attn=True,
    frontend="audio_stub", frontend_len=12,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
