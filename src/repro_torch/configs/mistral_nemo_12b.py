"""mistral-nemo-12b — dense GQA, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072; head_dim=128
(explicit: q-proj dim 4096 != d_model).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128, rope_theta=1000000.0,
)

SMOKE = ArchConfig(
    name="mistral-nemo-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=160, vocab=256, head_dim=24,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
