"""zamba2-7b — Zamba2-7B-Instruct at its published widths.

Source: https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json
81 Mamba2 layers, hidden 3584; 13 of them (``hybrid_layer_ids``) are
preceded by one of two shared transformer blocks, used in turn (site s
uses block s mod 2).  A block reads RMSNorm(concat(hidden, embeddings)),
7168 wide: attention of 32 heads of 224 with RoPE (theta 1e4) and scale
(224 / 2) ** -0.5, output 3584 wide, then RMSNorm and an exact-GELU gated
MLP of 14336 whose gate/up projection carries a rank-128 term owned by
the site.  Each site's own 3584 x 3584 linear takes the block's output
into the input of the Mamba2 layer it precedes (not into the residual).
Mamba2: 112 heads of 64, 2 groups, d_state 64, conv 4 with bias, chunk
256, the gated RMSNorm per group of 3584.  RMSNorm eps 1e-5; the output
head is the embedding, tied (``Zamba2Config``'s default).
"""
from repro_torch.configs.base import ArchConfig

SITES = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=224,
    d_ff=14336, vocab=32000, act="geglu", tie_embeddings=True,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_groups=2,
    ssm_chunk=256, hybrid_layer_ids=SITES, num_mem_blocks=2,
    attn_scale=(224 / 2) ** -0.5, adapter_rank=128, norm_eps=1e-5,
)

# the same shape kind: 4 heads of 32 over the 128-wide concat, sites
# (2, 4, 7) so the blocks go 0, 1, 0, two SSM groups, chunk 8, rank 4
SMOKE = ArchConfig(
    name="zamba2-7b-smoke", family="hybrid",
    n_layers=9, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
    d_ff=128, vocab=256, act="geglu", tie_embeddings=True,
    ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_groups=2, ssm_chunk=8,
    hybrid_layer_ids=(2, 4, 7), num_mem_blocks=2, attn_scale=(32 / 2) ** -0.5,
    adapter_rank=4, norm_eps=1e-5,
    param_dtype="float32", compute_dtype="float32", remat=False,
)
