"""Architecture config schema and the four assigned input shapes.

Every LM architecture is a module ``configs/<id>.py`` exporting
``CONFIG`` (the published hyperparameters) and ``SMOKE`` (a reduced
config of the same family for CPU tests).  The fields and their defaults
are those of the reference's ``ArchConfig``, and the port's own for a
hybrid stack with explicit sites (zamba2-7b, which the reference lacks),
whose defaults leave every other arch as the reference builds it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"          # rmsnorm|layernorm
    act: str = "swiglu"            # swiglu|gelu|geglu (exact GELU gate)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_fission: int = 1           # split experts into d_ff slices
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssm_chunk: int = 128
    # --- hybrid (zamba2-style shared attention blocks) ---
    attn_every: int = 0            # 0 = pure family; k = shared attn block
                                   # after every k SSM layers
    # --- hybrid with explicit sites (zamba2-7b) ---
    # site s (before SSM layer hybrid_layer_ids[s]) runs shared block
    # s % num_mem_blocks over concat(hidden, embeddings); its output,
    # through the site's own linear, joins that layer's SSM input
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 1
    attn_scale: float = 0.0        # 0 -> hd ** -0.5
    adapter_rank: int = 0          # per-site low-rank term of the shared
                                   # MLP's gate/up projection
    norm_eps: float = 1e-6
    # --- enc-dec / prefix frontends (whisper / internvl stubs) ---
    encoder_layers: int = 0
    cross_attn: bool = False
    frontend: str = "none"         # none|audio_stub|vision_stub
    frontend_len: int = 0          # frames / patches fed by the stub
    # --- numerics / memory policy ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # BFP (paper C2) quantized matmul mode for forward compute
    bfp_forward: bool = False
    kv_cache_dtype: str = "compute"   # compute|int8 (C2 on the KV stream)
    bfp_block: int = 32
    bfp_mantissa: int = 10

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def attn_in(self) -> int:
        """Width of the attention input: concat(hidden, embeddings) at
        explicit hybrid sites, else the hidden width."""
        return 2 * self.d_model if self.hybrid_layer_ids else self.d_model

    @property
    def sm_scale(self) -> float:
        return self.attn_scale or self.hd ** -0.5

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic token mixing -> long_500k is runnable."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        from repro_torch.models.lm import transformer

        return transformer.count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.lm import transformer

        return transformer.count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train|prefill|decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skip)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, (
            "full O(L^2) attention at 524288 ctx is infeasible; arch has no "
            "sub-quadratic path (skip noted in DESIGN.md)"
        )
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *,
                batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of ``shape``: tensors on the meta
    device (shape and dtype, no storage).  A frontend arch's
    ``prefix_embed`` is the stub's (B, frontend_len, d_model) output in
    the compute type."""
    b = batch if batch is not None else shape.global_batch
    s = shape.seq_len

    def spec(dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        # one new token against a seq_len-deep cache
        return {"tokens": spec((b, 1)), "cache_len": spec(())}
    specs = {"tokens": spec((b, s))}
    if shape.kind == "train":
        specs["labels"] = spec((b, s))
    if cfg.frontend != "none":
        specs["prefix_embed"] = spec((b, cfg.frontend_len, cfg.d_model),
                                     getattr(torch, cfg.compute_dtype))
    return specs
