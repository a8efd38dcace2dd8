"""Dense-softmax oracle for the flash attention kernel."""
from __future__ import annotations

import torch

from .ops import NEG_INF


def mha_reference(q, k, v, *, sm_scale: float | None = None,
                  causal: bool = True, kv_len: int | None = None
                  ) -> torch.Tensor:
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D); the causal mask is right
    aligned (column c is kept for row r when c <= r + Lkv - Lq)."""
    B, Hq, Lq, D = q.shape
    _, Hkv, Lkv, _ = k.shape
    group = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    kf = k.repeat_interleave(group, dim=1).to(torch.float32)
    vf = v.repeat_interleave(group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kf) * sm_scale
    cols = torch.arange(Lkv)[None, :]
    rows = torch.arange(Lq)[:, None]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool)
    if kv_len is not None:
        mask = mask & (cols < kv_len)
    if causal:
        mask = mask & (cols <= rows + (Lkv - Lq))
    s = torch.where(mask.to(q.device), s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
