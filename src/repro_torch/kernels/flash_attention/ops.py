"""K4 wrapper: blockwise online-softmax attention for prefill.

:func:`flash_attention` is the public op (``Lq == Lkv``, causal by
default); :func:`flash_attention_padded` runs the kernel on a CUDA tensor
(``csrc/flash_attention.cu``) and :func:`flash_attention_plain` on a CPU
tensor.  The CUDA kernel masks a ragged length itself, so nothing is
padded.  In bf16 it runs on the tensor cores (``wgmma``, K/V fed by TMA)
and takes any head dim that is a multiple of 8 up to 256
(:func:`wgmma_geometry`); in f32 it runs on the TF32 tensor cores in
3xTF32 (each operand split into two TF32 terms, three ``mma.sync`` per
product, f32-accurate) and takes any head dim up to 128.
:func:`decode_attention`, one new token against a KV cache, stays torch
ops, as the reference keeps it jnp.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, refuse_autograd

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_STAGES = 2               # K/V ring depth of the bf16 kernel
HALF_BYTES = 64 * 128       # one 64-row box of 64 bf16 columns


BF16_DMAX = 256             # the bf16 kernel's largest head dim
F32_DMAX = 128              # the f32 kernel's


def wgmma_geometry(head_dim: int) -> tuple:
    """(64-column boxes, shared-memory bytes per block) of the bf16
    kernel at this head dim (csrc/flash_attention.cu:wg_smem_bytes): Q
    and a ring of K and V tiles, each one, two or four 64-column TMA
    boxes (four for a head dim over 128, Zamba2-7B's 224), 1 KB of
    alignment slack and the mbarriers.  Raises for a head dim the kernel
    does not take."""
    if head_dim % 8 or not 8 <= head_dim <= BF16_DMAX:
        raise ValueError(f"flash_attention bf16 kernel takes a head dim "
                         f"that is a multiple of 8 up to {BF16_DMAX}, got "
                         f"{head_dim}")
    halves = 1 if head_dim <= 64 else 2 if head_dim <= 128 else 4
    smem = (1 + 2 * KV_STAGES) * halves * HALF_BYTES + 1024 \
        + 8 * (1 + 2 * KV_STAGES)
    return halves, smem


def flash_attention_plain(q, k, v, *, sm_scale: float, causal: bool,
                          kv_len: int) -> torch.Tensor:
    """Plain torch version of the kernel: dense f32 scores with the same
    masks, the softmax and P.V in f32, the result in q's type."""
    group = q.shape[1] // k.shape[1]
    kf = k.to(torch.float32).repeat_interleave(group, dim=1)
    vf = v.to(torch.float32).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kf) * sm_scale
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    mask = cols < kv_len
    if causal:
        mask = mask & (cols <= rows)
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, NEG_INF)),
                      dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def flash_attention_padded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, sm_scale: float, causal: bool,
                           kv_len: int) -> torch.Tensor:
    """q (B, Hq, Lq, D), k/v (B, Hkv, Lkv, D) -> (B, Hq, Lq, D) in q's
    type; columns at or past ``kv_len`` are masked.  On a CUDA tensor the
    kernel runs bf16 on ``wgmma`` and f32 on 3xTF32 ``mma.sync``; on a CPU
    tensor :func:`flash_attention_plain` runs.  The kernel has no
    backward, so operands that require grad are refused on both devices
    (:func:`repro_torch.kernels.refuse_autograd`)."""
    refuse_autograd("flash_attention", q, k, v)
    B, Hq, Lq, D = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != B
            or k.shape[3] != D or Hq % k.shape[1] != 0 or Lq != k.shape[2]):
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if not 1 <= kv_len <= k.shape[2]:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[1, {k.shape[2]}]")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, sm_scale=sm_scale,
                                     causal=causal, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _DTYPES or D > (BF16_DMAX if q.dtype == torch.bfloat16
                                      else F32_DMAX):
        raise ValueError(f"flash_attention kernel takes bf16 with head dim "
                         f"<= {BF16_DMAX} or f32 with head dim <= "
                         f"{F32_DMAX}, got {q.dtype}, D={D}")
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError("flash_attention takes contiguous q, k, v of "
                             "one type on one device")
    if q.dtype == torch.bfloat16:
        wgmma_geometry(D)
        if any(t.data_ptr() % 16 for t in (q, k, v)):   # TMA's alignment
            raise ValueError("flash_attention bf16 takes 16-byte aligned "
                             "q, k, v")
    out = torch.empty_like(q)
    lib = build.library()
    build.check(lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        k.shape[1], Lq, k.shape[2], D, kv_len, ctypes.c_float(sm_scale),
        int(causal), _DTYPES[q.dtype], build.stream_handle(q.device)),
        "flash_attention_fwd")
    flash_attention_padded.launches += 1
    return out


flash_attention_padded.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Prefill attention, q (B, Hq, L, D), k/v (B, Hkv, L, D); the scale
    is ``D ** -0.5`` unless given."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    return flash_attention_padded(q, k, v, sm_scale=float(sm_scale),
                                  causal=causal, kv_len=q.shape[2])


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     sm_scale: float | None = None) -> torch.Tensor:
    """One new token against a KV cache: q (B, Hq, 1, D), caches (B, Hkv,
    S, D), ``cache_len`` valid positions (an int or a (B,) tensor); the
    scale is ``D ** -0.5`` unless given."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    B, Hq, _, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg.to(torch.float32),
                     k_cache.to(torch.float32)) * sm_scale
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    lim = torch.as_tensor(cache_len, device=q.device)
    lim = lim.reshape(-1, 1, 1, 1) if lim.dim() else lim
    s = torch.where(pos < lim, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.to(torch.float32))
    return o.reshape(B, Hq, 1, D).to(q.dtype)
