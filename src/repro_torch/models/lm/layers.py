"""LM datapath modules, dispatched by microcode ExtOps.

Every module is ``fn(params, x, *, mc, table, ctx) -> y``:

  * hyperparameters come from the microcode side-table,
  * ``ctx`` carries step state (positions, KV cache, routing flags),
  * every matmul accumulates in f32 and returns f32 (the reference's
    ``preferred_element_type=f32``), with optional BFP quantization of
    its input (paper C2).

Shapes are (B, L, D) throughout; decode is the L=1 case with a cache.
The KV cache is preallocated and written in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bfp as bfp_lib
from repro_torch.core.microcode import ExtOp
from repro_torch.kernels.flash_attention.ops import (decode_attention,
                                                     flash_attention)

from .params import ParamMeta, as_dtype

F32 = torch.float32
NEG_INF = -1e30
Q_CHUNK = 1024    # query rows per score block in _sdpa_full


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _maybe_bfp(x: torch.Tensor, table: Dict[str, Any], axis: int = -1):
    """Paper C2: quantize matmul inputs to shared-exponent blocks."""
    if table.get("bfp"):
        return bfp_lib.roundtrip(
            x.to(F32), block_size=table.get("bfp_block", 32),
            mantissa_bits=table.get("bfp_mantissa", 10), axis=axis)
    return x


class _LowPrecisionMatmul(torch.autograd.Function):
    """a @ w, 2-D or batched 3-D, of two CUDA tensors of one 16-bit type
    with an f32 result, by cuBLAS's ``out_dtype`` (which has no backward
    of its own).  The backward rounds the f32 cotangent to the operands'
    type and multiplies in that type with f32 accumulation; the CPU
    route widens the operands instead and stays exact in f32."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.save_for_backward(a, w)
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, w, out_dtype=F32)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = g @ w.transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gw = a.transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gw


low_precision_matmul = _LowPrecisionMatmul.apply


def card_route(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's route: on the card, and on the meta
    device, where the dry run (``launch/dryrun.py``) accounts for what
    the card would run and save."""
    return x.device.type in ("cuda", "meta")


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) with w cast to x's type, f32 accumulation
    and an f32 result.  Products of bf16 values are exact in f32, so on
    the CPU bf16 operands are widened first; on the card cuBLAS takes
    them as they are and returns f32 (:func:`low_precision_matmul`)."""
    w = w.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == F32:
        y = x2 @ w
    elif card_route(x):
        y = low_precision_matmul(x2, w)
    else:
        y = x2.to(F32) @ w.to(F32)
    return y.reshape(*lead, w.shape[-1])


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.to(F32), b.to(F32))


def dot(x, w, table: Optional[Dict[str, Any]] = None):
    """x @ w with f32 accumulation (+ optional BFP input quantization)."""
    return matmul_f32(_maybe_bfp(x, table or {}), w)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding; x: (B, L, H, hd), positions: (B, L)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    ang = positions.to(F32)[..., None] * freqs       # (B, L, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_meta(d: int, dtype) -> Dict[str, ParamMeta]:
    return {"scale": ParamMeta((d,), dtype, init="ones")}


def rmsnorm(p, x, *, mc=None, table=None, ctx=None):
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + 1e-6)
    return (y * p["scale"].to(F32)).to(x.dtype)


def layernorm_meta(d: int, dtype) -> Dict[str, ParamMeta]:
    return {"scale": ParamMeta((d,), dtype, init="ones"),
            "bias": ParamMeta((d,), dtype, init="zeros")}


def layernorm(p, x, *, mc=None, table=None, ctx=None):
    xf = x.to(F32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)  # jnp.var
    y = (xf - mu) * torch.rsqrt(var + 1e-5)
    return (y * p["scale"].to(F32) + p["bias"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------

def embed_meta(vocab: int, d: int, dtype) -> Dict[str, ParamMeta]:
    return {"table": ParamMeta((vocab, d), dtype, init="normal", scale=0.02,
                               prefs=((0, "model"), (1, "data")))}


def embed(p, tokens, *, mc=None, table=None, ctx=None):
    dtype = as_dtype(table.get("compute_dtype", "bfloat16")) if table \
        else torch.bfloat16
    return F.embedding(tokens, p["table"]).to(dtype)


def lm_head_meta(d: int, vocab: int, dtype) -> Dict[str, ParamMeta]:
    return {"w": ParamMeta((d, vocab), dtype, init="scaled",
                           prefs=((1, "model"), (0, "data")))}


def lm_head(p, x, *, mc=None, table=None, ctx=None):
    return dot(x, p["w"], table)       # f32 logits


# ---------------------------------------------------------------------------
# attention (GQA + RoPE; full / decode-with-cache)
# ---------------------------------------------------------------------------

def attention_meta(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype, qkv_bias: bool = False) -> Dict[str, ParamMeta]:
    m = {
        "wq": ParamMeta((d_model, n_heads, head_dim), dtype, init="scaled",
                        prefs=((1, "model"), (0, "data"))),
        "wk": ParamMeta((d_model, n_kv, head_dim), dtype, init="scaled",
                        prefs=((1, "model"), (0, "data"))),
        "wv": ParamMeta((d_model, n_kv, head_dim), dtype, init="scaled",
                        prefs=((1, "model"), (0, "data"))),
        "wo": ParamMeta((n_heads, head_dim, d_model), dtype, init="scaled",
                        prefs=((0, "model"), (2, "data"))),
    }
    if qkv_bias:
        m["bq"] = ParamMeta((n_heads, head_dim), dtype, init="zeros")
        m["bk"] = ParamMeta((n_kv, head_dim), dtype, init="zeros")
        m["bv"] = ParamMeta((n_kv, head_dim), dtype, init="zeros")
    return m


def _proj(x, w):
    """'bld,dhk->blhk' in f32."""
    d, h, k = w.shape
    return matmul_f32(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _proj_qkv(p, x, table):
    # the weights take x's type before any BFP widening of x, as in the
    # reference
    xin = _maybe_bfp(x, table)
    q, k, v = (_proj(xin, p[n].to(x.dtype)) for n in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"].to(F32)
        k = k + p["bk"].to(F32)
        v = v + p["bv"].to(F32)
    return q, k, v


def _sdpa_full(q, k, v, *, causal: bool, shard=None) -> torch.Tensor:
    """(B, L, H, hd) x (B, S, K, hd) dense attention with GQA broadcast.
    The probabilities are rounded to the compute type before P.V, as in
    the reference; queries go in chunks of ``Q_CHUNK`` rows so that one
    (B, H, chunk, S) score block is live at a time.  ``shard`` is the
    training step's activation constrainer (runtime/sharding.py)."""
    B, L, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    g = H // K
    kf = k.repeat_interleave(g, dim=2) if g > 1 else k
    vf = v.repeat_interleave(g, dim=2) if g > 1 else v
    if shard is not None:
        q, kf, vf = (shard(t, "blhd") for t in (q, kf, vf))
    scale = hd ** -0.5
    chunk = min(Q_CHUNK, L)

    def attend(qc, row0):
        s = _einsum_f32("blhd,bshd->bhls", qc, kf) * scale
        if causal:
            rows = row0 + torch.arange(qc.shape[1], device=q.device)[:, None]
            cols = torch.arange(S, device=q.device)[None, :]
            s = torch.where((cols <= rows + (S - L))[None, None], s,
                            torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=-1).to(qc.dtype)
        return _einsum_f32("bhls,bshd->blhd", pr, vf).to(qc.dtype)

    return torch.cat([attend(q[:, r:r + chunk], r)
                      for r in range(0, L, chunk)], dim=1)


def _kv_write(cache, k, v, pos):
    """Write K/V at ``pos`` in place (the start is clamped so the write
    fits, as ``dynamic_update_slice`` clamps it).  An int8 cache stores
    round(t / s) with one f16 scale s = max|t| / 127 per vector."""
    S, L = cache["k"].shape[1], k.shape[1]
    pos = min(max(int(pos), 0), S - L)
    if cache["k"].dtype == torch.int8:
        def q(t):
            tf = t.to(F32)
            s = torch.amax(tf.abs(), dim=-1, keepdim=True) / 127.0
            s = torch.clamp(s, min=1e-8)
            return torch.round(tf / s).to(torch.int8), s[..., 0].half()

        (kq, ks), (vq, vs) = q(k), q(v)
        cache["k"][:, pos:pos + L] = kq
        cache["v"][:, pos:pos + L] = vq
        cache["k_scale"][:, pos:pos + L] = ks
        cache["v_scale"][:, pos:pos + L] = vs
    else:
        cache["k"][:, pos:pos + L] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + L] = v.to(cache["v"].dtype)
    return cache


def _kv_read(cache, dtype):
    if cache["k"].dtype == torch.int8:
        k = cache["k"].to(F32) * cache["k_scale"].to(F32)[..., None]
        v = cache["v"].to(F32) * cache["v_scale"].to(F32)[..., None]
        return k.to(dtype), v.to(dtype)
    return cache["k"].to(dtype), cache["v"].to(dtype)


def attention(p, x, *, mc=None, table=None, ctx=None):
    """Self-attention.  table: n_heads, n_kv, head_dim, rope_theta, causal.
    ctx: positions (B, L); mode 'full' | 'decode'; cache {k, v} (B, S, K,
    hd); cache_len; use_flash (prefill through K4)."""
    table = table or {}
    ctx = ctx if ctx is not None else {}
    q, k, v = _proj_qkv(p, x, table)
    positions = ctx.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    if table.get("rope", True):
        theta = table.get("rope_theta", 10000.0)
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    q, k, v = q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)

    if ctx.get("mode", "full") == "decode":
        pos = ctx["cache_len"]
        ctx["cache"] = _kv_write(ctx["cache"], k, v, pos)
        kc, vc = _kv_read(ctx["cache"], q.dtype)
        o = decode_attention(q.transpose(1, 2), kc.transpose(1, 2),
                             vc.transpose(1, 2), pos + 1).transpose(1, 2)
    else:
        if "cache" in ctx:
            # prefill: the full-sequence K/V go into the cache for decode
            ctx["cache"] = _kv_write(ctx["cache"], k, v,
                                     ctx.get("cache_len", 0))
        causal = table.get("causal", True)
        if ctx.get("use_flash"):
            o = flash_attention(q.transpose(1, 2).contiguous(),
                                k.transpose(1, 2).contiguous(),
                                v.transpose(1, 2).contiguous(),
                                causal=causal).transpose(1, 2)
        else:
            o = _sdpa_full(q, k, v, causal=causal, shard=ctx.get("shard"))
    h, hd, m = p["wo"].shape
    out = matmul_f32(o.to(x.dtype).reshape(*o.shape[:2], h * hd),
                     p["wo"].reshape(h * hd, m)).to(x.dtype)
    if ctx.get("shard") is not None:
        out = ctx["shard"](out, "bld")
    return out


def cross_attention(p, x, *, mc=None, table=None, ctx=None):
    """Attention of x (B, L, D) over ``ctx['memory']`` (B, S, D): no RoPE,
    not causal, K and V projected from the memory at every call (decode
    included), as in the reference."""
    mem = ctx["memory"].to(x.dtype)
    q = _proj(x, p["wq"].to(x.dtype)).to(x.dtype)
    k = _proj(mem, p["wk"].to(x.dtype)).to(x.dtype)
    v = _proj(mem, p["wv"].to(x.dtype)).to(x.dtype)
    o = _sdpa_full(q, k, v, causal=False)
    h, hd, m = p["wo"].shape
    return matmul_f32(o.to(x.dtype).reshape(*o.shape[:2], h * hd),
                      p["wo"].reshape(h * hd, m)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def glu_mlp_meta(d: int, f: int, dtype) -> Dict[str, ParamMeta]:
    return {
        "wg": ParamMeta((d, f), dtype, init="scaled",
                        prefs=((1, "model"), (0, "data"))),
        "wu": ParamMeta((d, f), dtype, init="scaled",
                        prefs=((1, "model"), (0, "data"))),
        "wd": ParamMeta((f, d), dtype, init="scaled",
                        prefs=((0, "model"), (1, "data"))),
    }


def glu_mlp(p, x, *, mc=None, table=None, ctx=None):
    g = dot(x, p["wg"], table)
    u = dot(x, p["wu"], table)
    h = (F.silu(g) * u).to(x.dtype)
    return dot(h, p["wd"], table).to(x.dtype)


def mlp_meta(d: int, f: int, dtype) -> Dict[str, ParamMeta]:
    return {
        "w1": ParamMeta((d, f), dtype, init="scaled",
                        prefs=((1, "model"), (0, "data"))),
        "b1": ParamMeta((f,), dtype, init="zeros"),
        "w2": ParamMeta((f, d), dtype, init="scaled",
                        prefs=((0, "model"), (1, "data"))),
        "b2": ParamMeta((d,), dtype, init="zeros"),
    }


def mlp(p, x, *, mc=None, table=None, ctx=None):
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(dot(x, p["w1"], table) + p["b1"].to(F32), approximate="tanh")
    return (dot(h.to(x.dtype), p["w2"], table)
            + p["b2"].to(F32)).to(x.dtype)


# ---------------------------------------------------------------------------
# registry: the interpreter's dispatch table
# ---------------------------------------------------------------------------

def registry() -> Dict[ExtOp, Any]:
    from . import moe as moe_mod
    from . import ssm as ssm_mod

    return {
        ExtOp.RMSNORM: rmsnorm,
        ExtOp.LAYERNORM: layernorm,
        ExtOp.ATTN: attention,
        ExtOp.CROSS_ATTN: cross_attention,
        ExtOp.GLU_MLP: glu_mlp,
        ExtOp.MLP: mlp,
        ExtOp.MOE: moe_mod.moe,
        ExtOp.SSD: ssm_mod.mamba2_block,
        ExtOp.EMBED: embed,
        ExtOp.LM_HEAD: lm_head,
    }
