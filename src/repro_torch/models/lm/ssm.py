"""Mamba2 (SSD) datapath module: zamba2-2.7b, zamba2-7b and mamba2-370m.

Block layout (arXiv:2405.21060):
    in_proj -> [z | x | B | C | dt]
    causal conv1d (width 4) over [x | B | C], silu
    dt = softplus(dt + dt_bias);  A = -exp(A_log)
    y  = SSD(x, dt, A, B, C, D)          (kernels/ssd_scan)
    y  = RMSNorm(y * silu(z)) -> out_proj   (per group of d_inner / G
                                           where the config says so)

Decode carries (conv_state, ssm_state) in the cache, O(1) per token.
With ``ctx['use_kernel']`` the full-sequence scan runs through K5
(``ssd_scan``), and a prefill that wants a cache takes the final state
from the same call; without it the scan is :func:`_ssd_xla`, the
reference's plain chunked form.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ops import (chunk_carry, chunk_operands,
                                              ssd_decode_step, ssd_scan)

from .layers import _maybe_bfp, matmul_f32, rmsnorm
from .params import ParamMeta

F32 = torch.float32


def mamba2_meta(d_model: int, d_inner: int, n_heads: int, n_groups: int,
                d_state: int, conv_width: int, dtype
                ) -> Dict[str, ParamMeta]:
    d_proj = 2 * d_inner + 2 * n_groups * d_state + n_heads
    d_conv = d_inner + 2 * n_groups * d_state
    return {
        "in_proj": ParamMeta((d_model, d_proj), dtype, init="scaled",
                             prefs=((1, "model"), (0, "data"))),
        "conv_w": ParamMeta((conv_width, d_conv), dtype, init="scaled"),
        "conv_b": ParamMeta((d_conv,), dtype, init="zeros"),
        "dt_bias": ParamMeta((n_heads,), F32, init="zeros"),
        "A_log": ParamMeta((n_heads,), F32, init="zeros"),
        "D": ParamMeta((n_heads,), F32, init="ones"),
        "norm_scale": ParamMeta((d_inner,), dtype, init="ones"),
        "out_proj": ParamMeta((d_inner, d_model), dtype, init="scaled",
                              prefs=((0, "model"), (1, "data"))),
    }


def _split_proj(zxbcdt, d_inner, n_groups, d_state):
    gs = n_groups * d_state
    z = zxbcdt[..., :d_inner]
    xc = zxbcdt[..., d_inner: 2 * d_inner + 2 * gs]   # conv'd part [x|B|C]
    dt = zxbcdt[..., 2 * d_inner + 2 * gs:]
    return z, xc, dt


def _causal_conv(xc, w, b):
    """Depthwise causal conv1d; xc: (B, L, C), w: (W, C)."""
    W = w.shape[0]
    pad = F.pad(xc, (0, 0, W - 1, 0))
    out = torch.zeros(xc.shape, dtype=F32, device=xc.device)
    for i in range(W):
        out = out + pad[:, i: i + xc.shape[1], :].to(F32) * w[i].to(F32)
    return F.silu(out + b.to(F32)).to(xc.dtype)


def mamba2_block(p, x, *, mc=None, table=None, ctx=None):
    """x: (B, L, D).  table: d_inner, n_heads, n_groups, d_state, headdim,
    conv_width, chunk; norm_groups (1 unless given) and eps of the gated
    norm.  ctx mode 'full' | 'decode' (cache: conv (B, W-1,
    d_conv), ssm (B, H, P, N))."""
    table = table or {}
    ctx = ctx if ctx is not None else {}
    d_inner = int(table["d_inner"])
    H = int(table["n_heads"])
    G = int(table["n_groups"])
    N = int(table["d_state"])
    P = int(table["headdim"])
    Wd = int(table.get("conv_width", 4))
    chunk = int(table.get("chunk", 128))
    Bsz, L, _ = x.shape
    gs = G * N

    zxbcdt = matmul_f32(_maybe_bfp(x, table),
                        p["in_proj"].to(x.dtype)).to(x.dtype)
    z, xc, dt_raw = _split_proj(zxbcdt, d_inner, G, N)

    decode = ctx.get("mode", "full") == "decode"
    if decode:
        # conv state: the previous W-1 raw [x|B|C] inputs
        hist = torch.cat([ctx["cache"]["conv"], xc], dim=1)   # (B, W, C)
        new_conv = hist[:, 1:, :]
        acc = torch.zeros(xc.shape, dtype=F32, device=x.device)
        for i in range(Wd):
            acc = acc + hist[:, i: i + 1, :].to(F32) * p["conv_w"][i].to(F32)
        xc = F.silu(acc + p["conv_b"].to(F32)).to(x.dtype)
    else:
        xc = _causal_conv(xc, p["conv_w"], p["conv_b"])

    xs = xc[..., :d_inner]
    Bm = xc[..., d_inner: d_inner + gs].reshape(Bsz, L, G, N)
    Cm = xc[..., d_inner + gs:].reshape(Bsz, L, G, N)
    # jax.nn.softplus has no threshold; torch's default threshold of 20
    # returns x itself above it, which differs by under 1e-8
    dt = F.softplus(dt_raw.to(F32) + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].to(F32))
    xh = xs.reshape(Bsz, L, H, P)

    if decode:
        h_new, y = ssd_decode_step(
            ctx["cache"]["ssm"], xh[:, 0].to(F32), dt[:, 0], A,
            Bm[:, 0].to(F32), Cm[:, 0].to(F32), p["D"])
        ctx["cache"] = {"conv": new_conv, "ssm": h_new}
        y = y[:, None, :, :]                           # (B, 1, H, P)
    else:
        want_state = "cache" in ctx
        Lc = min(chunk, L)
        if ctx.get("use_kernel"):
            out = ssd_scan(xh, dt, A, Bm, Cm, p["D"], chunk=Lc,
                           return_state=want_state)
        else:
            out = _ssd_xla(xh, dt, A, Bm, Cm, p["D"], chunk=Lc,
                           return_state=True)
        y, h_last = out if isinstance(out, tuple) else (out, None)
        if want_state:
            # prefill: keep the conv tail (pre-activation inputs) and the
            # final SSM state so decode can continue
            tail = zxbcdt[..., d_inner: 2 * d_inner + 2 * gs][:, L - (Wd - 1):]
            ctx["cache"] = {"conv": tail.to(ctx["cache"]["conv"].dtype),
                            "ssm": h_last}

    y = y.reshape(Bsz, L, d_inner).to(x.dtype)
    y = y * F.silu(z.to(F32)).to(x.dtype)
    # the gated norm, over each of ``norm_groups`` equal slices of d_inner
    ng = int(table.get("norm_groups", 1))
    y = rmsnorm({"scale": p["norm_scale"].reshape(ng, d_inner // ng)},
                y.reshape(Bsz, L, ng, d_inner // ng),
                table={"eps": table.get("eps", 1e-6)}).reshape(Bsz, L,
                                                              d_inner)
    return matmul_f32(_maybe_bfp(y, table),
                      p["out_proj"].to(x.dtype)).to(x.dtype)


def _ssd_xla(x, dt, A, Bm, Cm, D, *, chunk: int, return_state: bool = False):
    """The reference's plain chunked SSD: the kernel path's operands and
    inter-chunk carry, with the intra-chunk block in torch ops on
    per-head copies of B and C (the reference's rounding)."""
    xf, scum, xdt, Bc, Cc = chunk_operands(x, dt, A, Bm, Cm, chunk)
    Lc = xdt.shape[2]
    hpg = x.shape[2] // Bm.shape[2]
    Bh = Bc.repeat_interleave(hpg, 3)                  # (B, nc, Lc, H, N)
    Ch = Cc.repeat_interleave(hpg, 3)
    cb = torch.einsum("bcthn,bcshn->bchts", Ch, Bh)
    sc_h = scum.permute(0, 1, 3, 2)                    # (B, nc, H, T)
    arg = sc_h[..., :, None] - sc_h[..., None, :]
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=x.device))
    # mask the exponent (not the product): t < s entries are exp(+large)
    dec = torch.exp(torch.where(tri, arg, torch.full_like(arg, -torch.inf)))
    y_intra = torch.einsum("bchts,bcshp->bcthp", cb * dec, xdt)

    s_last = scum[:, :, -1, :]                         # (B, nc, H)
    bw = Bh * torch.exp(s_last[:, :, None, :] - scum)[..., None]
    st = torch.einsum("bcthp,bcthn->bchpn", xdt, bw)
    return chunk_carry(y_intra, st, scum, Cc, xf, D, return_state)
