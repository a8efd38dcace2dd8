"""Zamba2's forward pass (Zamba2-7B-Instruct's architecture), plain PyTorch
in f32 with TF32 off, one layer's weights widened at a time.

It is written from the equations of the published model
(``transformers``' ``models/zamba2/modeling_zamba2.py``), not from the
program.  With e the token embeddings and h_0 = e, layer i is

    t = W_lin[s] . Shared_{s mod num_mem_blocks}(h_i, e)  at site s,
        0 elsewhere (``hybrid_layer_ids``)
    h_{i+1} = h_i + Mamba2_i(RMSNorm_i(h_i + t))

The shared block has no residual inside: u = RMSNorm([h; e]); causal
attention with RoPE on q and k, scale (head_dim / 2) ** -0.5, output
projected to the hidden width; RMSNorm; then down(GELU_erf(g) * up) with
[g; up] = v W_gu + (v A_s) B_s, the low-rank term the site's own.
Mamba2: in_proj to [z | x | B | C | dt], a depthwise causal conv with
bias and SiLU over [x | B | C], dt = softplus(dt + dt_bias), A =
-exp(A_log), the SSD scan (chunked, at the configuration's chunk), the D
skip, y * SiLU(z) normalised per group of d_inner / ngroups, out_proj.
The logits are the final RMSNorm's output against the embedding (tied).

Departures from ``modeling_zamba2.py``, none of which changes the function
at the weights used here:

* dt is not clamped from below: the torch path there clamps it at
  ``time_step_min`` (0.001), its CUDA path (``time_step_limit`` (0, inf))
  does not; softplus of the weights drawn here stays far above 0.001;
* the weights are the program's, by binding name (:func:`param_shapes`),
  in its layouts: gate and up as two matrices, q, k, v per head, the
  adapter's second factor (rank, 2 d_ff) with the gate's half first;
* everything is f32 from weights that are bf16 values; the published
  code runs in the model's type; no attention mask (a batch holds prompts
  of one length) and no cache: every call is the whole sequence;
* the head is computed at the positions asked for only.

``bits`` (the control): every matmul operand and every stored activation
rounded to that many mantissa bits (nearest, ties to even) before use.

:func:`make_params` draws the weights that the program and the reference
are both given; :func:`dims` gives the widths the benchmark counts work
from, and :func:`program_fields` the program's configuration of the same
keys.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

F32 = torch.float32
Params = Dict[str, torch.Tensor]


def dims(cfg) -> Dict[str, int]:
    """Widths of the configuration (the catalog's keys)."""
    d = int(cfg["hidden_size"])
    d_inner = int(cfg["mamba_expand"]) * d
    heads = int(cfg["n_mamba_heads"])
    if d_inner % heads or d_inner // heads != int(cfg["mamba_headdim"]):
        raise ValueError("n_mamba_heads x mamba_headdim != d_inner")
    g, n = int(cfg["mamba_ngroups"]), int(cfg["mamba_d_state"])
    return dict(
        d=d, d_attn=int(cfg["attention_hidden_size"]),
        heads=int(cfg["num_attention_heads"]),
        kv_heads=int(cfg["num_key_value_heads"]),
        hd=int(cfg["attention_head_dim"]), f=int(cfg["intermediate_size"]),
        vocab=int(cfg["vocab_size"]), layers=int(cfg["num_hidden_layers"]),
        sites=len(cfg["hybrid_layer_ids"]), blocks=int(cfg["num_mem_blocks"]),
        rank=int(cfg["adapter_rank"]), d_inner=d_inner, ssm_heads=heads,
        p=int(cfg["mamba_headdim"]), g=g, n=n, w=int(cfg["mamba_d_conv"]),
        d_conv=d_inner + 2 * g * n, d_proj=2 * d_inner + 2 * g * n + heads,
        chunk=int(cfg["chunk_size"]))


def program_fields(cfg) -> Dict[str, object]:
    """The program's configuration of the file's published keys: the
    keywords of ``repro_torch.configs.base.ArchConfig`` (by name; nothing
    of the program is imported here).  Raises on a Zamba2 option the
    program does not take."""
    hd = int(cfg["attention_head_dim"])
    if int(cfg["attention_hidden_size"]) != 2 * int(cfg["hidden_size"]) or \
            hd * int(cfg["num_attention_heads"]) != int(
                cfg["attention_hidden_size"]):
        raise ValueError("attention over concat(hidden, embeddings) is "
                         "2 x hidden_size = heads x head_dim wide")
    if cfg["hidden_act"] != "gelu" or not cfg["use_mem_rope"] \
            or cfg["use_shared_attention_adapter"] \
            or not cfg["use_shared_mlp_adapter"] or cfg["add_bias_linear"] \
            or not cfg["use_conv_bias"] or cfg["use_long_context"]:
        raise ValueError("a Zamba2 option the program does not take")
    if cfg["layers_block_type"] != [
            "hybrid" if i in cfg["hybrid_layer_ids"] else "mamba"
            for i in range(int(cfg["num_hidden_layers"]))]:
        raise ValueError("layers_block_type disagrees with hybrid_layer_ids")
    return dict(
        name=cfg["name"], family="hybrid",
        n_layers=int(cfg["num_hidden_layers"]),
        d_model=int(cfg["hidden_size"]),
        n_heads=int(cfg["num_attention_heads"]),
        n_kv_heads=int(cfg["num_key_value_heads"]), head_dim=hd,
        d_ff=int(cfg["intermediate_size"]), vocab=int(cfg["vocab_size"]),
        act="geglu", rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        ssm_state=int(cfg["mamba_d_state"]),
        ssm_headdim=int(cfg["mamba_headdim"]),
        ssm_expand=int(cfg["mamba_expand"]),
        ssm_groups=int(cfg["mamba_ngroups"]),
        conv_width=int(cfg["mamba_d_conv"]),
        ssm_chunk=int(cfg["chunk_size"]),
        hybrid_layer_ids=tuple(int(i) for i in cfg["hybrid_layer_ids"]),
        num_mem_blocks=int(cfg["num_mem_blocks"]),
        attn_scale=(hd / 2) ** -0.5, adapter_rank=int(cfg["adapter_rank"]),
        norm_eps=float(cfg["rms_norm_eps"]), param_dtype=cfg["dtype"],
        compute_dtype=cfg["dtype"], remat=False)


def param_shapes(cfg) -> Dict[str, tuple]:
    """Binding name -> shape, stacked over layers, blocks and sites as
    the program holds them."""
    m = dims(cfg)
    d, nl, nb, ns = m["d"], m["layers"], m["blocks"], m["sites"]
    return {
        "embed/table": (m["vocab"], d),
        "final_norm/scale": (d,),
        "layers/ssm_norm/scale": (nl, d),
        "layers/ssm/in_proj": (nl, d, m["d_proj"]),
        "layers/ssm/conv_w": (nl, m["w"], m["d_conv"]),
        "layers/ssm/conv_b": (nl, m["d_conv"]),
        "layers/ssm/dt_bias": (nl, m["ssm_heads"]),
        "layers/ssm/A_log": (nl, m["ssm_heads"]),
        "layers/ssm/D": (nl, m["ssm_heads"]),
        "layers/ssm/norm_scale": (nl, m["d_inner"]),
        "layers/ssm/out_proj": (nl, m["d_inner"], d),
        "mem_blocks/attn_norm/scale": (nb, m["d_attn"]),
        "mem_blocks/attn/wq": (nb, m["d_attn"], m["heads"], m["hd"]),
        "mem_blocks/attn/wk": (nb, m["d_attn"], m["kv_heads"], m["hd"]),
        "mem_blocks/attn/wv": (nb, m["d_attn"], m["kv_heads"], m["hd"]),
        "mem_blocks/attn/wo": (nb, m["heads"], m["hd"], d),
        "mem_blocks/mlp_norm/scale": (nb, d),
        "mem_blocks/mlp/wg": (nb, d, m["f"]),
        "mem_blocks/mlp/wu": (nb, d, m["f"]),
        "mem_blocks/mlp/wd": (nb, m["f"], d),
        "sites/linear/w": (ns, d, d),
        "sites/adapter/a": (ns, d, m["rank"]),
        "sites/adapter/b": (ns, m["rank"], 2 * m["f"]),
    }


F32_LEAVES = ("layers/ssm/dt_bias", "layers/ssm/A_log", "layers/ssm/D")


def make_params(cfg, seed: int, device) -> Params:
    """The weights, drawn on ``device`` from ``seed`` in the stated type
    (f32 for dt_bias, A_log and D, as the program stores them), one
    slice of a stacked leaf at a time, so that no f32 temporary holds a
    whole stack: matrices normal over the square root of their fan-in
    (the contracted axes); the embedding normal at 0.02 (the published
    init's std); norms 1 + 0.1 n; conv taps normal over sqrt(width), its
    bias 0.1 n; A_log = log of U(1, 16), dt_bias the inverse softplus of
    a dt log-uniform in [0.001, 0.1] (Mamba2's init); D = 1 + 0.1 n."""
    dtype = getattr(torch, cfg["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    out: Params = {}

    def randn(shape):
        return torch.randn(shape, generator=g, device=device, dtype=F32)

    def rand(shape):
        return torch.rand(shape, generator=g, device=device, dtype=F32)

    def draw(name, shp):
        leaf = name.rsplit("/", 1)[1]
        if name == "embed/table":
            return randn(shp) * 0.02
        if leaf in ("scale", "norm_scale", "D"):
            return 1.0 + 0.1 * randn(shp)
        if leaf == "conv_w":
            return randn(shp) / math.sqrt(shp[0])
        if leaf == "conv_b":
            return 0.1 * randn(shp)
        if leaf == "A_log":
            return torch.log(1.0 + 15.0 * rand(shp))
        if leaf == "dt_bias":
            dt = torch.exp(math.log(1e-3) + rand(shp) * math.log(100.0))
            return dt + torch.log(-torch.expm1(-dt))
        if leaf == "wo":                       # (heads, hd, d)
            return randn(shp) / math.sqrt(shp[0] * shp[1])
        return randn(shp) / math.sqrt(shp[0])  # (fan_in, ...)

    for name, shp in param_shapes(cfg).items():
        v = torch.empty(shp, dtype=F32 if name in F32_LEAVES else dtype,
                        device=device)
        if name.split("/")[0] in ("layers", "mem_blocks", "sites"):
            for i in range(shp[0]):
                v[i] = draw(name, shp[1:])
        else:
            v.copy_(draw(name, shp))
        out[name] = v
    return out


class _Rounder:
    """Rounds to ``bits`` mantissa bits, or passes through."""

    def __init__(self, bits: Optional[int]):
        self.bits = bits

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.bits is None:
            return x
        m, e = torch.frexp(x)
        s = float(2 ** (self.bits + 1))
        return torch.ldexp(torch.round(m * s) / s, e)


def _w(params: Params, name: str, i: Optional[int] = None) -> torch.Tensor:
    v = params[name] if i is None else params[name][i]
    return v.to(F32)


def forward(cfg, params: Params, tokens: torch.Tensor, *,
            positions: Optional[Sequence[int]] = None,
            bits: Optional[int] = None) -> torch.Tensor:
    """tokens (B, L) int -> f32 logits (B, len(positions), V) at
    ``positions`` (every position if None)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _forward(cfg, params, tokens, positions, _Rounder(bits))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _forward(cfg, params, tokens, positions, q):
    m = dims(cfg)
    eps = float(cfg["rms_norm_eps"])
    sites = {int(i): s for s, i in enumerate(cfg["hybrid_layer_ids"])}

    def mm(a, w):
        return q(a) @ q(w)

    e = q(params["embed/table"][tokens.long()].to(F32))
    h = e
    for i in range(m["layers"]):
        x = h
        if i in sites:
            s = sites[i]
            t = _shared(cfg, m, params, s, h, e, mm, q, eps)
            x = q(h + mm(t, _w(params, "sites/linear/w", s)))
        xn = q(_rms(x, _w(params, "layers/ssm_norm/scale", i), eps))
        h = q(h + _mamba(cfg, m, params, i, xn, mm, q))
    hn = q(_rms(h, _w(params, "final_norm/scale"), eps))
    if positions is not None:
        hn = hn[:, list(positions)]
    return mm(hn, _w(params, "embed/table").t())


def _rope(x, theta: float):
    """x (B, H, L, hd): rotate halves, frequencies theta^(-2j/hd)."""
    hd, L = x.shape[-1], x.shape[-2]
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=F32) / hd)
    ang = torch.arange(L, device=x.device, dtype=F32)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def _shared(cfg, m, params, s, h, e, mm, q, eps):
    blk = s % m["blocks"]
    B, L, _ = h.shape
    H, K, hd = m["heads"], m["kv_heads"], m["hd"]
    u = q(_rms(torch.cat([h, e], -1),
               _w(params, "mem_blocks/attn_norm/scale", blk), eps))

    def proj(name, heads):
        w = _w(params, f"mem_blocks/attn/{name}", blk)
        return q(mm(u, w.reshape(w.shape[0], -1))).reshape(
            B, L, heads, hd).transpose(1, 2)

    theta = float(cfg["rope_theta"])
    qh = q(_rope(proj("wq", H), theta))
    kh = q(_rope(proj("wk", K), theta))
    vh = proj("wv", K)
    if H != K:
        kh = kh.repeat_interleave(H // K, dim=1)
        vh = vh.repeat_interleave(H // K, dim=1)
    scale = (hd / 2) ** -0.5
    mask = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
    o = []
    for r in range(0, L, 1024):          # query rows, a block at a time
        sc = mm(qh[:, :, r:r + 1024], kh.transpose(-1, -2)) * scale
        sc = sc.masked_fill(~mask[r:r + 1024], float("-inf"))
        o.append(q(mm(q(torch.softmax(sc, -1)), vh)))
    o = torch.cat(o, 2).transpose(1, 2).reshape(B, L, H * hd)
    wo = _w(params, "mem_blocks/attn/wo", blk)
    a = q(mm(o, wo.reshape(H * hd, -1)))
    v = q(_rms(a, _w(params, "mem_blocks/mlp_norm/scale", blk), eps))
    f = m["f"]
    gu = mm(v, torch.cat([_w(params, "mem_blocks/mlp/wg", blk),
                          _w(params, "mem_blocks/mlp/wu", blk)], 1))
    gu = q(gu + mm(q(mm(v, _w(params, "sites/adapter/a", s))),
                   _w(params, "sites/adapter/b", s)))
    act = q(F.gelu(gu[..., :f], approximate="none") * gu[..., f:])
    return q(mm(act, _w(params, "mem_blocks/mlp/wd", blk)))


def _mamba(cfg, m, params, i, xn, mm, q):
    B, L, _ = xn.shape
    di, g, n, H, P = m["d_inner"], m["g"], m["n"], m["ssm_heads"], m["p"]

    def w(name):
        return _w(params, f"layers/ssm/{name}", i)

    zxbcdt = q(mm(xn, w("in_proj")))
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + m["d_conv"]]
    dt = zxbcdt[..., di + m["d_conv"]:]
    taps = w("conv_w")                                  # (W, C)
    conv = F.conv1d(xbc.transpose(1, 2), taps.t()[:, None, :],
                    bias=w("conv_b"), padding=m["w"] - 1,
                    groups=m["d_conv"])[..., :L]
    xbc = q(F.silu(conv).transpose(1, 2))
    x = xbc[..., :di].reshape(B, L, H, P)
    Bm = xbc[..., di:di + g * n].reshape(B, L, g, n)
    Cm = xbc[..., di + g * n:].reshape(B, L, g, n)
    dt = F.softplus(dt + w("dt_bias"))
    A = -torch.exp(w("A_log"))
    y = _ssd(x, dt, A, Bm, Cm, int(cfg["chunk_size"]), q)
    y = q(y + x * w("D")[:, None])
    y = q(y.reshape(B, L, di) * F.silu(z))
    yg = y.reshape(B, L, g, di // g)
    yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True) + 1e-5)
    y = q(yg.reshape(B, L, di) * w("norm_scale"))
    return mm(y, w("out_proj"))


def _segsum(a):
    """a (..., T) -> (..., T, T): sum of a[s+1..t] for s <= t, -inf
    above the diagonal."""
    T = a.shape[-1]
    c = torch.cumsum(a, -1)
    out = c[..., :, None] - c[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def _ssd(x, dt, A, Bm, Cm, chunk: int, q):
    """The SSD scan h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, y_t = h_t
    C_t, by chunks of ``chunk`` (the last may be shorter): within a chunk
    the quadratic form, across chunks the carried state.  x (B, L, H, P),
    dt (B, L, H), Bm/Cm (B, L, G, N) with head h on group h // (H/G)."""
    Bsz, L, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, 2)
    Ch = Cm.repeat_interleave(rep, 2)
    N = Bh.shape[-1]
    state = torch.zeros(Bsz, H, P, N, dtype=F32, device=x.device)
    ys = []
    for c0 in range(0, L, chunk):
        sl = slice(c0, min(c0 + chunk, L))
        a = (dt[:, sl] * A).transpose(1, 2)             # (B, H, T)
        xdt = x[:, sl] * dt[:, sl, :, None]             # (B, T, H, P)
        Bc, Cc = Bh[:, sl], Ch[:, sl]                   # (B, T, H, N)
        decay = torch.exp(_segsum(a))                   # (B, H, T, T)
        scores = torch.einsum("bthn,bshn->bhts", q(Cc), q(Bc)) * decay
        y = torch.einsum("bhts,bshp->bthp", q(scores), q(xdt))
        cum = torch.cumsum(a, -1)                       # (B, H, T)
        y = y + torch.einsum("bthn,bhpn->bthp",
                             q(Cc * torch.exp(cum).transpose(1, 2)[..., None]),
                             q(state))
        w_end = torch.exp(cum[..., -1:] - cum).transpose(1, 2)  # (B, T, H)
        state = q(state * torch.exp(cum[..., -1])[..., None, None]
                  + torch.einsum("bthp,bthn->bhpn", q(xdt),
                                 q(Bc * w_end[..., None])))
        ys.append(y)
    return torch.cat(ys, 1)
