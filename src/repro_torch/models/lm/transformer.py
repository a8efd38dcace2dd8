"""LM model assembly: configs compile to microcode streams (paper C1),
executed by ``core.interpreter.build_stream_fn`` over the datapath
module registry, one layer at a time.

  dense   : [id.cache, norm, attn.add, id.cache, norm, glu_mlp.add] x L
  moe     : the same with MOE in the MLP slot                (grok, kimi)
  ssm     : [id.cache, norm, ssd.add] x L                  (mamba2)
  hybrid  : ssm blocks + a SHARED attention block every k layers; the
            shared block's words carry the same binding name at every
            call site, so one weight copy serves them all (zamba2)
  audio   : a non-causal encoder over the frontend stub's frames, and a
            decoder with cross-attention to its output     (whisper)
  vlm     : the frontend stub's patch embeddings before the token
            embeddings of a dense decoder                   (internvl)

Parameters stay stacked ``(n_layers, ...)`` as in the reference, so the
trees match leaf for leaf; the layer loop slices them.  ``forward`` in
``mode="train"`` (the default, as in the reference) builds autograd's
graph, and with ``cfg.remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of each
scan body).  The serving paths keep no graph: caches are preallocated and
written in place, ``forward(cache_out=True)`` and ``decode_step`` run
under ``torch.no_grad``, and ``decode_step`` returns the same cache it
was given.  The encoder's self-attention runs dense (``_sdpa_full``)
even under ``use_flash``, as the reference's encoder context carries no
flag.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import bfp as bfp_lib
from repro_torch.core.device import resolve_device
from repro_torch.core.interpreter import build_stream_fn
from repro_torch.core.microcode import ExtOp, Microcode, ResOp

from . import layers as L
from . import moe as moe_mod
from . import ssm as ssm_mod
from .params import (ParamMeta, as_dtype, leaves_with_path, materialize,
                     scale_attention_to_fan_in, tree_map_meta)

F32 = torch.float32


# ---------------------------------------------------------------------------
# microcode emission helpers
# ---------------------------------------------------------------------------

def _word(op: ExtOp, *, res: ResOp = ResOp.NONE, tbl: int = 0,
          d_in: int = 0, d_out: int = 0, seq: int = 0) -> Microcode:
    return Microcode(
        layer_type=3,
        in_ch=min(d_in, (1 << 16) - 1),
        out_ch=min(d_out, (1 << 16) - 1),
        height=min(seq, (1 << 20) - 1),
        res_op=int(res),
        ext_opcode=int(op),
        ext_table_idx=tbl,
    )


@dataclasses.dataclass
class Stream:
    """A microcode segment + its tables and parameter bindings."""

    words: List[Microcode]
    tables: List[Dict[str, Any]]
    bindings: Dict[int, str]
    metas: Dict[str, Any]            # binding name -> ParamMeta tree

    def fn(self):
        return build_stream_fn(self.words, self.tables, L.registry(),
                               self.bindings)


class StreamBuilder:
    def __init__(self, cfg: ArchConfig):
        self.cfg = cfg
        self.words: List[Microcode] = []
        self.tables: List[Dict[str, Any]] = []
        self.bindings: Dict[int, str] = {}
        self.metas: Dict[str, Any] = {}

    def table(self, **kw) -> int:
        self.tables.append(kw)
        return len(self.tables)

    def emit(self, op: ExtOp, name: Optional[str] = None,
             meta: Optional[Any] = None, *, res: ResOp = ResOp.NONE,
             tbl: int = 0):
        idx = len(self.words)
        self.words.append(_word(op, res=res, tbl=tbl, d_in=self.cfg.d_model,
                                d_out=self.cfg.d_model))
        if name is not None:
            self.bindings[idx] = name
            if meta is not None and name not in self.metas:
                self.metas[name] = meta

    def build(self) -> Stream:
        return Stream(self.words, self.tables, self.bindings, self.metas)


def _norm_parts(cfg: ArchConfig):
    if cfg.norm == "rmsnorm":
        return ExtOp.RMSNORM, L.rmsnorm_meta(cfg.d_model, cfg.param_dtype)
    return ExtOp.LAYERNORM, L.layernorm_meta(cfg.d_model, cfg.param_dtype)


def _common_tables(cfg: ArchConfig) -> Dict[str, Any]:
    t: Dict[str, Any] = {"compute_dtype": cfg.compute_dtype}
    if cfg.bfp_forward:
        t.update(bfp=True, bfp_block=cfg.bfp_block,
                 bfp_mantissa=cfg.bfp_mantissa)
    return t


def attn_block_stream(cfg: ArchConfig, *, causal=True, cross=False,
                      prefix="") -> Stream:
    """[id.cache, norm, attn.add] (+ optional cross-attn) + mlp sub-block."""
    b = StreamBuilder(cfg)
    nop, nmeta = _norm_parts(cfg)
    attn_tbl = b.table(
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, causal=causal, rope=True,
        **_common_tables(cfg))
    mlp_tbl = b.table(**_common_tables(cfg))
    amet = L.attention_meta(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.hd, cfg.param_dtype, qkv_bias=cfg.qkv_bias)
    b.emit(ExtOp.IDENTITY, res=ResOp.CACHE)
    b.emit(nop, f"{prefix}attn_norm", nmeta)
    b.emit(ExtOp.ATTN, f"{prefix}attn", amet, res=ResOp.ADD, tbl=attn_tbl)
    if cross:
        xmet = L.attention_meta(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.hd, cfg.param_dtype)
        b.emit(ExtOp.IDENTITY, res=ResOp.CACHE)
        b.emit(nop, f"{prefix}xattn_norm", nmeta)
        b.emit(ExtOp.CROSS_ATTN, f"{prefix}xattn", xmet, res=ResOp.ADD,
               tbl=attn_tbl)
    b.emit(ExtOp.IDENTITY, res=ResOp.CACHE)
    b.emit(nop, f"{prefix}mlp_norm", nmeta)
    if cfg.family == "moe" and not cross and not prefix:
        moe_tbl = b.table(
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, fission=cfg.moe_fission,
            **_common_tables(cfg))
        b.emit(ExtOp.MOE, "moe",
               moe_mod.moe_meta(cfg.d_model, cfg.d_ff, cfg.n_experts,
                                cfg.param_dtype, fission=cfg.moe_fission),
               res=ResOp.ADD, tbl=moe_tbl)
    elif cfg.act == "swiglu":
        b.emit(ExtOp.GLU_MLP, f"{prefix}mlp",
               L.glu_mlp_meta(cfg.d_model, cfg.d_ff, cfg.param_dtype),
               res=ResOp.ADD, tbl=mlp_tbl)
    else:
        b.emit(ExtOp.MLP, f"{prefix}mlp",
               L.mlp_meta(cfg.d_model, cfg.d_ff, cfg.param_dtype),
               res=ResOp.ADD, tbl=mlp_tbl)
    return b.build()


def ssm_block_stream(cfg: ArchConfig, prefix="") -> Stream:
    b = StreamBuilder(cfg)
    nop, nmeta = _norm_parts(cfg)
    tbl = b.table(
        d_inner=cfg.d_inner, n_heads=cfg.ssm_heads, n_groups=cfg.ssm_groups,
        d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
        conv_width=cfg.conv_width, chunk=cfg.ssm_chunk,
        **_common_tables(cfg))
    met = ssm_mod.mamba2_meta(cfg.d_model, cfg.d_inner, cfg.ssm_heads,
                              cfg.ssm_groups, cfg.ssm_state, cfg.conv_width,
                              cfg.param_dtype)
    b.emit(ExtOp.IDENTITY, res=ResOp.CACHE)
    b.emit(nop, f"{prefix}ssm_norm", nmeta)
    b.emit(ExtOp.SSD, f"{prefix}ssm", met, res=ResOp.ADD, tbl=tbl)
    return b.build()


# ---------------------------------------------------------------------------
# stacked-tree helpers
# ---------------------------------------------------------------------------

def _stack_meta(meta_tree, n: int):
    """Prepend a stacked layer dim to every ParamMeta (its axis
    preferences move up one dim)."""
    return tree_map_meta(
        lambda m: dataclasses.replace(
            m, shape=(n,) + m.shape,
            prefs=tuple((d + 1, a) for d, a in m.prefs)), meta_tree)


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views; a BFP leaf keeps its
    negative axis, which stays valid)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, bfp_lib.BFPTensor):
        return dataclasses.replace(tree, mantissa=tree.mantissa[i],
                                   exponent=tree.exponent[i])
    return tree[i]


def _write_back(stacked, i: int, new) -> None:
    """Store a layer's updated cache into slot ``i`` of the stacked one
    (a no-op for leaves already written in place)."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_back(stacked[k], i, v)
            continue
        dst = stacked[k][i]
        if v.data_ptr() != dst.data_ptr():
            dst.copy_(v)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class LMModel:
    """Config-driven LM; all blocks execute through microcode streams."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.family in ("dense", "moe", "vlm"):
            self.block = attn_block_stream(cfg)
            self.block_kind = "attn"
        elif cfg.family == "ssm":
            self.block = ssm_block_stream(cfg)
            self.block_kind = "ssm"
        elif cfg.family == "hybrid":
            self.block = ssm_block_stream(cfg)
            self.shared = attn_block_stream(cfg, prefix="shared_")
            self.block_kind = "hybrid"
        elif cfg.family == "audio":
            self.block = attn_block_stream(cfg, cross=True)
            self.enc_block = attn_block_stream(cfg, causal=False,
                                               prefix="enc_")
            self.block_kind = "encdec"
        else:
            raise ValueError(cfg.family)
        self._final_norm_meta = _norm_parts(cfg)[1]
        self._head_tbl = _common_tables(cfg)

    # -- parameter metadata -------------------------------------------------
    def param_meta(self) -> Dict[str, Any]:
        cfg = self.cfg
        p: Dict[str, Any] = {
            "embed": L.embed_meta(cfg.vocab, cfg.d_model, cfg.param_dtype),
            "final_norm": self._final_norm_meta,
        }
        if not cfg.tie_embeddings:
            p["head"] = L.lm_head_meta(cfg.d_model, cfg.vocab,
                                       cfg.param_dtype)
        p["layers"] = _stack_meta(self.block.metas, cfg.n_layers)
        if self.block_kind == "hybrid":
            p["shared_attn"] = self.shared.metas          # ONE copy, reused
        elif self.block_kind == "encdec":
            p["enc_layers"] = _stack_meta(self.enc_block.metas,
                                          cfg.encoder_layers)
        return p

    def init_params(self, generator: torch.Generator):
        """Seeded random weights, drawn on the generator's device, the
        attention projections at the fan-in of the axes they contract
        (:func:`params.scale_attention_to_fan_in`; ``materialize`` of
        :meth:`param_meta` is the reference's init as drawn)."""
        return scale_attention_to_fan_in(
            materialize(self.param_meta(), generator, self.device))

    # -- caches --------------------------------------------------------------
    def cache_meta(self, batch: int, max_len: int) -> Dict[str, Any]:
        cfg = self.cfg
        dt = as_dtype(cfg.compute_dtype)
        quant = cfg.kv_cache_dtype == "int8"
        kvdt = torch.int8 if quant else dt
        shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        by_batch = ((0, ("pod", "data")),)
        by_batch_model = ((0, ("pod", "data")), (1, "model"))

        def kv():
            m = {"k": ParamMeta(shape, kvdt, init="zeros",
                                prefs=by_batch_model),
                 "v": ParamMeta(shape, kvdt, init="zeros",
                                prefs=by_batch_model)}
            if quant:   # per-vector scales (paper C2 on the KV stream)
                for s in ("k_scale", "v_scale"):
                    m[s] = ParamMeta(shape[:3], torch.float16, init="zeros",
                                     prefs=by_batch_model)
            return m

        def ssm():
            d_conv = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            return {
                "conv": ParamMeta((batch, cfg.conv_width - 1, d_conv), dt,
                                  init="zeros", prefs=by_batch),
                "ssm": ParamMeta((batch, cfg.ssm_heads, cfg.ssm_headdim,
                                  cfg.ssm_state), F32, init="zeros",
                                 prefs=by_batch_model),
            }

        if self.block_kind == "attn":
            return {"layers": _stack_meta(kv(), cfg.n_layers)}
        if self.block_kind == "ssm":
            return {"layers": _stack_meta(ssm(), cfg.n_layers)}
        if self.block_kind == "encdec":
            return {"layers": _stack_meta(kv(), cfg.n_layers),
                    "memory": ParamMeta((batch, cfg.frontend_len,
                                         cfg.d_model), dt, init="zeros",
                                        prefs=by_batch)}
        n_sites = cfg.n_layers // cfg.attn_every
        return {"layers": _stack_meta(ssm(), cfg.n_layers),
                "shared_attn": _stack_meta(kv(), n_sites)}

    def init_cache(self, batch: int, max_len: int):
        return materialize(self.cache_meta(batch, max_len), None, self.device)

    # -- forward -------------------------------------------------------------
    def _embed(self, params, tokens):
        return L.embed(params["embed"], tokens,
                       table={"compute_dtype": self.cfg.compute_dtype})

    def _head(self, params, x):
        norm = L.rmsnorm if self.cfg.norm == "rmsnorm" else L.layernorm
        xn = norm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return xn.to(F32) @ params["embed"]["table"].to(F32).t()
        hp = params["head"]
        if isinstance(hp.get("w"), bfp_lib.BFPTensor):   # BFP storage
            hp = {"w": bfp_lib.dequantize(hp["w"]).to(x.dtype)}
        return L.lm_head(hp, xn, table=self._head_tbl)

    def _layer(self, fn, stacked_params, i, h, ctx, stacked_cache=None):
        """Run layer ``i`` of a stacked block through its stream."""
        cache = None if stacked_cache is None else _index(stacked_cache, i)
        y, cache = self._one_layer(fn, _index(stacked_params, i), h, ctx,
                                   cache)
        if stacked_cache is not None:
            _write_back(stacked_cache, i, cache)
        return y

    @staticmethod
    def _one_layer(fn, layer_params, h, ctx, cache=None):
        """(y, the layer's updated cache or None) of one layer's params."""
        step_ctx = dict(ctx)
        step_ctx["cache_len"] = ctx.get("cache_len", 0)
        if step_ctx.get("shard") is not None and h.dim() == 3:
            h = step_ctx["shard"](h, "boundary")   # the saved residual
        if cache is not None:
            step_ctx["cache"] = cache
        y, step_ctx = fn(layer_params, h, step_ctx)
        return y, step_ctx.get("cache")

    def _full_ctx(self, positions, ctx_extra):
        """The context of a full-sequence pass at ``positions``, with
        ``ctx_extra`` over it."""
        ctx: Dict[str, Any] = {
            "positions": positions, "mode": "full",
            "compute_dtype": as_dtype(self.cfg.compute_dtype),
        }
        if ctx_extra:
            ctx.update(ctx_extra)
        return ctx

    def layer_fn(self, ctx_extra: Optional[Dict[str, Any]] = None):
        """``fn(one layer's params, h) -> h``: one layer of the stack as
        ``forward`` runs it in train mode (positions 0..L-1 of ``h``), the
        ``layer_fn`` that ``runtime.pipeline.pipeline_apply`` runs over a
        stage's layers.  ``ctx_extra`` as in ``forward`` (``use_flash``;
        a ``shard`` hint applies at each layer boundary, as in ``forward``,
        and its hint on the embedding is the caller's).  Only a stack of uniform self-contained layers pipelines: not the
        hybrid's (its shared block sits between groups) nor the
        encoder-decoder's (its layers read the encoder's memory)."""
        if self.block_kind not in ("attn", "ssm"):
            raise ValueError(f"{self.cfg.name}: a {self.block_kind} stack "
                             f"is not a stack of uniform layers")
        fn = self.block.fn()

        def one(layer_params, h):
            positions = torch.arange(h.shape[1], dtype=torch.int32,
                                     device=h.device)[None, :]
            return self._one_layer(fn, layer_params, h,
                                   self._full_ctx(positions, ctx_extra))[0]

        return one

    def _layer_remat(self, remat: bool, *args):
        """:meth:`_layer`, recomputed in the backward when ``remat``."""
        if remat:
            return checkpoint(self._layer, *args, use_reentrant=False)
        return self._layer(*args)

    def _run_blocks(self, params, x, ctx, cache, remat: bool = False):
        """The layer stack; ``cache`` (or None) is updated in place.  With
        ``remat`` each layer of the stack is recomputed in the backward
        (the hybrid's shared block is not, as in the reference)."""
        cfg = self.cfg
        fn = self.block.fn()
        lc = cache["layers"] if cache is not None else None
        if self.block_kind != "hybrid":
            for i in range(cfg.n_layers):
                x = self._layer_remat(remat, fn, params["layers"], i, x, ctx,
                                      lc)
            return x
        shared_fn = self.shared.fn()
        per = cfg.attn_every
        for g in range(cfg.n_layers // per):
            for i in range(g * per, (g + 1) * per):
                x = self._layer_remat(remat, fn, params["layers"], i, x, ctx,
                                      lc)
            sctx = dict(ctx)
            if cache is not None:
                sctx["cache"] = _index(cache["shared_attn"], g)
            x, sctx = shared_fn(params["shared_attn"], x, sctx)
            if cache is not None:
                _write_back(cache["shared_attn"], g, sctx["cache"])
        return x

    def _encode(self, params, prefix_embed, remat: bool = False):
        """The audio encoder over the stub's frames (B, S, D): positions
        0..S-1, non-causal, dense attention."""
        enc = prefix_embed.to(as_dtype(self.cfg.compute_dtype))
        ctx = {"positions": torch.arange(enc.shape[1],
                                         device=enc.device)[None, :],
               "mode": "full"}
        fn = self.enc_block.fn()
        for i in range(self.cfg.encoder_layers):
            enc = self._layer_remat(remat, fn, params["enc_layers"], i, enc,
                                    ctx)
        return enc

    def forward(self, params, tokens, *, prefix_embed=None, positions=None,
                mode: str = "train", cache_out: bool = False,
                max_len: int = 0,
                ctx_extra: Optional[Dict[str, Any]] = None):
        """Full-sequence forward (train / prefill): f32 logits (B, L, V),
        and with ``cache_out`` the cache filled for decode (under
        ``torch.no_grad``: the cache is written in place).  In
        ``mode="train"`` with ``cfg.remat`` each layer is recomputed in
        the backward.  ``prefix_embed`` (B, frontend_len, D) is the
        frontend stub's output: ``vlm`` puts it before the token
        embeddings (the cache then holds frontend_len + L positions, and
        the logits are the tokens' only); ``audio`` needs it, as the
        encoder's input."""
        if cache_out:
            with torch.no_grad():
                return self._forward(params, tokens, prefix_embed,
                                     positions, False, max_len, ctx_extra,
                                     cache_out=True)
        remat = (self.cfg.remat and mode == "train"
                 and torch.is_grad_enabled())
        return self._forward(params, tokens, prefix_embed, positions, remat,
                             max_len, ctx_extra)

    def _forward(self, params, tokens, prefix_embed, positions, remat,
                 max_len, ctx_extra, cache_out: bool = False):
        if self.block_kind == "encdec" and prefix_embed is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: "
                             f"forward needs prefix_embed, the encoder's "
                             f"(B, {self.cfg.frontend_len}, "
                             f"{self.cfg.d_model}) input frames")
        x = self._embed(params, tokens)
        vlm_prefix = self.cfg.family == "vlm" and prefix_embed is not None
        if vlm_prefix:
            x = torch.cat([prefix_embed.to(x.dtype), x], dim=1)
        B, Lseq, _ = x.shape
        if positions is None:
            positions = torch.arange(Lseq, dtype=torch.int32,
                                     device=x.device)[None, :]
        ctx = self._full_ctx(positions, ctx_extra)
        if ctx.get("shard") is not None:
            x = ctx["shard"](x, "bld")
        cache = None
        if cache_out:
            cache = self.init_cache(B, max_len or Lseq)
            ctx["cache_len"] = 0
        if self.block_kind == "encdec":
            ctx["memory"] = self._encode(params, prefix_embed, remat)
            if cache is not None:
                cache["memory"].copy_(ctx["memory"])
        y = self._run_blocks(params, x, ctx, cache, remat)
        logits = self._head(params, y)
        if vlm_prefix:
            logits = logits[:, prefix_embed.shape[1]:]
        if cache_out:
            return logits, cache
        return logits

    @torch.no_grad()
    def decode_step(self, params, tokens, cache, cache_len: int,
                    ctx_extra: Optional[Dict[str, Any]] = None):
        """One token per sequence (B, 1) against ``cache`` at position
        ``cache_len``: (f32 logits (B, 1, V), the cache updated in place).
        For ``vlm`` the prefix holds the cache's first frontend_len
        positions."""
        x = self._embed(params, tokens)
        positions = torch.full((x.shape[0], 1), int(cache_len),
                               dtype=torch.int32, device=x.device)
        ctx: Dict[str, Any] = {
            "positions": positions, "mode": "decode",
            "cache_len": int(cache_len),
            "compute_dtype": as_dtype(self.cfg.compute_dtype),
        }
        if ctx_extra:
            ctx.update(ctx_extra)
        if self.block_kind == "encdec":
            ctx["memory"] = cache["memory"]
        y = self._run_blocks(params, x, ctx, cache)
        return self._head(params, y), cache


# ---------------------------------------------------------------------------
# losses / counts
# ---------------------------------------------------------------------------

def token_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(summed negative log-likelihood over the valid (label >= 0)
    positions, their count) in f32; logits (B, L, V)."""
    valid = (labels >= 0).to(F32)
    lab = torch.clamp(labels, min=0)
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    ll = torch.gather(logp, -1, lab[..., None].long())[..., 0]
    return -torch.sum(ll * valid), torch.sum(valid)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid (label >= 0) positions; logits (B, L, V)."""
    nll, n = token_nll(logits, labels)
    return nll / torch.clamp(n, min=1.0)


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of ``cfg`` counted from shapes (nothing allocated);
    ``active_only`` counts top_k of n_experts expert weights."""
    total = 0
    for path, m in leaves_with_path(LMModel(cfg, "cpu").param_meta()):
        n = int(np.prod(m.shape))
        if (active_only and cfg.n_experts and "moe" in path
                and path[-1] in ("wg", "wu", "wd")):
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total
