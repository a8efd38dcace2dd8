"""Mixture-of-Experts datapath module (grok-1 8e/top-2, kimi-k2 384e/top-8).

Capacity-bounded dispatch with sort-based ranking, as in the reference:
a stable argsort of the (token, slot) pairs' expert ids ranks each pair
within its expert in O(T*k) memory, where a one-hot cumsum would take
O(T*k*E).  Pairs ranked at or past the capacity go to one overflow cell
whose writes are thrown away.  Dispatch and combine are gathers; the
expert SwiGLU is three batched matmuls over (E, cap, .) buffers, so its
work scales with ``tokens * top_k * capacity_factor`` and not with the
number of experts, but every expert's weights are read, at decode too.

The router, softmax and top-k are f32; the expert products accumulate in
f32 (cuBLAS with an f32 result on bf16 operands on the card,
``layers.low_precision_matmul``; widened operands on the CPU) and the
combine sums over k in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F

from .layers import _maybe_bfp, low_precision_matmul
from .params import ParamMeta

F32 = torch.float32
WIDEN_BYTES = 1 << 30     # f32 copy of expert weights widened at a time


def moe_meta(d: int, f: int, n_experts: int, dtype,
             fission: int = 1) -> Dict[str, ParamMeta]:
    """``fission`` r > 1 splits every expert's FFN into r slices along
    d_ff, giving E*r virtual experts of width f/r (gate and up are
    elementwise per slice; the down-projection's partial sums add)."""
    E = n_experts * fission
    fs = f // fission
    if f % fission:
        raise ValueError(f"d_ff {f} is not a multiple of fission {fission}")
    return {
        "router": ParamMeta((d, n_experts), dtype, init="scaled"),
        "wg": ParamMeta((E, d, fs), dtype, init="scaled",
                        prefs=((0, "model"), (2, "model"), (1, "data"))),
        "wu": ParamMeta((E, d, fs), dtype, init="scaled",
                        prefs=((0, "model"), (2, "model"), (1, "data"))),
        "wd": ParamMeta((E, fs, d), dtype, init="scaled",
                        prefs=((0, "model"), (1, "model"), (2, "data"))),
    }


def _ranks_by_sort(expert_of: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each element within its expert (int32), by a stable sort:
    O(T*k)."""
    n = expert_of.shape[0]
    order = torch.argsort(expert_of, stable=True)
    counts = torch.bincount(expert_of, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts          # exclusive cumsum
    rank_sorted = (torch.arange(n, device=expert_of.device)
                   - starts[expert_of[order]])
    ranks = torch.empty(n, dtype=torch.int32, device=expert_of.device)
    ranks[order] = rank_sorted.to(torch.int32)
    return ranks


@dataclasses.dataclass
class Routing:
    """Where each (token, slot) pair of a routed block goes."""

    topv: torch.Tensor        # (T, k) f32 gate weights, renormalised
    topi: torch.Tensor        # (T, k) int64 expert ids (after fission)
    pos: torch.Tensor         # (T*k,) int32 rank within the expert
    keep: torch.Tensor        # (T*k,) bool: pos < cap
    n_experts: int            # E (after fission)
    cap: int                  # slots per expert


def router_gates(p, xt: torch.Tensor) -> torch.Tensor:
    """(T, D) tokens -> (T, E) f32 router logits."""
    return xt.to(F32) @ p["router"].to(F32)


def route(gates: torch.Tensor, table: Dict) -> Routing:
    """Softmax, top-k with renormalisation (1e-9 floor), expert fission
    and capacity ranks from f32 router logits (T, E)."""
    E = int(table["n_experts"])
    k = int(table["top_k"])
    cf = float(table.get("capacity_factor", 1.25))
    T = gates.shape[0]
    probs = torch.softmax(gates, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    r = int(table.get("fission", 1))
    if r > 1:                # expert fission: a slot per d_ff slice
        topi = (topi[..., None] * r
                + torch.arange(r, device=topi.device)).reshape(T, k * r)
        topv = topv.repeat_interleave(r, dim=-1)       # same gate weight
        k, E = k * r, E * r
    cap = max(int(T * k * cf) // E, 4)
    pos = _ranks_by_sort(topi.reshape(-1), E)
    return Routing(topv, topi, pos, pos < cap, E, cap)


def _expert_matmul(a: torch.Tensor, w: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) -> f32, the weights in the compute type
    ``dtype``.  bf16 operands on the card go to cuBLAS with an f32
    result; f32 operands run as they are (TF32 is off); otherwise (the
    CPU, or an f32 BFP input against bf16 weights) both widen, a few
    experts at a time, so no full-width expert tensor is copied to f32."""
    w = w.to(dtype)
    if a.dtype == w.dtype == F32:
        return torch.bmm(a, w)
    if a.is_cuda and a.dtype == w.dtype:
        return low_precision_matmul(a, w)
    step = max(1, WIDEN_BYTES // (w[0].numel() * 4))
    return torch.cat([torch.bmm(a[e:e + step].to(F32),
                                w[e:e + step].to(F32))
                      for e in range(0, a.shape[0], step)])


def moe(p, x, *, mc=None, table=None, ctx=None):
    """x: (B, L, D).  table: n_experts, top_k, capacity_factor, fission
    (and the BFP keys)."""
    table = table or {}
    B, L, D = x.shape
    T = B * L
    xt = x.reshape(T, D)
    r = route(router_gates(p, xt), table)
    E, cap, k = r.n_experts, r.cap, r.topi.shape[1]
    dev = x.device

    expert_of = r.topi.reshape(-1)
    tok_of = torch.arange(T, device=dev).repeat_interleave(k)
    slot = torch.where(r.keep, expert_of * cap + r.pos, E * cap)  # overflow

    # dispatch: gather tokens into (E, cap, D) expert buffers
    buf_tok = torch.zeros(E * cap + 1, dtype=torch.int64, device=dev)
    buf_tok[slot] = tok_of
    buf_valid = torch.zeros(E * cap + 1, dtype=torch.bool, device=dev)
    buf_valid[slot] = r.keep
    xe = (xt[buf_tok[:E * cap]]
          * buf_valid[:E * cap, None].to(x.dtype)).reshape(E, cap, D)
    if ctx and ctx.get("shard") is not None:
        xe = ctx["shard"](xe, "ecd")      # experts over "model"

    # expert FFN (SwiGLU), batched over experts
    xq = _maybe_bfp(xe, table)
    g = _expert_matmul(xq, p["wg"], x.dtype)
    u = _expert_matmul(xq, p["wu"], x.dtype)
    h = (F.silu(g) * u).to(x.dtype)
    del g, u
    ye = _expert_matmul(_maybe_bfp(h, table), p["wd"], x.dtype)

    # combine: each (token, slot) reads back its expert/cap cell
    back = ye.reshape(E * cap, D)[torch.clamp(slot, max=E * cap - 1)]
    back = back * r.keep[:, None].to(back.dtype)
    back = back.reshape(T, k, D) * r.topv[..., None]
    return back.sum(1).reshape(B, L, D).to(x.dtype)


def aux_load_loss(p, x, *, table=None) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (importance * load)."""
    table = table or {}
    E = int(table["n_experts"])
    k = int(table["top_k"])
    B, L, D = x.shape
    gates = torch.softmax(router_gates(p, x.reshape(B * L, D)), dim=-1)
    topi = torch.topk(gates, k, dim=-1).indices
    load = F.one_hot(topi, E).to(F32).sum(1).mean(0)
    importance = gates.mean(0)
    return torch.sum(load * importance) * E
