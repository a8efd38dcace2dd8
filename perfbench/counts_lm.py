"""Operations, bytes and peaks of an LM prefill: the arithmetic behind the
prefill cell's rooflines, MFU and per-layer times.

Counted from the configuration's widths, ``m``: its plain description
(``configs/<config>.py``'s ``layers``, the dict of ``plain/zamba2.dims``),
never from how the program computes:

* a prefill's FLOPs (:func:`prefill_flops`), B prompts of L tokens: 2 x
  the multiply-adds of every matrix product of the forward at every
  position (the head too: ``serve_lm.prefill`` returns every position's
  logits), the Mamba2 layers' (:func:`mamba_flops`: the projections, the
  depthwise conv and the SSD scan at the configuration's chunk, the
  quadratic form within a chunk over its triangle, the chunk-end states,
  the inherited outputs) and the shared sites' (:func:`shared_flops`: the
  block once per site, attention's Q K^T and P V over the causal
  triangle, the adapters and the site linears); norms and elementwise
  work are not counted;
* K4 (:func:`k4_work`, one site's attention): the causal Q K^T and P V,
  2 x 2 x B x H x hd x L (L + 1) / 2 FLOPs against the bf16 peak, and
  q, k, v and o read or written once at 2 bytes;
* K5 (:func:`k5_work`, one Mamba2 layer's intra-chunk block): at the
  kernel's tile of ``K5_TILE`` rows (the program runs the published
  chunk of 256 as two), per tile C B^T per group over the triangle, per
  head (C B^T o decay) xdt over the triangle and the chunk-end state
  xdt^T (B w); K5 takes f32 operands in three TF32 products each, so
  3 x its FLOPs against the TF32 peak; c, b, xdt and the cumulative
  decay in, y and the state out, once each at 4 bytes.

A bound is max(bytes / HBM bandwidth, FLOPs / peak).  Peaks: NVIDIA's
H100 SXM data sheet, dense, at 700 W (as ``counts.py``).
"""
from __future__ import annotations

from typing import Dict

from perfbench.counts import PEAK_BYTES, PEAK_FLOPS

PEAK_TF32 = 495e12           # TF32 dense tensor, FLOP/s
K5_TILE = 128                # rows of the kernel's chunk


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def k4_work(m, batch: int, length: int) -> Dict[str, float]:
    flops = 4 * batch * m["heads"] * m["hd"] * _tri(length)
    nbytes = 2 * batch * length * m["hd"] * (2 * m["heads"]
                                             + 2 * m["kv_heads"])
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)}


def k5_work(m, batch: int, length: int) -> Dict[str, float]:
    g, n, h, p = m["g"], m["n"], m["ssm_heads"], m["p"]
    t = min(K5_TILE, length)
    tiles = batch * (length // t)
    flops = tiles * 2 * (g * _tri(t) * n + h * _tri(t) * p + h * t * p * n)
    nbytes = tiles * 4 * (2 * g * t * n + 2 * h * t * p + h * t
                          + h * p * n)
    return {"flops": flops, "bytes": nbytes,
            "bound_s": max(3 * flops / PEAK_TF32, nbytes / PEAK_BYTES)}


def mamba_flops(m, batch: int, length: int) -> float:
    """Every Mamba2 layer of one prefill."""
    per_token = (m["d"] * m["d_proj"] + m["d_inner"] * m["d"]
                 + m["w"] * m["d_conv"])
    g, n, h, p = m["g"], m["n"], m["ssm_heads"], m["p"]
    ssd = 0
    for c0 in range(0, length, m["chunk"]):
        t = min(m["chunk"], length - c0)
        ssd += 2 * (g * _tri(t) * n + h * _tri(t) * p + 2 * h * t * p * n)
    return m["layers"] * (2.0 * batch * length * per_token + batch * ssd)


def shared_flops(m, batch: int, length: int) -> float:
    """Every shared site of one prefill: the block over [h; e], the
    site's adapter and its linear."""
    d, f, r = m["d"], m["f"], m["rank"]
    hh = m["heads"] * m["hd"]
    kv = m["kv_heads"] * m["hd"]
    site = (m["d_attn"] * (hh + 2 * kv) + hh * d + 3 * d * f
            + r * (d + 2 * f) + d * d)
    return m["sites"] * (2.0 * batch * length * site
                         + k4_work(m, batch, length)["flops"])


def prefill_flops(m, batch: int, length: int) -> float:
    return (mamba_flops(m, batch, length) + shared_flops(m, batch, length)
            + 2.0 * batch * length * m["d"] * m["vocab"])
