"""Mixture-of-Experts parameter layout (grok-1 8e/top-2, kimi-k2 384e/top-8).

Only the metadata is ported, so that every configuration can be counted
and laid out; the routed block itself raises until ROADMAP Queue 1 item
16b ports it.
"""
from __future__ import annotations

from typing import Dict

from .params import ParamMeta


def moe_meta(d: int, f: int, n_experts: int, dtype,
             fission: int = 1) -> Dict[str, ParamMeta]:
    """``fission`` r > 1 splits every expert's FFN into r slices along
    d_ff, giving E*r virtual experts of width f/r."""
    E = n_experts * fission
    fs = f // fission
    if f % fission:
        raise ValueError(f"d_ff {f} is not a multiple of fission {fission}")
    return {
        "router": ParamMeta((d, n_experts), dtype, init="scaled"),
        "wg": ParamMeta((E, d, fs), dtype, init="scaled"),
        "wu": ParamMeta((E, d, fs), dtype, init="scaled"),
        "wd": ParamMeta((E, fs, d), dtype, init="scaled"),
    }
