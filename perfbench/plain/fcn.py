"""The reference forward pass of a PixelLink detector in its BFP datapath.

Plain PyTorch in f32 with TF32 off, one layer at a time, over a frozen
layer list (``plain/layers.py``).  It follows the datapath the
configuration states (paper §III.E, Fig. 4), not the program's code:

* weights: BN folded into the conv, then BFP along Cin;
* conv inputs: BFP along the channels, blocks of ``block_size`` with
  ``mantissa_bits`` each, truncated; the products and sums in f32 (the
  wide accumulator);
* every layer's output stored in ``storage`` (FP16) before the next
  reads it; the residual register holds the pre-storage f32 value;
* the learned upsample: a 3x3 conv over the zero-inserted plane, with
  BFP weights and the stored input;
* the head: a sigmoid of the stored logits, stored again.

:func:`make_params` draws the f32 weights that both the program and the
reference are given.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .bfp import (conv_same, fold_batchnorm, max_pool_same, roundtrip,
                  upsample2x_conv3x3)
from .layers import Layer, shapes

Params = Dict[str, Dict[str, torch.Tensor]]


def param_shapes(layers: List[Layer]) -> Dict[str, Dict[str, tuple]]:
    """Leaf shapes by layer: conv ``w`` (HWIO), ``b`` when biased and the
    BN statistics; the upsample's 3x3 ``w``."""
    shp = shapes(layers, (64, 64))
    out: Dict[str, Dict[str, tuple]] = {}
    for ly in layers:
        cin = sum(shp[n][2] for n in ly["inputs"])
        if ly["op"] == "conv":
            k, cout = ly["kernel"], ly["out_ch"]
            leaves = {"w": (k, k, cin, cout)}
            if ly["bias"]:
                leaves["b"] = (cout,)
            if ly["bn"]:
                leaves.update(gamma=(cout,), beta=(cout,), mean=(cout,),
                              var=(cout,))
            out[ly["name"]] = leaves
        elif ly["op"] == "upsample":
            out[ly["name"]] = {"w": (3, 3, cin, cin)}
    return out


def make_params(layers: List[Layer], seed: int, device) -> Params:
    """f32 weights from ``seed``, drawn on ``device`` in two calls:
    He-normal kernels; BN gamma 1 + 0.1 n, beta and mean 0.1 n, var
    1 + 0.25 |n|; biases 0.1 n."""
    spec = param_shapes(layers)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n_w = sum(_numel(s["w"]) for s in spec.values())
    n_v = sum(_numel(v) for s in spec.values() for k, v in s.items()
              if k != "w")
    wbuf = torch.randn(n_w, generator=g, device=device)
    vbuf = torch.randn(max(n_v, 1), generator=g, device=device)
    out: Params = {}
    iw = iv = 0
    for name, leaves in spec.items():
        p = {}
        for k, shape in leaves.items():
            n = _numel(shape)
            if k == "w":
                fan_in = shape[0] * shape[1] * shape[2]
                p[k] = (wbuf[iw:iw + n] * (2.0 / fan_in) ** 0.5).view(shape)
                iw += n
                continue
            v = vbuf[iv:iv + n].view(shape)
            iv += n
            if k == "gamma":
                p[k] = 1.0 + 0.1 * v
            elif k == "var":
                p[k] = 1.0 + 0.25 * v.abs()
            else:
                p[k] = 0.1 * v
        out[name] = p
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@torch.no_grad()
def forward(layers: List[Layer], params: Params, x: torch.Tensor, *,
            block_size: int, mantissa_bits: int, rounding: str = "trunc",
            storage=torch.float16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, 3) f32 images -> (logits, probabilities), each (N, H/4,
    W/4, 9) f32 as stored."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(layers, params, x, block_size, mantissa_bits,
                        rounding, storage)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _forward(layers, params, x, block_size, mantissa_bits, rounding,
             storage):
    def bfp(t, axis):
        return roundtrip(t, block_size=block_size,
                         mantissa_bits=mantissa_bits, axis=axis,
                         rounding=rounding)

    last_use = {}
    for i, ly in enumerate(layers):
        for n in ly["inputs"]:
            last_use[n] = i
    acts = {"input": x.to(torch.float32)}
    cache = None
    for i, ly in enumerate(layers):
        name, op = ly["name"], ly["op"]
        ins = [acts[n] for n in ly["inputs"]]
        xin = ins[0] if len(ins) == 1 else torch.cat(ins, dim=-1)
        if op == "conv":
            p = params[name]
            w, b = p["w"], p.get("b")
            if ly["bn"]:
                w, b = fold_batchnorm(w, b, p["gamma"], p["beta"],
                                      p["mean"], p["var"])
            y = conv_same(bfp(xin.float(), -1), bfp(w, -2), ly["stride"])
            if b is not None:
                y = y + b
        elif op == "pool":
            y = max_pool_same(xin.float(), ly["kernel"], ly["stride"])
        elif op == "upsample":
            y = upsample2x_conv3x3(xin.float(), bfp(params[name]["w"], -2))
        elif op == "sigmoid":
            y = torch.sigmoid(xin.float())
        elif op == "identity":
            y = xin
        else:
            raise ValueError(f"{name}: unknown op {op!r}")
        if ly["res"] == "cache":
            cache = y
        elif ly["res"] == "add":
            y = y + cache
        if ly["relu"]:
            y = torch.relu(y)
        acts[name] = y.to(storage)
        for n in ly["inputs"]:
            if last_use.get(n) == i and n != "head_logits":
                acts.pop(n, None)
    return acts["head_logits"].float(), acts["head_prob"].float()
