"""Gradients over parameter trees: value and gradient by autograd,
clipping, microbatch accumulation, and BFP compression with error
feedback.

``error_feedback_compress`` applies the paper's C2 block quantizer to
gradients before they cross the interconnect; the residual (what the
quantizer dropped) is added back into the next step's gradient, so the
sequence of updates is unbiased even at 8-bit mantissas.  Paired with
``runtime.collectives.compressed_psum`` it moves about a quarter of an
f32 all-reduce's bytes.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core import bfp as bfp_lib
from repro_torch.core import tree as tree_lib

F32 = torch.float32


def value_and_grad(loss_fn: Callable, params, *args, has_aux: bool = False):
    """``loss_fn(params, *args)`` and its gradient with respect to every
    leaf of ``params``, as ``jax.value_and_grad`` gives them: a leaf the
    loss never reads gets zeros, not None.  With ``has_aux`` the loss
    function returns ``(loss, aux)`` and the value is ``(loss, aux)``.
    Values come back detached."""
    flat = tree_lib.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        out = loss_fn(tree_lib.unflatten(params, live), *args)
        loss = out[0] if has_aux else out
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    value = loss.detach()
    if has_aux:
        value = (value, tree_lib.tree_map(torch.Tensor.detach, out[1]))
    return value, tree_lib.unflatten(params, grads)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in tree_lib.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_lib.tree_map(lambda x: (x.to(F32) * scale).to(x.dtype),
                             tree), norm


class GradAccumulator:
    """Microbatch gradient accumulation: ``acc(loss_fn, params, batch)``
    splits every leaf of ``batch`` into ``n_micro`` slices along axis 0
    and returns the mean loss and the mean gradient."""

    def __init__(self, n_micro: int):
        if n_micro < 1:
            raise ValueError("n_micro must be >= 1")
        self.n_micro = n_micro

    def __call__(self, loss_fn, params, batch):
        n = self.n_micro
        if n == 1:
            return value_and_grad(loss_fn, params, batch)

        def split(x):
            b = x.shape[0]
            if b % n:
                raise ValueError(f"batch {b} % n_micro {n} != 0")
            return x.reshape(n, b // n, *x.shape[1:])

        micro = tree_lib.tree_map(split, batch)
        loss = None
        acc = tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
            params)
        for i in range(n):
            mb = tree_lib.tree_map(lambda x: x[i], micro)
            l, g = value_and_grad(loss_fn, params, mb)
            acc = tree_lib.tree_map(lambda a, b: a + b.to(F32), acc, g)
            loss = l if loss is None else loss + l
        inv = 1.0 / n
        return loss * inv, tree_lib.tree_map(lambda g: g * inv, acc)


def error_feedback_compress(grads, residual, *, mantissa_bits: int = 7,
                            block_size: int = 32) -> Tuple[Any, Any]:
    """``(compressed, new_residual)``: g' = Q(g + r), r' = (g + r) - g'."""
    comp, new_r = [], []
    for g, r in zip(tree_lib.leaves(grads), tree_lib.leaves(residual)):
        gf = g.to(F32) + r
        q = bfp_lib.roundtrip(gf, block_size=block_size,
                              mantissa_bits=mantissa_bits, axis=-1,
                              rounding="nearest")
        comp.append(q.to(g.dtype))
        new_r.append(gf - q)
    return (tree_lib.unflatten(grads, comp),
            tree_lib.unflatten(grads, new_r))


def init_residual(params):
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)
