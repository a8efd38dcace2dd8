"""Optimizers as ``(init, update)`` pairs over parameter trees, the
reference's functional form (not ``torch.optim``): the state is a tree
the checkpoint writes leaf for leaf under the reference's keys.

AdamW with configurable **moment storage**:
    moment_dtype = "float32" | "bfloat16" | "bfp8"
"bfp8" stores the FIRST moment as 7-bit-mantissa shared-exponent blocks
(the paper's C2 block floating point applied to optimizer state) and the
second moment in bf16: nu's range inside a 32-value block exceeds what a
linear 7-bit mantissa holds, small values crush to 0 and 1/sqrt(0)
explodes the step, so the quantity whose reciprocal is taken is never
narrowed.  The update math is f32 whatever the storage.

Leaves that the loss never reads get zero gradients
(``grad_utils.value_and_grad``), so weight decay still applies to them,
as it does in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple, Union

import torch

from repro_torch.core import bfp as bfp_lib
from repro_torch.core import tree as tree_lib

from .schedules import constant

F32 = torch.float32
MOMENT_DTYPES = ("float32", "bfloat16", "bfp8")


class OptState(NamedTuple):
    step: torch.Tensor   # 0-dim int32
    mu: Any              # first moment (tree, storage representation)
    nu: Any              # second moment (tree, storage representation)
    extra: Any = None


def _is_bfp(x) -> bool:
    return isinstance(x, bfp_lib.BFPTensor)


def _store(x: torch.Tensor, dtype: str, *, second_moment: bool = False):
    if dtype == "float32":
        return x.to(F32)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if dtype == "bfp8":
        if second_moment:
            return x.to(torch.bfloat16)          # see module docstring
        # 7 mantissa bits + sign, one exponent per 32 values
        return bfp_lib.quantize(x, block_size=32, mantissa_bits=7, axis=-1,
                                rounding="nearest")
    raise ValueError(f"moment_dtype {dtype!r}; expected one of "
                     f"{MOMENT_DTYPES}")


def _load(x) -> torch.Tensor:
    if _is_bfp(x):
        return bfp_lib.dequantize(x)
    return x.to(F32)


def _step0(params) -> torch.Tensor:
    leaves = tree_lib.leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


LR = Union[Callable[[torch.Tensor], torch.Tensor], float]


def adamw(lr: LR, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, moment_dtype: str = "float32"):
    """Returns ``(init, update)``; ``update(grads, state, params) ->
    (params, state)``."""
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"moment_dtype {moment_dtype!r}; expected one of "
                         f"{MOMENT_DTYPES}")
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params) -> OptState:
        def zeros(p, second):
            return _store(torch.zeros(p.shape, dtype=F32, device=p.device),
                          moment_dtype, second_moment=second)

        return OptState(_step0(params),
                        tree_lib.tree_map(lambda p: zeros(p, False), params),
                        tree_lib.tree_map(lambda p: zeros(p, True), params))

    def update(grads, state: OptState, params) -> Tuple[Any, OptState]:
        step = state.step + 1
        t = step.to(F32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        lr_t = lr_fn(step)

        def upd(g, mu_s, nu_s, p):
            g = g.to(F32)
            mu = b1 * _load(mu_s) + (1 - b1) * g
            nu = b2 * _load(nu_s) + (1 - b2) * g * g
            mhat = mu / bc1
            nhat = torch.clamp(nu / bc2, min=0.0)   # quantized nu may dip
            delta = mhat / (torch.sqrt(nhat) + eps)
            delta = delta + weight_decay * p.to(F32)
            new_p = (p.to(F32) - lr_t * delta).to(p.dtype)
            return (new_p, _store(mu, moment_dtype),
                    _store(nu, moment_dtype, second_moment=True))

        outs = [upd(g, m, n, p) for g, m, n, p in zip(
            tree_lib.leaves(grads),
            tree_lib.leaves(state.mu, is_leaf=_is_bfp),
            tree_lib.leaves(state.nu, is_leaf=_is_bfp),
            tree_lib.leaves(params))]
        return (tree_lib.unflatten(grads, [o[0] for o in outs]),
                OptState(step,
                         tree_lib.unflatten(grads, [o[1] for o in outs]),
                         tree_lib.unflatten(grads, [o[2] for o in outs])))

    return init, update


def sgd_momentum(lr: LR, *, momentum: float = 0.9,
                 weight_decay: float = 0.0):
    lr_fn = lr if callable(lr) else constant(lr)

    def init(params) -> OptState:
        return OptState(_step0(params), tree_lib.tree_map(
            lambda p: torch.zeros(p.shape, dtype=F32, device=p.device),
            params), None)

    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)

        def upd(g, m, p):
            g = g.to(F32) + weight_decay * p.to(F32)
            m = momentum * m + g
            return (p.to(F32) - lr_t * m).to(p.dtype), m

        outs = [upd(g, m, p) for g, m, p in zip(
            tree_lib.leaves(grads), tree_lib.leaves(state.mu),
            tree_lib.leaves(params))]
        return (tree_lib.unflatten(grads, [o[0] for o in outs]),
                OptState(step,
                         tree_lib.unflatten(grads, [o[1] for o in outs]),
                         None))

    return init, update
